"""Model FLOP utilisation of the images finished in the window, in
percent: their analytic FLOPs (both text towers on the prompt and the
negative prompt, every MMDiT call of the guided batch, the decode) over
their calls' host time, over the card's bf16 peak; the profiled call
left out."""
from h100bench.lib import roofline


def read(run):
    calls = run.records.get("calls", [])
    return roofline.mfu(sum(c["flops"] for c in calls), sum(c["s"] for c in calls), run.peak)
