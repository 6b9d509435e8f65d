"""Model FLOP utilisation of the engine's ticks, in percent: the analytic
FLOPs of the useful work (a UNet pass on the two CFG rows of every active
slot, and each decode issued) over the ticks' summed host time, over the
card's bf16 peak; the ticks that ended inside the window's first
``profile_after`` share (the traced slice comes after it)."""
from h100bench.lib import roofline


def read(run):
    ticks = [t for t in run.records.get("ticks", []) if t["active"]]
    flops = sum(t["active"] * run.records["denoise_flops"]
                + t["decodes"] * run.records["decode_flops"] for t in ticks)
    return roofline.mfu(flops, sum(t["s"] for t in ticks), run.peak)
