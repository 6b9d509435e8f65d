"""Device milliseconds of one denoising step of the profiled call: the union
of the intervals of the kernels launched inside the program's
``generate.denoise`` span, over the traffic's ``steps`` (lib/spans.py)."""
from h100bench.lib import spans


def read(run):
    ms = spans.run_launched_ms(run, "generate.denoise")
    return None if ms is None else ms / run.traffic["steps"]
