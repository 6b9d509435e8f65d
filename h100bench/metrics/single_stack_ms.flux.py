"""Device milliseconds a step of FLUX's 38 single-stream blocks: the union
of the intervals of the kernels launched inside the program's
``flux.single`` spans in the profiled call, over the traffic's ``steps``
(lib/spans.py)."""
from h100bench.lib import spans


def read(run):
    ms = spans.run_launched_ms(run, "flux.single")
    return None if ms is None else ms / run.traffic["steps"]
