"""Device milliseconds of the profiled call's text encode: the union of the
intervals of the kernels whose launching CUDA call started inside the
program's ``generate.encode`` span (lib/spans.py)."""
from h100bench.lib import spans


def read(run):
    return spans.run_launched_ms(run, "generate.encode")
