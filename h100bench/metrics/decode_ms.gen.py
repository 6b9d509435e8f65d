"""Device milliseconds of the profiled call's VAE decode: the union of the
intervals of the kernels launched inside the program's ``generate.decode``
span (lib/spans.py)."""
from h100bench.lib import spans


def read(run):
    return spans.run_launched_ms(run, "generate.decode")
