"""The attn kernels' share of their roofline in the profiled slice, in
percent (lib/roofline.py)."""
from h100bench.lib import roofline


def read(run):
    return roofline.share(run, "attn")
