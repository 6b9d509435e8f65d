"""Share of the profiled slice's wall time in which the device was idle
inside the program's ``engine.slot_step`` spans (the gaps whose midpoints
lie inside one, on the profiler's clock), in percent (lib/spans.py)."""
from h100bench.lib import spans


def read(run):
    return spans.run_idle_share(run, "engine.slot_step")
