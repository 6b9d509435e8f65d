"""p90 of the program's ``request.queued`` spans (a request's submit to its
admission to a slot), in seconds, over the requests submitted in the
window's first ``profile_after`` share; read from the spans the program
recorded with its tracing on over the window (lib/spans.py)."""
from h100bench.lib import spans


def read(run):
    return spans.run_queue_wait(run)[0]
