"""Share of the profiled slice's wall time in which no device operation
ran, in percent: 1 - (the union of the device events' intervals) / (the
slice's host-clock length)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
