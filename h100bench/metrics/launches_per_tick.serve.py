"""Device kernels in the profiled slice over its ticks."""


def read(run):
    if run.trace is None or not run.trace.get("ticks"):
        return None
    return run.trace["launches"] / run.trace["ticks"]
