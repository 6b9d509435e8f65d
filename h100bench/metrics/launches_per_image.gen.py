"""Device kernels in the profiled generate call over its images."""


def read(run):
    if run.trace is None or not run.trace.get("images"):
        return None
    return run.trace["launches"] / run.trace["images"]
