"""Mean number of queued requests (engine.core.pending()) sampled before
each tick that ended inside the window's first ``profile_after`` share
(the traced slice comes after it)."""


def read(run):
    ticks = run.records.get("ticks", [])
    return sum(t["pending"] for t in ticks) / len(ticks) if ticks else None
