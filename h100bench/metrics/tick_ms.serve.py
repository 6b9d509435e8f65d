"""Mean host time of an engine tick (Engine.step()) in ms, over the
ticks that ran the UNet and ended inside the window's first
``profile_after`` share (the traced slice comes after it)."""


def read(run):
    ticks = [t["s"] for t in run.records.get("ticks", []) if t["active"]]
    return 1e3 * sum(ticks) / len(ticks) if ticks else None
