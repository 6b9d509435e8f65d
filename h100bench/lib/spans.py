"""The program's spans read against a profiled slice.

The port records named host spans (``tinyfusers_tpu_torch.utils.profiling``:
``engine.tick`` and its parts, ``request.queued``, ``generate.encode``, ...)
while its tracing is on, on ``time.perf_counter_ns()``; ``drain()`` hands
them out with the Clock that maps them onto the profiler's clock (the
Unix-epoch nanoseconds of kineto's events, CUDA runtime and driver calls
included). This module reads them:

- against the kineto events of a ``lib.trace.Slice``: a kernel belongs to
  a span when the CUDA runtime or driver call that launched it (joined by
  the correlation id) started inside the span; an idle gap of the device
  belongs to the innermost span at its midpoint;
- alone: a request's wait for a slot is its ``request.queued`` span.

The functions at the bottom read a traced Run (``metrics/<name>.py`` calls
them): ``run.records["spans"]`` and ``run.records["clock"]``, what
``profiling.drain()`` handed out after tracing was turned on at the
window's start (so the Clock's first pair is the window's start), and
``run.records["slice"]``, the Slice the driver kept. A run without them
reads None. Below them every reader takes plain lists, so that it can be
checked on synthetic events: ``device`` and ``calls`` rows are (start ns,
end ns, name, correlation id) on the profiler's clock, ``spans`` rows are
the program's Span records, mapped by ``mapped()`` into (start ns, end ns,
Span).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from h100bench.lib.trace import union_us

Row = Tuple[int, int, str, int]
NONE = "none"   # an idle gap outside every span


def events(sl) -> Tuple[List[Row], List[Row]]:
    """(device operations, CUDA runtime and driver calls) of a stopped
    Slice, each sorted by start: kernels, copies and fills; the host's calls
    that issued them and the rest (synchronizes, event queries)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, calls = [], []
    for e in sl.prof.profiler.kineto_results.events():
        s = e.start_ns()
        row = (s, s + e.duration_ns(), e.name(), e.correlation_id())
        if e.device_type() == cuda:
            if not (e.is_user_annotation() or e.name().startswith("bench:")):
                device.append(row)
        elif e.name().startswith("cu"):  # not CUPTI's own rows ("Activity Buffer Request")
            calls.append(row)
    return sorted(device), sorted(calls)


def mapped(spans: Iterable, clock) -> List[Tuple[float, float, object]]:
    """The program's spans on the profiler's clock, the request spans left
    out (they wait across calls and nest in nothing), sorted by start."""
    from tinyfusers_tpu_torch.utils.profiling import profiler_ns

    return sorted(((profiler_ns(s.start_ns, clock), profiler_ns(s.end_ns, clock), s)
                   for s in spans if s.request_id is None), key=lambda r: r[0])


def overlapping(mspans: Sequence, lo: float, hi: float) -> List:
    """The mapped spans that overlap [lo, hi]."""
    return [m for m in mspans if m[1] >= lo and m[0] <= hi]


def window(sl, clock) -> Tuple[float, float]:
    """The Slice's host-clock ends (time.perf_counter() seconds) on the
    profiler's clock."""
    from tinyfusers_tpu_torch.utils.profiling import profiler_ns

    return profiler_ns(sl.t0 * 1e9, clock), profiler_ns(sl.t1 * 1e9, clock)


def innermost(mspans: Sequence, t: float) -> Optional[object]:
    """The shortest span that covers time t (spans on one thread nest)."""
    best = None
    for a, b, s in mspans[:bisect.bisect_right([m[0] for m in mspans], t)]:
        if b >= t and (best is None or b - a < best[1] - best[0]):
            best = (a, b, s)
    return None if best is None else best[2]


def idle_gaps(device: Sequence[Row], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] in which no device operation ran: the gaps
    between the union of the operations' intervals, and the head before
    the first and the tail after the last."""
    spans = [(max(s, lo), min(e, hi)) for s, e, _, _ in device if e > lo and s < hi]
    if not spans:
        return [(lo, hi)]
    _, gaps = union_us(spans)
    head, tail = min(s for s, _ in spans), max(e for _, e in spans)
    return ([(lo, head)] if head > lo else []) + gaps + ([(tail, hi)] if hi > tail else [])


def idle_by_span(device: Sequence[Row], mspans: Sequence, lo: float, hi: float
                 ) -> Dict[str, float]:
    """Seconds of the device's idle time in [lo, hi] by the innermost span
    at each gap's midpoint (NONE outside every span); they sum to the
    idle time."""
    out: Dict[str, float] = defaultdict(float)
    for a, b in idle_gaps(device, lo, hi):
        s = innermost(mspans, (a + b) / 2)
        out[NONE if s is None else s.name] += (b - a) / 1e9
    return dict(out)


def idle_inside(device: Sequence[Row], mspans: Sequence, name: str, lo: float, hi: float
                ) -> float:
    """Seconds of the device's idle time in [lo, hi] whose gaps' midpoints
    lie inside a span named ``name``."""
    inside = [(a, b) for a, b, s in mspans if s.name == name]
    return sum((b - a) / 1e9 for a, b in idle_gaps(device, lo, hi)
               if any(x <= (a + b) / 2 <= y for x, y in inside))


def launched_in(device: Sequence[Row], calls: Sequence[Row], mspans: Sequence,
                names: Iterable[str]) -> List[Row]:
    """The device operations whose launching call (same correlation id)
    started inside a span named in ``names``."""
    names = set(names)
    inside = sorted((a, b) for a, b, s in mspans if s.name in names)
    starts = [a for a, _ in inside]
    start_of = {c[3]: c[0] for c in calls}

    def within(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and inside[i][1] >= t  # spans of one name do not overlap

    return [d for d in device if d[3] in start_of and within(start_of[d[3]])]


def busy_s(rows: Sequence[Row]) -> float:
    """Seconds covered by the union of the rows' intervals."""
    return union_us([(s, e) for s, e, _, _ in rows])[0] / 1e9


def unattributed(device: Sequence[Row], calls: Sequence[Row], mspans: Sequence,
                 names: Iterable[str]) -> Dict[str, float]:
    """Seconds of the device operations launched inside none of the spans
    named, by operation name."""
    kept = {id(d) for d in launched_in(device, calls, mspans, names)}
    out: Dict[str, float] = defaultdict(float)
    for d in device:
        if id(d) not in kept:
            out[d[2]] += (d[1] - d[0]) / 1e9
    return dict(out)


def queue_wait_p90_s(spans: Iterable, lo_ns: float, hi_ns: float) -> Tuple[Optional[float], int]:
    """(p90 of the ``request.queued`` spans, in seconds, of the requests
    submitted in [lo_ns, hi_ns] of time.perf_counter_ns(); their count);
    None without one."""
    waits = [(s.end_ns - s.start_ns) / 1e9 for s in spans
             if s.name == "request.queued" and lo_ns <= s.start_ns <= hi_ns]
    return (float(np.percentile(waits, 90)) if waits else None), len(waits)


def launch_check(calls: Sequence[Row], mspans: Sequence, name: str) -> Dict:
    """How well the mapping puts the host's CUDA calls inside the program's
    spans. For each span named ``name``: whether the first kernel launch
    after its start lies inside it, and the margin between each end and
    the nearest call inside. Over every span: the calls that straddle a
    span's end, which no true clock allows (a span and a call of one
    thread nest or are apart), and the deepest straddle, the mapping's
    largest error that the calls can show."""
    launches = [c for c in calls if c[2].startswith(("cudaLaunch", "cuLaunch"))]
    l_starts, c_starts = [c[0] for c in launches], [c[0] for c in calls]
    first_inside, margins, straddles = [], [], []
    for a, b, s in mspans:
        for e in (a, b):  # calls of one thread do not overlap: only the last one before e can
            i = bisect.bisect_left(c_starts, e) - 1
            if i >= 0 and calls[i][1] > e:
                straddles.append(min(e - calls[i][0], calls[i][1] - e))
        if s.name != name:
            continue
        i = bisect.bisect_left(l_starts, a)
        first_inside.append(i < len(launches) and launches[i][1] <= b)
        inside = calls[bisect.bisect_left(c_starts, a):bisect.bisect_right(c_starts, b)]
        inside = [c for c in inside if c[1] <= b]
        if inside:
            margins.append(min(inside[0][0] - a, b - max(c[1] for c in inside)))
    return {"spans": len(first_inside), "first_launch_inside": sum(first_inside),
            "least_margin_ns": min(margins) if margins else None,
            "straddling_calls": len(straddles),
            "deepest_straddle_ns": max(straddles) if straddles else 0.0}


# -- a traced Run --------------------------------------------------------------

GENERATE = ("generate.encode", "generate.denoise", "generate.decode")


def on_slice(run):
    """(device rows, call rows, the mapped spans that overlap the slice,
    its ends on the profiler's clock) of a traced Run; None without spans
    or a slice."""
    spans_, clock, sl = (run.records.get(k) for k in ("spans", "clock", "slice"))
    if not spans_ or clock is None or sl is None:
        return None
    device, calls = events(sl)
    lo, hi = window(sl, clock)
    return device, calls, overlapping(mapped(spans_, clock), lo, hi), lo, hi


def run_queue_wait(run) -> Tuple[Optional[float], int]:
    """queue_wait_p90_s() over the requests submitted in the window's first
    ``profile_after`` share (the host metrics' rule); (None, 0) without
    ``request.queued`` spans (a run of no engine)."""
    clock = run.records.get("clock")
    queued = [s for s in run.records.get("spans") or () if s.name == "request.queued"]
    if not queued or clock is None:
        return None, 0
    hi = clock.perf0 + run.traffic["profile_after"] * run.seconds * 1e9
    return queue_wait_p90_s(queued, clock.perf0, hi)


def run_idle_share(run, name: str) -> Optional[float]:
    """The slice's device-idle time whose gaps' midpoints lie inside a span
    named ``name``, over the slice's wall time, in percent; None where no
    such span overlaps the slice."""
    got = on_slice(run)
    if got is None or not any(s.name == name for _, _, s in got[2]):
        return None
    device, _, ms, lo, hi = got
    return 100.0 * idle_inside(device, ms, name, lo, hi) / ((hi - lo) / 1e9)


def run_launched_ms(run, name: str) -> Optional[float]:
    """Milliseconds of the union of the device intervals of the kernels
    launched inside a span named ``name`` in the slice; None where no such
    span overlaps the slice."""
    got = on_slice(run)
    if got is None or not any(s.name == name for _, _, s in got[2]):
        return None
    device, calls, ms, _, _ = got
    return 1e3 * busy_s(launched_in(device, calls, ms, [name]))


def breakdown(run) -> Dict:
    """What a traced run logs beside its metrics: the requests behind the
    queue wait, the slice's idle time by the innermost span at each gap's
    midpoint ("none" outside every span) and its sum, the mapping's check
    (``launch_check`` on ``engine.slot_step`` or ``generate.denoise``),
    and in a generate run the share of the slice's busy time that the
    ``generate.*`` spans account for with what is left by operation name."""
    out = {"recorded": len(run.records.get("spans") or [])}
    serve = run.traffic["driver"] == "engine_open_loop"
    if serve:
        out["queue_wait_requests"] = run_queue_wait(run)[1]
    got = on_slice(run)
    if got is None:
        return out
    device, calls, ms, lo, hi = got
    idle = idle_by_span(device, ms, lo, hi)
    out["slice_wall_s"], out["slice_busy_s"] = (hi - lo) / 1e9, busy_s(device)
    out["idle_by_span_s"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
    out["idle_s"] = sum(idle.values())
    out["mapping"] = launch_check(calls, ms, "engine.slot_step" if serve else "generate.denoise")
    if not serve:
        out["generate_busy_share"] = busy_s(launched_in(device, calls, ms, GENERATE)) / max(
            out["slice_busy_s"], 1e-12)
        rest = unattributed(device, calls, ms, GENERATE)
        out["outside_generate_s"] = dict(sorted(rest.items(), key=lambda kv: -kv[1])[:8])
    return out
