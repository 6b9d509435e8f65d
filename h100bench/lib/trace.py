"""A profiled slice of a run, read from torch.profiler's raw kineto events.

``Slice`` arms ``torch.profiler`` over a short steady part of the
measured window, with a device synchronize before it starts and after it
ends, so that the slice holds exactly the device work that was issued
inside it. It records the CUDA activity alone (kernels, copies, and the
host's CUDA runtime calls): recording every host op as well slowed the
serving engine's host-bound tick twofold under the profiler and stalled
the window for seconds when the profiler stopped. ``summary`` reads the
raw kineto events, as ``chip_smoke.profile()`` does, without building
``prof.events()``:

- ``window_s``: the host clock from the start to the end of the slice;
- ``busy_s``: the union of the device events' intervals (kernels, copies
  and fills; not the host's ``record_function`` ranges that the profiler
  mirrors on the device's timeline), so that work overlapping on several
  streams counts once;
- ``launches``: the device kernels (copies and fills left out);
- ``kernel_s`` by name, for the roofline readers and the breakdown;
- the breakdown: the ten device operations with the most time, and the
  idle gaps between device work summed by the innermost host event
  running at each gap's middle (a CUDA runtime call, a ``bench:`` range
  where the profiler mirrors it, or "host between CUDA calls").
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


def union_us(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, gaps between covered stretches) of [start, end)
    intervals; from the port's utils/profiling._kernel_busy_us."""
    busy, end, gaps = 0.0, None, []
    for start, stop in sorted(intervals):
        if end is not None and stop <= end:
            continue
        if end is not None and start > end:
            gaps.append((end, start))
        busy += stop - (start if end is None else max(start, end))
        end = stop
    return busy, gaps


def _innermost(cpu: List[Tuple[int, int, str]], starts: List[int], t: float) -> str:
    """The shortest host event that covers time t (from the 256 that
    started last before it)."""
    best, best_len = "host between CUDA calls", None
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 257), -1):
        s, e, name = cpu[j]
        if e >= t and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


def _annotation(e) -> bool:
    """A host range (``record_function``) mirrored on the device's
    timeline, which is no device work."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or e.name().startswith("bench:")


def _top(seconds: Dict[str, float]) -> List:
    """The ten names with the most seconds, longest first, names cut to
    96 characters."""
    top = sorted(seconds.items(), key=lambda kv: -kv[1])[:10]
    return [[k if len(k) <= 96 else k[:93] + "...", v] for k, v in top]


class Slice:
    """counters: a function giving the program's call counters, read at
    both ends of the slice; ``counts`` holds their growth."""

    def __init__(self, counters=None):
        self.prof = None
        self.t0 = self.t1 = None
        self.counters, self.counts = counters, {}

    def start(self) -> None:
        if self.counters is not None:
            self.counts = {k: -v for k, v in self.counters().items()}
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        if self.counters is not None:
            self.counts = {k: v + self.counts[k] for k, v in self.counters().items()}

    def summary(self) -> Dict:
        cuda = torch.autograd.DeviceType.CUDA
        dev, cpu = [], []
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns()
            row = (s, s + e.duration_ns(), e.name())
            if e.device_type() != cuda:
                cpu.append(row)
            elif not _annotation(e):
                dev.append(row)
        busy_ns, gaps = union_us([(s, e) for s, e, _ in dev])
        by_name: Dict[str, float] = defaultdict(float)
        launches = 0
        for s, e, name in dev:
            by_name[name] += (e - s) / 1e9
            if not name.startswith(("Memcpy", "Memset")):
                launches += 1
        cpu.sort()
        starts = [s for s, _, _ in cpu]
        idle: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            idle[_innermost(cpu, starts, (a + b) / 2)] += (b - a) / 1e9
        return {"window_s": self.t1 - self.t0, "busy_s": busy_ns / 1e9, "launches": launches,
                "kernel_s": dict(by_name),
                "breakdown": {"device_ops": _top(by_name), "idle_gaps": _top(idle)}}


def warm_profiler() -> None:
    """Start the profiler once on a trivial op, so that a slice inside the
    window does not pay its first start (CUPTI set-up)."""
    s = Slice()
    s.start()
    torch.ones(8, device="cuda").sum()
    s.stop()
    s.summary()
