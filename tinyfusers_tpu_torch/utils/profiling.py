"""Profiling and observability (port of tinyfusers_tpu/utils/profiling.py).

- hard_sync / Timer: wall clock around work that ends in a device
  synchronize.
- span() / begin() / end() / forget(): named host spans in the program,
  recorded while tracing() is on and handed out by drain(), with the
  clock that puts them on torch.profiler's timeline (profiler_ns()).
- trace(): ``torch.profiler`` over a block, with the spans recorded over
  it, written as a Chrome trace under ``logdir``; device_time_from_trace()
  reads the device's busy time back from it.
- device_memory_stats(): the caching allocator's held and peak bytes.
- StepMetrics: rolling latency / throughput for serving loops.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import itertools
import json
import os
import statistics
import tempfile
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, torch.nn.Module):
        yield from x.parameters()
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def hard_sync(x) -> None:
    """Wait for the devices of every CUDA tensor in x (a tensor, a module,
    or nested dicts / lists / tuples of them)."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """with Timer("unet step", sync_on=out) as t: ... ; t.seconds"""

    def __init__(self, name: str = "", sync_on=None, quiet: bool = False):
        self.name = name
        self._sync_on = sync_on
        self.quiet = quiet
        self.seconds: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync_on is not None:
            hard_sync(self._sync_on)
        self.seconds = time.perf_counter() - self._t0
        if not self.quiet and self.name:
            print(f"[timer] {self.name}: {self.seconds*1e3:.2f} ms")
        return False


# -- spans ------------------------------------------------------------------
#
# A span is a stretch of host time in which the program did one named piece
# of work: an engine tick and its parts, a request's wait, a generate call's
# encode. Off (the default), span() is one check of ``_on`` that returns the
# shared NO_SPAN: no allocation and no clock read. A span never touches the
# device; its times are the host's time.perf_counter_ns().


class Span(NamedTuple):
    name: str
    start_ns: int               # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: Optional[int]       # the innermost span open on the thread at the start
    request_id: Optional[int]   # a request span's (begin / end); its parent is None


class Clock(NamedTuple):
    """(perf_counter_ns, time_ns) read together when recording began (or
    was last drained) and when drained: profiler_ns() maps span times
    through them onto the Unix-epoch nanoseconds of torch.profiler's
    (kineto's) events."""
    perf0: int
    unix0: int
    perf1: int
    unix1: int


_on = False
_records: List[Span] = []
_open: Dict[Tuple[str, int, int], Tuple[int, int]] = {}  # (name, id(scope), request id) -> (start, id)
_ids = itertools.count(1)
_thread = threading.local()
_since: Optional[Tuple[int, int]] = None             # the Clock's first pair


def _stack() -> List[int]:
    stack = getattr(_thread, "stack", None)
    if stack is None:
        stack = _thread.stack = []
    return stack


def _clock_pair() -> Tuple[int, int]:
    a = time.perf_counter_ns()
    unix = time.time_ns()
    return (a + time.perf_counter_ns()) // 2, unix


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "start", "id", "parent")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        _records.append(Span(self.name, self.start, end, self.id, self.parent, None))
        return False


def span(name: str):
    """``with span("engine.tick"): ...`` records the block as a Span while
    tracing() is on; off, it returns the shared NO_SPAN."""
    if not _on:
        return NO_SPAN
    return _OpenSpan(name)


def begin(name: str, request_id: int, scope: object) -> None:
    """Open a request's span now; end() with the same name, id and scope
    (the object that numbers the requests: an Engine) closes it, from
    anywhere later (a request waits and runs across calls). Off, and for an
    end() whose begin() was not recorded, nothing happens."""
    if not _on:
        return
    _open[(name, id(scope), request_id)] = (time.perf_counter_ns(), next(_ids))


def end(name: str, request_id: int, scope: object) -> None:
    if not _on:
        return
    opened = _open.pop((name, id(scope), request_id), None)
    if opened is not None:
        _records.append(Span(name, opened[0], time.perf_counter_ns(), opened[1], None,
                             request_id))


def forget(scope: object) -> None:
    """Drop the request spans that ``scope`` left open (an Engine that
    dropped its requests)."""
    for key in [k for k in _open if k[1] == id(scope)]:
        del _open[key]


@contextlib.contextmanager
def tracing():
    """Record spans over the block (nested, the outermost turns recording
    off); the records stay until drain()."""
    global _on, _since
    if _on:
        yield
        return
    if _since is None:
        _since = _clock_pair()
    _on = True
    try:
        yield
    finally:
        _on = False
        _open.clear()


def drain() -> Tuple[List[Span], Optional[Clock]]:
    """The spans recorded since the last drain, in the order they closed,
    and their Clock (None when nothing was ever recorded); request spans
    still open stay open."""
    global _records, _since
    now = _clock_pair()
    spans, _records = _records, []
    clock = None if _since is None else Clock(*_since, *now)
    _since = now if _on else None
    return spans, clock


def profiler_ns(t: float, clock: Clock) -> float:
    """A time.perf_counter_ns() time on torch.profiler's clock (the
    Unix-epoch nanoseconds of kineto's events), linear through the Clock's
    two pairs."""
    if clock.perf1 <= clock.perf0:
        return clock.unix0 + (t - clock.perf0)
    return clock.unix0 + (t - clock.perf0) * (clock.unix1 - clock.unix0) / (
        clock.perf1 - clock.perf0)


def _default_logdir() -> str:
    return os.path.join(tempfile.gettempdir(), "tinyfusers_trace")


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``torch.profiler`` (CPU, and CUDA where there is a GPU) over the
    block, with the program's spans recorded over it; the trace is written
    as ``logdir/trace_<ns>.json`` on exit, with the spans that closed in
    the block on a host track of their own, on the profiler's clock, so
    that a span shows over the ops and kernels issued inside it. Inside a
    tracing() that is already on, the spans stay for its drain()."""
    global _records, _since
    logdir = logdir or _default_logdir()
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    owner, since, first = not _on, _since, _clock_pair()
    with tracing(), torch.profiler.profile(activities=acts) as prof:
        yield logdir
    clock = Clock(*first, *_clock_pair())
    spans = [s for s in _records if s.end_ns >= first[0]]
    if owner:  # the recording was this block's: leave the recorder as it was
        _records = [s for s in _records if s.end_ns < first[0]]
        _since = since
    path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if spans:
        with open(path) as fh:
            data = json.load(fh)
        data["traceEvents"].extend(_chrome_events(spans, clock,
                                                  data.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as fh:
            json.dump(data, fh)


SPAN_TRACK = "program spans"  # the spans' tid: a name, so no thread's track


def _chrome_events(spans: List[Span], clock: Clock, base_ns: int) -> List[dict]:
    """Chrome-trace events of spans, in microseconds from the trace's base
    as kineto writes them: the spans of the thread, which nest, as complete
    ("X") events on the SPAN_TRACK; a request's span, which crosses other
    spans, as an async begin / end pair ("b" / "e") of its own id."""
    pid, out = os.getpid(), []
    for s in spans:
        ts, te = ((profiler_ns(t, clock) - base_ns) / 1e3 for t in (s.start_ns, s.end_ns))
        if s.request_id is None:
            out.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                        "tid": SPAN_TRACK, "ts": ts, "dur": te - ts,
                        "args": {"id": s.id, "parent": s.parent}})
        else:
            ev = {"cat": "request", "name": s.name, "id": s.id, "pid": pid, "tid": SPAN_TRACK}
            out += [{**ev, "ph": "b", "ts": ts, "args": {"request_id": s.request_id}},
                    {**ev, "ph": "e", "ts": te}]
    return out


def _kernel_busy_us(events) -> float:
    """Microseconds covered by the union of the ``kernel`` intervals of a
    Chrome trace's events: kernels on several streams overlap in time, and
    summing their durations would overstate how long the device was busy."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel" and "dur" in e)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop
    return busy


def device_time_from_trace(logdir: Optional[str] = None) -> Optional[float]:
    """Seconds the device was busy in the newest trace under ``logdir``:
    the union of its CUDA-kernel intervals. None when there is no trace or
    it holds no kernel (a CPU-only run)."""
    logdir = logdir or _default_logdir()
    traces = sorted(glob.glob(os.path.join(logdir, "*.json"))
                    + glob.glob(os.path.join(logdir, "*.json.gz")), key=os.path.getmtime)
    if not traces:
        return None
    opener = gzip.open if traces[-1].endswith(".gz") else open
    with opener(traces[-1], "rt") as fh:
        data = json.load(fh)
    busy = _kernel_busy_us(data.get("traceEvents", []))
    return busy / 1e6 if busy else None


def device_memory_stats(device=None) -> Dict[str, int]:
    """{"bytes_in_use", "peak_bytes_in_use"} of the CUDA caching allocator
    on ``device`` (the current GPU by default); {} on the CPU or without a
    GPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.cuda.current_device()
    elif torch.device(device).type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}


class StepMetrics:
    """Rolling window of step latencies -> p50/p95/throughput."""

    def __init__(self, window: int = 200):
        self.window = window
        self._lat: List[float] = []
        self._items = 0
        self._t_start = time.monotonic()

    def record(self, seconds: float, items: int = 1) -> None:
        self._lat.append(seconds)
        self._items += items
        if len(self._lat) > self.window:
            self._lat.pop(0)

    def summary(self) -> Dict[str, float]:
        if not self._lat:
            return {}
        lat = sorted(self._lat)
        return {
            "p50_s": statistics.median(lat),
            "p95_s": lat[min(len(lat) - 1, int(0.95 * len(lat)))],
            "mean_s": statistics.fmean(lat),
            "throughput_items_per_s": self._items / max(
                1e-9, time.monotonic() - self._t_start
            ),
        }
