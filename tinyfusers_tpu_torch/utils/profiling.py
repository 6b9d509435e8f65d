"""Profiling and observability (port of tinyfusers_tpu/utils/profiling.py).

- hard_sync / Timer: wall clock around work that ends in a device
  synchronize.
- trace(): ``torch.profiler`` over a block, written as a Chrome trace
  under ``logdir``; device_time_from_trace() reads the device's busy time
  back from it.
- device_memory_stats(): the caching allocator's held and peak bytes.
- StepMetrics: rolling latency / throughput for serving loops.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import statistics
import tempfile
import time
from typing import Dict, List, Optional

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


def _default_logdir() -> str:
    return os.path.join(tempfile.gettempdir(), "tinyfusers_trace")


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``torch.profiler`` (CPU, and CUDA where there is a GPU) over the
    block; the trace is written as ``logdir/trace_<ns>.json`` on exit."""
    logdir = logdir or _default_logdir()
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


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
