"""Rooflines and model FLOP utilisation from the analytic counts.

A kernel family's roofline share (``<kernel>_roofline``) in a profiled
slice is

    sum over its calls of max(FLOPs / peak FLOP/s, bytes / peak bytes/s)
    ----------------------------------------------------------------
    sum of the device time of the kernels that match its name patterns

in percent. The calls are the benchmark's own count of the slice's work
(counts/flops.py, at the configuration's widths), those of at least
``min_query_tokens`` query tokens; the patterns, the token floor and the
port's call counters that cross-check the count are in
counts/kernels.json; the peaks in counts/peaks.json, by the card's name.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Dict, Iterable, Optional

COUNTS = Path(__file__).resolve().parent.parent / "counts"


def kernels() -> Dict:
    return json.loads((COUNTS / "kernels.json").read_text())


def peaks(device_name: str) -> Optional[Dict]:
    """The peak rates of the card, or None for a card the table lacks."""
    for key, row in json.loads((COUNTS / "peaks.json").read_text()).items():
        if key in device_name:
            return row
    return None


def family_calls(calls: Iterable, family: str):
    floor = kernels()[family]["min_query_tokens"]
    return [c for c in calls if c.family == family and (family != "attn" or c.shape[1] >= floor)]


def bound_s(calls: Iterable, peak: Dict) -> float:
    return sum(max(c.flops / peak["bf16_flops_per_s"], c.bytes / peak["hbm_bytes_per_s"])
               for c in calls)


def kernel_time_s(kernel_s: Dict[str, float], family: str) -> float:
    pats = kernels()[family]["patterns"]
    return sum(s for name, s in kernel_s.items() if any(p in name for p in pats))


def share(run, family: str) -> Optional[float]:
    """The family's roofline share in the run's profiled slice, in percent;
    None where the slice has no such calls or kernels, or the card no peaks."""
    if run.trace is None or run.peak is None:
        return None
    calls = family_calls(run.trace_calls, family)
    t = kernel_time_s(run.trace["kernel_s"], family)
    if not calls or t <= 0.0:
        return None
    return 100.0 * bound_s(calls, run.peak) / t


def counter_launches() -> Dict[str, int]:
    """family -> the launches the port's own wrapper counters hold."""
    out = {}
    for family, row in kernels().items():
        out[family] = 0
        for ref in row["counters"]:
            mod, attr = ref.split(":")
            out[family] += getattr(importlib.import_module(mod), attr).launches
    return out


def cross_check(run) -> str:
    """The slice's counted calls of each family beside the launches the
    port's wrappers counted in it."""
    return ", ".join(f"{f} counted {len(family_calls(run.trace_calls, f))} launched "
                     f"{run.trace['counter_launches'].get(f)}" for f in kernels())


def mfu(flops: float, seconds: float, peak: Optional[Dict]) -> Optional[float]:
    if peak is None or seconds <= 0.0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / peak["bf16_flops_per_s"]
