"""Run one cell once, traced, with the program's span recording on over the
window, and print what the spans read beside the cell's result line.

    python3 h100bench/spans_run.py --workload sd15-serve-poisson --seed 7 --seconds 51

From the root of a checkout, on a machine with a CUDA device. The cell
runs through the harness as ``run.py --trace 1`` runs it; this tool turns
``tinyfusers_tpu_torch.utils.profiling.tracing()`` on when the driver
calls ``run.begin_window()`` (``--spans 0`` leaves it off: the same run
without spans, to price them) and keeps the Slice the driver profiles.
After the run it leaves what the drivers of a later benchmark will leave
in ``run.records`` themselves (``spans`` and ``clock`` from
``profiling.drain()``, the kept ``slice``) and reads the span metrics'
files, ``metrics/<name>.py`` for each of SPAN_METRICS, and
``lib/spans.breakdown()`` (the idle split by span, the mapping's check,
the generate spans' share of the busy time).

The last line on stdout is one JSON object: the cell's result under
``result``, the readings under ``spans``. The span metrics are not in
BENCHMARK.json: its drivers do not turn the program's tracing on. Once
they do (two lines each) and BENCHMARK.json lists the metrics, run.py
reads them and this tool is to be deleted.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


SPAN_METRICS = ("queue_wait_p90_s.serve", "slot_step_idle_share.serve", "encode_ms.gen",
                "denoise_step_ms.gen", "decode_ms.gen")


def readings(run, roots=(ROOT / "h100bench",)) -> dict:
    """What the program's spans read in one traced Run whose records hold
    them: each of SPAN_METRICS that reads a value, and the breakdown."""
    from h100bench.lib import harness
    from h100bench.lib import spans as S

    out = {}
    for name in SPAN_METRICS:
        value = harness.load_module(harness.find(roots, f"metrics/{name}.py")).read(run)
        if value is not None:
            out[name] = value
    return {**out, **S.breakdown(run)}


@contextlib.contextmanager
def recording(spans_on: bool):
    """Over the block: the program's tracing on from ``run.begin_window()``
    (when ``spans_on``) to the block's end, and the Slices that the driver
    summarizes after the window began kept; yields the kept slices."""
    from h100bench.lib import harness, trace
    from tinyfusers_tpu_torch.utils import profiling

    kept, began = [], []
    on = contextlib.ExitStack()
    begin_window, summary = harness.Run.begin_window, trace.Slice.summary

    def begin(run):
        t0 = begin_window(run)
        began.append(t0)
        if spans_on:
            on.enter_context(profiling.tracing())
        return t0

    def keep(sl):
        if began:  # not warm_profiler()'s
            kept.append(sl)
        return summary(sl)

    harness.Run.begin_window, trace.Slice.summary = begin, keep
    try:
        yield kept
    finally:
        harness.Run.begin_window, trace.Slice.summary = begin_window, summary
        on.close()


def traced(workload: str, seed: int, seconds: float, spans_on: bool = True, **kw) -> dict:
    """One traced run of a cell through harness.run_workload (``kw``
    passed on) with the program's spans recorded over its window:
    {"result": the result line's dict, "spans": readings()}."""
    from h100bench.lib import harness
    from tinyfusers_tpu_torch.utils import profiling

    runs = []
    profiling.drain()
    with recording(spans_on) as kept:
        result = harness.run_workload(workload, seed, seconds, True, runs=runs, **kw)
    run = runs[0]
    run.records["spans"], run.records["clock"] = profiling.drain()
    run.records["slice"] = kept[-1] if kept else None
    roots = kw.get("roots", (ROOT / "h100bench",))
    out = readings(run, roots)
    calls = run.records.get("calls")
    if calls:
        out["call_s_median"] = statistics.median(c["s"] for c in calls)
    return {"result": result, "spans": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    from h100bench.run import power_limit, process_start

    t_start = process_start()
    import torch

    from h100bench.lib import harness

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 3
    out = traced(args.workload, args.seed, args.seconds, bool(args.spans), t_start=t_start)
    harness.log(f"[spans] {args.workload} seed {args.seed} spans {'on' if args.spans else 'off'} "
                f"({torch.cuda.get_device_name(0)}, power limit {power_limit()}): "
                + json.dumps(out["spans"]))
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"refused: the run loaded {', '.join(bad)}")
        return 4
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "spans_on": bool(args.spans), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
