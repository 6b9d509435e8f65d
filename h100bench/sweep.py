"""Find the highest rate the serving engine sustains: one process offers
the cell's traffic at several fixed rates, one window each, and prints for
each the rate completed, the latency and whether the queue kept growing.

    python3 h100bench/sweep.py --workload sd15-serve-poisson \
        --rates 1.2,1.5,1.8,2.1,2.4 --seconds 40

The queue grows when the mean queue depth over the window's last quarter
exceeds that over its second quarter by more than one request; the knee
is the highest rate at which it does not.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None, bench=None, roots=None) -> int:
    """bench, roots: a BENCHMARK dict and search roots in place of the
    checkout's (tests)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from h100bench.lib import harness
    from h100bench.lib.inputs import prompt
    from tinyfusers_tpu_torch.serve import Engine

    bench = json.loads((ROOT / "BENCHMARK.json").read_text()) if bench is None else bench
    roots = (harness.HERE,) if roots is None else roots
    workload, cfg, config, traffic, driver, _ = harness.load_cell(args.workload, roots, bench)
    length, vocab = cfg["clip"]["max_length"], cfg["clip"]["vocab_size"]
    eng = Engine(config.build(cfg, args.seed, args.device), num_slots=traffic["num_slots"])
    driver.warm_up(eng, traffic, args.seed, length, vocab)
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        T = dict(traffic, rate_per_s=rate)
        sched = driver.schedule(T, args.seed, args.seconds, length, vocab)
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = driver.serve(eng, sched, T, prompt(None, 0, length, vocab), t0, args.seconds)
        ticks = [t for t in out["ticks"] if t["in_window"]]
        q = lambda a, b: float(np.mean([t["pending"] for t in ticks  # noqa: E731
                                        if a <= t["t"] / args.seconds < b] or [0]))
        grows = q(0.75, 1.0) > q(0.25, 0.5) + 1.0
        done = sum(t <= out["end"] for t in out["done_t"].values())
        row = {"rate": rate, "sent": out["sent"], "completed_per_s": done / args.seconds,
               "failed": out["n"] - len(out["done_t"]),
               "p50_s": float(np.percentile(out["lat"], 50)),
               "p90_s": float(np.percentile(out["lat"], 90)),
               "queue_q2": q(0.25, 0.5), "queue_q4": q(0.75, 1.0), "grows": grows,
               "tick_ms": 1e3 * float(np.mean([t["s"] for t in ticks if t["active"]] or [0]))}
        print(json.dumps(row), flush=True)
        if not grows:
            knee = rate if knee is None else max(knee, rate)
        eng.reset()
    print(json.dumps({"workload": args.workload, "knee_per_s": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
