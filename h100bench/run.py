"""Run one cell of the benchmark of tinyfusers_tpu_torch once, on the GPUs
of this machine, and print its result as one JSON line on stdout.

    python3 h100bench/run.py --workload sd15-serve-poisson --seed 7 --seconds 50 --trace 0

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read from a profiled slice
of the same window. The numbers compared with the plain reference are
printed beside their limits as the last lines on stderr and, under
``checks``, last in the result line. Exits non-zero without a result when
no CUDA device is there, when the cell needs more devices than there are,
and when JAX or the JAX package was loaded. The port's kernel libraries
build into its own csrc/build/ and native/build/, inside the checkout;
any other compile cache goes to .bench_cache/ there.
"""
from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc), or the
    time this module was loaded where /proc cannot tell."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return min(_T_IMPORT, time.time() - (uptime - started))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it (a card below 700 W
    runs slower under load), or "unknown"."""
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = done.stdout.strip().splitlines() if done.returncode == 0 else []
    return lines[0] if lines else "unknown"


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from h100bench.lib import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        harness.log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA device(s); this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = harness.run_workload(args.workload, args.seed, args.seconds, bool(args.trace),
                                  bench=bench, t_start=t_start)
    read = ", ".join(f"{k} {v['value']:.6g} {v['unit']}" for k, v in result["metrics"].items())
    harness.log(f"[device] {torch.cuda.get_device_name(0)}, power limit {power_limit()}, "
                f"torch {torch.__version__}; {read}")
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"refused: the run loaded {', '.join(bad)}")
        return 4
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
