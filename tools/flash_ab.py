"""A/B of the flash-attention wrappers of two checkouts on one NVIDIA GPU.

    python3 tools/flash_ab.py --parent PATH

PATH is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists). Each checkout's ``tinyfusers_tpu_torch`` runs in a process of its
own, in the order parent, this, this, parent, and builds its own kernels.
Each run measures, at every bf16 flash-attention shape of the main paths
(chip_smoke.py's PACKED_SHAPES, MULTIK_SHAPES and BHSD_SHAPES):

* the wrapper call's device time (``chip_smoke.cuda_ms``: CUDA-graph
  replays timed by events, as phase 3 of chip_smoke.py times it);
* the host microseconds of one eager ``flash_packed`` call at SD1.5's
  64x64 self-attention shape (``chip_smoke.wrapper_host_us``, as phase 3
  measures it).

Each run prints one JSON line; the last line holds all four runs and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def measure(checkout: Path) -> dict:
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import BHSD_SHAPES, MULTIK_SHAPES, PACKED_SHAPES, cuda_ms, wrapper_host_us

    sys.path.insert(0, str(checkout))
    from tinyfusers_tpu_torch.kernels import _build
    from tinyfusers_tpu_torch.kernels.flash_attention import flash_bhsd, flash_packed

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA GPU")
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    out = {"checkout": str(checkout), "ms": {}}
    for label, (b, sq, sk, c, h, kvl) in PACKED_SHAPES + MULTIK_SHAPES:
        q, k, v = randn(b, sq, c), randn(b, sk, c), randn(b, sk, c)
        call = lambda: flash_packed(q, k, v, heads=h, kv_len=kvl)  # noqa: E731
        out["ms"][label] = cuda_ms(call, 10 if b * sq * kvl * c < 2.5e10 else 3)
        if label == "64x64 self":
            out["host_us_64x64_self"] = wrapper_host_us(call)
    for label, (n, sq, sk, d) in BHSD_SHAPES:
        q, k, v = randn(1, n, sq, d), randn(1, n, sk, d), randn(1, n, sk, d)
        out["ms"][label] = cuda_ms(lambda: flash_bhsd(q, k, v), 3)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        print(json.dumps(measure(args.measure.resolve())), flush=True)
        return
    if args.parent is None:
        ap.error("--parent is required")
    runs = []
    for checkout in (args.parent.resolve(), ROOT, ROOT, args.parent.resolve()):
        res = subprocess.run([sys.executable, __file__, "--measure", str(checkout)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"run in {checkout} failed:\n{res.stdout}\n{res.stderr[-4000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "order": ["parent", "this", "this", "parent"],
                      "runs": runs}))


if __name__ == "__main__":
    main()
