"""A/B of one kernel's wrappers in two checkouts on one NVIDIA GPU.

    python3 tools/kernel_ab.py --kernel flash --parent PATH
    python3 tools/kernel_ab.py --kernel int4 --parent PATH
    python3 tools/kernel_ab.py --kernel int4 --sweep

PATH is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists). Each checkout's ``tinyfusers_tpu_torch`` runs in a process of its
own, in the order parent, this, this, parent, and builds its own kernels.
Device times are ``chip_smoke.cuda_ms``: CUDA-graph replays of the wrapper
call timed by events, as phase 3 of chip_smoke.py times them.

* ``flash``: every bf16 flash-attention shape of the main paths
  (chip_smoke.py's PACKED_SHAPES, MULTIK_SHAPES and BHSD_SHAPES), and the
  host microseconds of one eager ``flash_packed`` call at SD1.5's 64x64
  self-attention shape (``chip_smoke.wrapper_host_us``).
* ``int4``: ``quant_matmul_int4`` at the 19 UNet shapes of chip_smoke.py's
  QUANT_SHAPES (bf16, g = 64, a bf16 bias, the weight in a model's
  layout), with ``torch._weight_int4pack_mm`` (tinygemm) and dense
  ``F.linear`` timed beside it in the same process, and the per-image sums
  (launches x ms) over all 19 shapes and over the M <= 154 ones.

Each run prints one JSON line; the last line holds all four runs and the
card's name and power limit. ``--sweep`` instead times every (tile, split)
of this checkout's int4 wgmma kernel at the 19 shapes (the data its plan's
rule was fitted to), one JSON line per shape.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _setup(checkout: Path):
    """chip_smoke of this checkout (shape lists and timers), the other
    checkout's package first on the path, its kernels built; a seeded
    generator on the card."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(checkout))
    from tinyfusers_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA GPU")
    _build.build_all()
    return chip_smoke, torch.Generator(device="cuda").manual_seed(0)


def measure_flash(checkout: Path) -> dict:
    import torch

    cs, gen = _setup(checkout)
    from tinyfusers_tpu_torch.kernels.flash_attention import flash_bhsd, flash_packed

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    out = {"checkout": str(checkout), "ms": {}}
    for label, (b, sq, sk, c, h, kvl) in cs.PACKED_SHAPES + cs.MULTIK_SHAPES:
        q, k, v = randn(b, sq, c), randn(b, sk, c), randn(b, sk, c)
        call = lambda: flash_packed(q, k, v, heads=h, kv_len=kvl)  # noqa: E731
        out["ms"][label] = cs.cuda_ms(call, 10 if b * sq * kvl * c < 2.5e10 else 3)
        if label == "64x64 self":
            out["host_us_64x64_self"] = cs.wrapper_host_us(call)
    for label, (n, sq, sk, d) in cs.BHSD_SHAPES:
        q, k, v = randn(1, n, sq, d), randn(1, n, sk, d), randn(1, n, sk, d)
        out["ms"][label] = cs.cuda_ms(lambda: flash_bhsd(q, k, v), 3)
    return out


def _int4_case(gen, m, k, n, g=64):
    """x, an int4 weight in a model's storage ((N, K/2) bytes, (N, K/g)
    scales, seen as (K/2, N) and (K/g, N)) and a bf16 bias, seeded."""
    import torch
    from tinyfusers_tpu_torch.ops.quant import Int4Tensor, quantize_int4

    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = quantize_int4(torch.randn(n, k, generator=gen, device="cuda").t() * k ** -0.5, axis=0,
                      group_size=g)
    w = Int4Tensor(w.packed.t().contiguous().t(), w.scales.t().contiguous().t(), axis=0,
                   group_size=w.group_size, orig_dim=k)
    b = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
    return x, w, b


def measure_int4(checkout: Path) -> dict:
    import torch
    import torch.nn.functional as F

    cs, gen = _setup(checkout)
    from tinyfusers_tpu_torch.kernels.quant_matmul import quant_matmul_int4

    out = {"checkout": str(checkout), "ms": {}, "library_ms": {}, "dense_ms": {}}
    sums = {key: dict.fromkeys(("ms", "library_ms", "dense_ms"), 0.0)
            for key in ("all", "small")}
    for (m, k, n), launches in cs.QUANT_SHAPES.items():
        x, w, b = _int4_case(gen, m, k, n)
        label = f"{m},{k},{n}"
        out["ms"][label] = cs.cuda_ms(lambda: quant_matmul_int4(x, w, b), 20)
        lib, _ = cs.int4pack_mm(x, w)
        out["library_ms"][label] = None if lib is None else cs.cuda_ms(lib, 20)
        wd = w.dequantize(torch.bfloat16).t().contiguous()
        out["dense_ms"][label] = cs.cuda_ms(lambda: F.linear(x, wd, b), 20)
        for key in ("all", "small") if m <= cs.SMALL_M else ("all",):
            for field in sums[key]:
                if out[field][label] is not None:
                    sums[key][field] += launches * out[field][label]
    out["per_image_ms"] = sums
    return out


def sweep_int4() -> None:
    """Every (tile, split) the int4 wgmma kernel takes at each of the 19
    shapes, through its C entry, each checked against the plain version."""
    import torch

    cs, gen = _setup(ROOT)
    from tinyfusers_tpu_torch.kernels import _build
    from tinyfusers_tpu_torch.kernels import quant_matmul as qm

    entry = _build.entry("quant_matmul", "tf_quant_matmul_int4", qm._ARGS_INT4)
    for (m, k, n), launches in cs.QUANT_SHAPES.items():
        x, w, b = _int4_case(gen, m, k, n)
        packed, scales = w.packed.t().contiguous(), w.scales.t().contiguous()
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        want = qm.quant_matmul_int4_plain(x, w, b)
        times = {}
        for tile in (8, 64, 128, 160):
            if (tile == 8) != (m <= 8):
                continue
            for split in range(1, min(8, k // 64) + 1):
                if qm._groups(k, 64, split) > qm._MAX_GROUPS:
                    continue

                def call():
                    entry(qm._VARIANTS["wgmma"], 1, x.data_ptr(), packed.data_ptr(),
                          scales.data_ptr(), b.data_ptr(), 1, out.data_ptr(), m, n, k, 64,
                          tile, split, torch.cuda.current_stream().cuda_stream)

                call()
                torch.cuda.synchronize()
                err = ((out.float() - want.float()).norm() / want.float().norm()).item()
                if not err <= 5e-4:
                    raise SystemExit(f"({m},{k},{n}) tile {tile} split {split}: "
                                     f"rel err {err:.3e}")
                times[f"{tile}/{split}"] = cs.cuda_ms(call, 20)
        plan = qm._plan(torch.bfloat16, m, k, n, 64)
        best = min(times, key=times.get)
        print(json.dumps({"shape": [m, k, n], "launches": launches,
                          "plan": f"{plan[1]}/{plan[2]}",
                          "plan_ms": times[f"{plan[1]}/{plan[2]}"], "best": best,
                          "best_ms": times[best], "ms": times}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("flash", "int4"), required=True)
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--sweep", action="store_true", help="int4: time every (tile, split)")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    measure = {"flash": measure_flash, "int4": measure_int4}[args.kernel]
    if args.measure is not None:
        print(json.dumps(measure(args.measure.resolve())), flush=True)
        return
    if args.sweep:
        if args.kernel != "int4":
            ap.error("--sweep is for --kernel int4")
        sweep_int4()
        return
    if args.parent is None:
        ap.error("--parent is required")
    runs = []
    for checkout in (args.parent.resolve(), ROOT, ROOT, args.parent.resolve()):
        res = subprocess.run([sys.executable, __file__, "--kernel", args.kernel,
                              "--measure", str(checkout)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"run in {checkout} failed:\n{res.stdout}\n{res.stderr[-4000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "kernel": args.kernel,
                      "order": ["parent", "this", "this", "parent"], "runs": runs}))


if __name__ == "__main__":
    main()
