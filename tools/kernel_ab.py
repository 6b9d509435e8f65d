"""A/B of one kernel's wrappers in two checkouts on one NVIDIA GPU.

    python3 tools/kernel_ab.py --kernel flash --parent PATH
    python3 tools/kernel_ab.py --kernel int8|fp8|int4 --parent PATH
    python3 tools/kernel_ab.py --kernel int8|fp8|int4 --sweep
    python3 tools/kernel_ab.py --kernel geglu --parent PATH
    python3 tools/kernel_ab.py --kernel geglu --sweep

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
* ``int8``, ``fp8`` (e4m3), ``int4``: ``quant_matmul`` or
  ``quant_matmul_int4`` at the 19 UNet shapes of chip_smoke.py's
  QUANT_SHAPES (bf16, int4 with g = 64, a bf16 bias, the weight in a
  model's layout), with dense ``F.linear`` (and for int4
  ``torch._weight_int4pack_mm``, tinygemm) timed beside it in the same
  process, the per-image sums (launches x ms) over all 19 shapes and over
  the M <= 154 ones, and a hash of each output's bits.
* ``geglu``: ``geglu_matmul`` at the SD1.5 FF shapes of chip_smoke.py's
  GEGLU_SHAPES (bf16, gx and gate the strided halves of one projection, a
  bf16 bias), with the unfused two-call path ``F.linear(gx * F.gelu(gate),
  w, b)`` timed beside it as a yardstick (exact erf: not the same function),
  the per-image sum (launches x ms) and a hash of each output's bits.

Each run prints one JSON line; the last line holds all four runs, the
card's name and power limit and, for the quant kernels, whether the four
runs gave the same bits at each shape. ``--sweep`` instead times every
(tile, split) of this checkout's wgmma variant for the format at the 19
shapes (the data its plan's rule was fitted to), one JSON line per shape;
for ``geglu`` every (bn, split) of the wgmma variant at the four FF
shapes.
"""
from __future__ import annotations

import argparse
import hashlib
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


# --kernel -> (wrapper name, weight format: a torch dtype or "int4")
QUANT = {"int8": ("quant_matmul", "int8"), "fp8": ("quant_matmul", "float8_e4m3fn"),
         "int4": ("quant_matmul_int4", "int4")}


def _quant_case(gen, kernel, m, k, n, g=64):
    """x, a quantized weight in a model's storage (values (N, K), or int4's
    (N, K/2) bytes and (N, K/g) scales, seen as (K, N), (K/2, N) and (K/g,
    N), as layers.Linear holds them) and a bf16 bias, seeded."""
    import torch
    from tinyfusers_tpu_torch.ops.quant import Int4Tensor, QuantizedTensor, quantize, quantize_int4

    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    dense = torch.randn(n, k, generator=gen, device="cuda").t() * k ** -0.5
    if kernel == "int4":
        w = quantize_int4(dense, axis=0, group_size=g)
        w = Int4Tensor(w.packed.t().contiguous().t(), w.scales.t().contiguous().t(), axis=0,
                       group_size=w.group_size, orig_dim=k)
    else:
        w = quantize(dense, getattr(torch, QUANT[kernel][1]))
        w = QuantizedTensor(w.values.t().contiguous().t(), w.scales)
    b = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
    return x, w, b


def _digest(t) -> str:
    """A short hash of a tensor's bits, to tell bit-identical outputs."""
    import torch

    return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


def measure_quant(checkout: Path, kernel: str) -> dict:
    import torch
    import torch.nn.functional as F

    cs, gen = _setup(checkout)
    from tinyfusers_tpu_torch.kernels import quant_matmul as qm

    fn = getattr(qm, QUANT[kernel][0])
    out = {"checkout": str(checkout), "ms": {}, "dense_ms": {}, "digest": {}}
    if kernel == "int4":
        out["library_ms"] = {}
    sums = {key: dict.fromkeys([f for f in ("ms", "library_ms", "dense_ms") if f in out], 0.0)
            for key in ("all", "small")}
    for (m, k, n), launches in cs.QUANT_SHAPES.items():
        x, w, b = _quant_case(gen, kernel, m, k, n)
        label = f"{m},{k},{n}"
        out["digest"][label] = _digest(fn(x, w, b))
        out["ms"][label] = cs.cuda_ms(lambda: fn(x, w, b), 20)
        if kernel == "int4":
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


def _geglu_case(gen, m, k, n):
    """gx and gate (the strided halves of one (m, 2k) projection, as the UNet
    passes them), w (k, n) seen from a module's (n, k) storage, a bf16 bias."""
    import torch

    proj = torch.randn(m, 2 * k, generator=gen, device="cuda").to(torch.bfloat16)
    gx, gate = proj.chunk(2, dim=-1)
    w = (torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16).t()
    b = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
    return gx, gate, w, b


def measure_geglu(checkout: Path) -> dict:
    import torch.nn.functional as F

    cs, gen = _setup(checkout)
    from tinyfusers_tpu_torch.kernels.geglu_ff import geglu_matmul

    out = {"checkout": str(checkout), "ms": {}, "unfused_ms": {}, "digest": {},
           "per_image_ms": {"ms": 0.0, "unfused_ms": 0.0}}
    for label, (m, k, n), launches in cs.GEGLU_SHAPES:
        gx, gate, w, b = _geglu_case(gen, m, k, n)
        wt = w.t()
        out["digest"][label] = _digest(geglu_matmul(gx, gate, w, b))
        out["ms"][label] = cs.cuda_ms(lambda: geglu_matmul(gx, gate, w, b), 20)
        out["unfused_ms"][label] = cs.cuda_ms(lambda: F.linear(gx * F.gelu(gate), wt, b), 20)
        for field in ("ms", "unfused_ms"):
            out["per_image_ms"][field] += launches * out[field][label]
    return out


def sweep_geglu() -> None:
    """Every (bn, split) the wgmma variant takes at the four FF shapes,
    through the C entry, each checked against the plain version."""
    import torch

    cs, gen = _setup(ROOT)
    from tinyfusers_tpu_torch.kernels import _build
    from tinyfusers_tpu_torch.kernels import geglu_ff as gf

    entry = _build.entry("geglu_ff", "tf_geglu_ff", gf._ARGS)
    for label, (m, k, n), launches in cs.GEGLU_SHAPES:
        gx, gate, w, b = _geglu_case(gen, m, k, n)
        wt = w.t().contiguous()
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        want = gf.geglu_matmul_plain(gx, gate, w, b)
        times = {}
        for bn in (160, 320):
            for split in (1, 2, 4):
                if split > k // 64:
                    continue

                def call():
                    entry(gf._VARIANTS["wgmma"], 1, gx.data_ptr(), gate.data_ptr(),
                          gx.stride(0), wt.data_ptr(), b.data_ptr(), 1, out.data_ptr(),
                          m, n, k, bn, split, torch.cuda.current_stream().cuda_stream)

                out.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                err = ((out.float() - want.float()).norm() / want.float().norm()).item()
                if not err <= 5e-4:
                    raise SystemExit(f"geglu ({m},{k},{n}) {bn}/{split}: "
                                     f"rel err {err:.3e}")
                times[f"{bn}/{split}"] = cs.cuda_ms(call, 20)
        plan = "/".join(map(str, gf._plan(torch.bfloat16, m, k, n)[1:]))
        best = min(times, key=times.get)
        print(json.dumps({"kernel": "geglu", "shape": [m, k, n], "launches": launches,
                          "plan": plan, "plan_ms": times[plan], "best": best,
                          "best_ms": times[best], "ms": times}), flush=True)


def sweep(kernel: str) -> None:
    """Every (tile, split) the wgmma variant takes at each of the 19 shapes,
    through the C entry, each checked against the plain version."""
    import torch

    cs, gen = _setup(ROOT)
    from tinyfusers_tpu_torch.kernels import _build
    from tinyfusers_tpu_torch.kernels import quant_matmul as qm

    entry = _build.entry("quant_matmul", "tf_quant_matmul", qm._ARGS)
    int4 = kernel == "int4"
    plain = qm.quant_matmul_int4_plain if int4 else qm.quant_matmul_plain
    g = 64 if int4 else None
    for (m, k, n), launches in cs.QUANT_SHAPES.items():
        x, w, b = _quant_case(gen, kernel, m, k, n)
        if int4:
            fmt, rows, scales = qm._INT4, w.packed.t().contiguous(), w.scales.t().contiguous()
        else:
            fmt, rows = qm._FORMATS[w.values.dtype][0], w.values.t().contiguous()
            scales = w.scales.reshape(-1).float().contiguous()
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        want = plain(x, w, b)
        times = {}
        for tile in (8, 64, 128, 160):
            if (tile == 8) != (m <= 8):
                continue
            for split in range(1, min(8, k // 64) + 1):
                if int4 and qm._groups(k, 64, split) > qm._MAX_GROUPS:
                    continue

                def call():
                    entry(qm._VARIANTS["wgmma"], 1, fmt, x.data_ptr(), rows.data_ptr(),
                          scales.data_ptr(), b.data_ptr(), 1, out.data_ptr(), m, n, k,
                          g or 0, tile, split, torch.cuda.current_stream().cuda_stream)

                call()
                torch.cuda.synchronize()
                err = ((out.float() - want.float()).norm() / want.float().norm()).item()
                if not err <= 5e-4:
                    raise SystemExit(f"{kernel} ({m},{k},{n}) tile {tile} split {split}: "
                                     f"rel err {err:.3e}")
                times[f"{tile}/{split}"] = cs.cuda_ms(call, 20)
        plan = qm._plan(torch.bfloat16, m, k, n, g)
        best = min(times, key=times.get)
        print(json.dumps({"kernel": kernel, "shape": [m, k, n], "launches": launches,
                          "plan": f"{plan[1]}/{plan[2]}",
                          "plan_ms": times[f"{plan[1]}/{plan[2]}"], "best": best,
                          "best_ms": times[best], "ms": times}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("flash", "geglu", *QUANT), required=True)
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--sweep", action="store_true",
                    help="int8 / fp8 / int4 / geglu: time every (tile, split)")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        checkout = args.measure.resolve()
        res = (measure_flash(checkout) if args.kernel == "flash"
               else measure_geglu(checkout) if args.kernel == "geglu"
               else measure_quant(checkout, args.kernel))
        print(json.dumps(res), flush=True)
        return
    if args.sweep:
        if args.kernel == "flash":
            ap.error("--sweep is for the quant and geglu kernels")
        sweep_geglu() if args.kernel == "geglu" else sweep(args.kernel)
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
    summary = {"card": card, "kernel": args.kernel,
               "order": ["parent", "this", "this", "parent"], "runs": runs}
    if "digest" in runs[0]:  # per shape: do the four runs give the same bits?
        summary["bit_identical"] = {label: len({r["digest"][label] for r in runs}) == 1
                                    for label in runs[0]["digest"]}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
