"""Serving throughput over a quantized UNet (the port's counterpart of
benchmarks/serve_quant_bench.py).

    python3 tools/serve_quant_bench_torch.py [--requests 12] [--slots 4]
        [--steps 20] [--variants fp16,int8,int4,int4_kernel]
        [--preset sd15|tiny] [--cpu]

For each variant a fresh bf16 model (``StableDiffusion(seed=0)``, the
port's seeded init; the JAX tool's fill lives in bench.py, which imports
jax) has its UNet quantized in place by io/quantize_tree.quantize_params,
and the continuous-batching engine (serve/engine.py) serves it over
``--slots`` slots: one 4-step request as a warm-up, then ``--requests``
requests of ``--steps`` DDIM steps (CFG 7.5, seeds 1..N, the prompt and
the negative prompt both SOT then EOT padding) submitted together and run
until idle. Each variant prints one JSON row: images/s over the requests,
the wall seconds, submit -> result p50 / p95, and the device memory its
model and engine hold after the warm-up (``hbm_gb``: the caching
allocator's bytes in use then, less those in use before the model was
built, so what else the process holds does not count; null on the CPU).

``int4_kernel`` runs the same route as ``int4``: the JAX package chooses
between its Pallas int4 kernel and XLA's dequantize with a trace-time
knob (ops/policy.py), while on CUDA every quantized linear of the port
takes its hand-written kernel (ops/linear.py), so the port has one int4
route. The row keeps the JAX tool's variant name. Runs on the GPU unless
``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tinyfusers_tpu_torch.io.quantize_tree import QDTYPES, quantize_params  # noqa: E402
from tinyfusers_tpu_torch.pipeline import sd  # noqa: E402
from tinyfusers_tpu_torch.serve import Engine  # noqa: E402
from tinyfusers_tpu_torch.utils.profiling import StepMetrics, device_memory_stats  # noqa: E402

PRESETS = {"sd15": sd.SD15, "tiny": sd.TINY}
# variant -> the UNet's format (None: dense bf16)
VARIANTS = {"fp16": None, "int8": "int8", "fp8": "fp8", "int4": "int4", "int4_kernel": "int4"}
WARMUP_STEPS = 4


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--variants", default="fp16,int8,int4,int4_kernel")
    p.add_argument("--preset", choices=list(PRESETS), default="sd15")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    args = p.parse_args(argv)
    unknown = [v for v in args.variants.split(",") if v and v not in VARIANTS]
    if unknown:
        p.error(f"--variants: unknown {unknown}; choose from {list(VARIANTS)}")
    return args


def quantized_model(preset: str, variant: str, device) -> sd.StableDiffusion:
    """A fresh seeded bf16 model with its UNet in ``variant``'s format."""
    model = sd.StableDiffusion(PRESETS[preset], device=device, dtype=torch.bfloat16, seed=0)
    if VARIANTS[variant] is not None:
        quantize_params(model.unet, QDTYPES[VARIANTS[variant]])
    return model


def prompt_ids(cfg: sd.SDConfig) -> np.ndarray:
    """SOT (vocab - 2) then EOT (vocab - 1) padding: 49406, 49407... at SD1.5."""
    ids = np.full((cfg.clip.max_length,), cfg.clip.vocab_size - 1, np.int64)
    ids[0] = cfg.clip.vocab_size - 2
    return ids


def bytes_in_use(device) -> Optional[int]:
    """The caching allocator's bytes in use on ``device`` after a garbage
    collection; None on the CPU."""
    gc.collect()
    return device_memory_stats(device).get("bytes_in_use")


def bench(eng: Engine, requests: int, steps: int, base_bytes: int = 0,
          around: Optional[Callable[[], contextlib.AbstractContextManager]] = None
          ) -> Dict[str, object]:
    """A warm-up request, then ``requests`` requests submitted together and
    served until idle -> the row's numbers; the memory held after the
    warm-up is counted from ``base_bytes``. ``around()``, when given, is a
    context manager entered around the served requests alone."""
    ids = prompt_ids(eng.cfg)
    eng.submit(eng.make_request(ids, ids, num_steps=WARMUP_STEPS, seed=0))
    eng.run_until_idle()
    held = bytes_in_use(eng.device)
    latency = StepMetrics()
    with around() if around else contextlib.nullcontext():
        t0 = time.perf_counter()
        for i in range(requests):
            eng.submit(eng.make_request(ids, ids, num_steps=steps, seed=i + 1))
        done: List = []
        while eng.core.active() or eng.core.pending():
            for r in eng.step():
                latency.record(time.perf_counter() - t0)
                done.append(r)
        for r in eng.flush():
            latency.record(time.perf_counter() - t0)
            done.append(r)
        wall = time.perf_counter() - t0
    if len(done) != requests:
        raise RuntimeError(f"{len(done)} results for {requests} requests")
    lat = latency.summary()
    return {"images_per_s": requests / wall, "wall_s": wall, "p50_s": lat["p50_s"],
            "p95_s": lat["p95_s"], "hbm_gb": None if held is None else (held - base_bytes) / 1e9,
            "images": {r.request_id: r.image for r in done}}


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    """Serves each variant and prints its row; returns the rows."""
    args = parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    rows = []
    for variant in [v for v in args.variants.split(",") if v]:
        base = bytes_in_use(device) or 0
        model = quantized_model(args.preset, variant, device)
        eng = Engine(model, num_slots=args.slots)
        out = bench(eng, args.requests, args.steps, base)
        row = {"variant": variant, "images_per_s": round(out["images_per_s"], 3),
               "wall_s": round(out["wall_s"], 2), "p50_s": round(out["p50_s"], 3),
               "p95_s": round(out["p95_s"], 3),
               "hbm_gb": None if out["hbm_gb"] is None else round(out["hbm_gb"], 2),
               "slots": args.slots, "steps": args.steps}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del eng, model, out
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
