"""Device memory of the serving engine's step, by UNet format (the port's
counterpart of benchmarks/memory_footprint.py).

    python3 tools/memory_footprint_torch.py [--preset sd15|tiny] [--slots 4]
        [--variants fp16,int8,int4] [--cpu] [--json out.json]

The JAX tool reads XLA's ahead-of-time ``memory_analysis()`` of the
engine's compiled step; PyTorch compiles no such program, so the rows are
counted and measured here instead, for a fresh seeded bf16 model whose UNet
is quantized in place (io/quantize_tree.quantize_params) and an engine of
``--slots`` slots over it (serve/engine.py):

- ``argument_mb``: the step's inputs as bytes of tensors: the UNet's
  parameters and quantized buffers, the slot latents (S, h, w, c) and
  contexts (2S, T, D) the engine holds, and the per-tick control block
  (5 x S fp32). Exact on any device.
- ``output_mb``: the step's output, the new slot latents.
- ``temp_mb``: the caching allocator's peak over one tick with every slot
  busy, less the bytes held before the tick
  (``torch.cuda.reset_peak_memory_stats`` / ``max_memory_allocated``),
  plus the bytes that the private pools of CUDA graphs reserve on the
  device (``graph_pool_bytes``): the temporaries of the step that the
  engine replays live in its graph's pool, and a replay allocates nothing.
  The allocator's counters exist only on CUDA, so on the CPU it is null,
  and so is ``total_mb``.
- ``total_mb``: the three together.

MB is 2^20 bytes. Runs on the GPU unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tinyfusers_tpu_torch.serve import Engine  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from serve_quant_bench_torch import PRESETS, prompt_ids, quantized_model  # noqa: E402

VARIANTS = ("fp16", "int8", "fp8", "int4")
MB = 2 ** 20


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", choices=list(PRESETS), default="sd15")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--variants", default="fp16,int8,int4")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    unknown = [v for v in args.variants.split(",") if v and v not in VARIANTS]
    if unknown:
        p.error(f"--variants: unknown {unknown}; choose from {list(VARIANTS)}")
    return args


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def graph_pool_bytes(device: torch.device) -> int:
    """Bytes that the private pools of CUDA graphs reserve on ``device``:
    the caching allocator's segments in any pool but its default one."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == index and tuple(seg["segment_pool_id"]) != (0, 0))


def footprint(eng: Engine) -> Dict[str, Optional[float]]:
    """The engine step's argument, output and temporary bytes, in MB."""
    unet = eng.model.unet
    argument = (nbytes([*unet.parameters(), *unet.buffers()])
                + nbytes([eng.latents, eng.contexts]) + 5 * eng.S * 4)
    output = nbytes([eng.latents])
    temp = None
    if eng.device.type == "cuda":
        ids = prompt_ids(eng.cfg)
        for i in range(eng.S):  # two steps each: the first tick completes none
            eng.submit(eng.make_request(ids, ids, num_steps=2, seed=i))
        torch.cuda.synchronize(eng.device)
        before = torch.cuda.memory_allocated(eng.device)
        torch.cuda.reset_peak_memory_stats(eng.device)
        eng.step()
        torch.cuda.synchronize(eng.device)
        temp = (torch.cuda.max_memory_allocated(eng.device) - before
                + graph_pool_bytes(eng.device))
        eng.run_until_idle()
    return {"argument_mb": argument / MB, "output_mb": output / MB,
            "temp_mb": None if temp is None else temp / MB,
            "total_mb": None if temp is None else (argument + output + temp) / MB}


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    """Prints one JSON row per variant and the table; returns the rows."""
    args = parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    rows = []
    for variant in [v for v in args.variants.split(",") if v]:
        model = quantized_model(args.preset, variant, device)
        eng = Engine(model, num_slots=args.slots)
        row = {"variant": variant, **{k: None if v is None else round(v, 3)
                                      for k, v in footprint(eng).items()}}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del eng, model
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    print(f"\n== engine-step device memory ({args.preset}, {args.slots} slots, bytes of "
          f"tensors; temp: allocator peak over one tick) ==")
    print(f"{'variant':8s} {'args(MB)':>9s} {'temp(MB)':>9s} {'out(MB)':>8s} {'total(MB)':>10s}")
    cell = lambda v, w: f"{'null':>{w}s}" if v is None else f"{v:{w}.1f}"  # noqa: E731
    for r in rows:
        print(f"{r['variant']:8s} {cell(r['argument_mb'], 9)} {cell(r['temp_mb'], 9)} "
              f"{cell(r['output_mb'], 8)} {cell(r['total_mb'], 10)}")
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
