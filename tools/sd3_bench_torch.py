"""SD3-medium 1024x1024 single-GPU throughput (the port's counterpart of
benchmarks/sd3_bench.py).

    python3 tools/sd3_bench_torch.py [--steps 28] [--flow-method euler|heun]
        [--quant none|int8|int4] [--preset sd3|tiny] [--cpu]

MMDiT backbone, rectified-flow sampler, dual-CLIP conditioning, 16-channel
VAE, bf16. Random weights (the repository holds no checkpoint); FLOPs and
bytes match real weights. Every parameter gets the JAX tool's fill: one
seeded pool of 2^20 normals times 0.02 (numpy), tiled over each leaf of
the JAX tree in its layout, so the port's model holds the JAX tool's
numbers (a block of a stacked leaf reads its slice of the tiled pool).
``--quant int8|int4`` quantizes the MMDiT's weights with
io/quantize_tree.quantize_params, whose rule (the JAX package's) leaves the
stacked joint blocks dense: 8 leaves, 0.95% of the MMDiT's parameters.
The prompt ids are all 49407 for both towers, the negative the same, the
guidance 5.0; the initial latent is ``sd3.initial_latent(1, ...)`` (a
torch.Generator's draw, not jax.random's). Two warm-up images, then the
best of three by the host clock after synchronize, printed as the JAX
tool prints it. Runs on the GPU unless ``--cpu`` is given; ``--preset
tiny`` (TINY_SD3, 32x32) is for a quick run on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tinyfusers_tpu_torch.io.quantize_tree import quantize_params  # noqa: E402
from tinyfusers_tpu_torch.models.layers import Conv, Linear, stacked_index  # noqa: E402
from tinyfusers_tpu_torch.pipeline import sd3  # noqa: E402

PRESETS = {"sd3": (sd3.SD3_MEDIUM_CFG, "SD3-medium"), "tiny": (sd3.TINY_SD3, "TINY_SD3")}
QDTYPES = {"int8": torch.int8, "int4": "int4"}
GUIDANCE = 5.0
POOL = 1 << 20


def _jax_layout(module, name: str, t: torch.Tensor) -> torch.Tensor:
    """A parameter as the JAX tree holds it: linear weights (in, out),
    conv weights HWIO, the rest as they are (views)."""
    if name == "weight" and isinstance(module, Linear):
        return t.t()
    if name == "weight" and isinstance(module, Conv):
        return t.permute(2, 3, 1, 0)
    return t


def fill_like_jax(model: torch.nn.Module, seed: int = 0) -> None:
    """benchmarks/sd3_bench.py's tree_random on the port's modules: each
    JAX leaf is the tiled pool's first elements in its own layout; a leaf
    stacked for lax.scan (a model's ``STACKED`` containers) gives block i
    the elements from i times the per-block size on."""
    rng = np.random.default_rng(seed)
    pool_np = rng.standard_normal(POOL).astype(np.float32) * 0.02
    dev = next(model.parameters()).device
    pool = torch.from_numpy(pool_np).to(dev)
    block = stacked_index(model)
    with torch.no_grad():
        for mod in model.modules():
            for name, p in mod.named_parameters(recurse=False):
                target = _jax_layout(mod, name, p)
                n = p.numel()
                start = block.get(id(mod), 0) * n
                idx = torch.arange(start, start + n, device=dev) % POOL
                target.copy_(pool[idx].reshape(target.shape).to(p.dtype))


@dataclass
class Job:
    """A model, its inputs and the image call, as main() times them;
    n_params counts the dense model, before any quantization."""
    model: sd3.StableDiffusion3
    ids: torch.Tensor
    latent: torch.Tensor
    steps: int
    method: str
    n_params: int

    def latents(self) -> torch.Tensor:
        """The flow integration alone (the conditioning encoded first)."""
        with torch.inference_mode():
            cc, pc = sd3.encode_text(self.model, self.ids, self.ids)
            ctx2, pool2 = (torch.cat([a, a]).to(self.latent.dtype) for a in (cc, pc))
            return sd3.sample_latents(self.model.mmdit, self.latent, ctx2, pool2, GUIDANCE,
                                      num_steps=self.steps, shift=self.model.cfg.shift,
                                      method=self.method)

    def image(self) -> torch.Tensor:
        return sd3.generate(self.model, self.ids, self.ids, self.ids, self.ids, self.latent,
                            GUIDANCE, num_steps=self.steps, method=self.method)


def build(preset: str = "sd3", quant: str = "none", *, steps: int = 28, method: str = "euler",
          device="cuda") -> Job:
    """The tool's job: the bf16 model made empty on ``device``, filled as
    the JAX tool fills it, its MMDiT quantized where ``quant`` says."""
    cfg, dtype = PRESETS[preset][0], torch.bfloat16
    model = sd3.StableDiffusion3(cfg, device=device, dtype=dtype, seed=None)
    fill_like_jax(model)
    n_params = sum(p.numel() for p in model.parameters())
    if quant != "none":
        quantize_params(model.mmdit, QDTYPES[quant])
    n = cfg.clip_l.max_length
    dev = next(model.parameters()).device
    ids = torch.full((1, n), 49407, dtype=torch.long, device=dev)
    latent = sd3.initial_latent(1, 1, cfg, device=dev, dtype=dtype)
    return Job(model, ids, latent, steps, method, n_params)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=28)
    p.add_argument("--flow-method", choices=["euler", "heun"], default="euler")
    p.add_argument("--quant", choices=["none", "int8", "int4"], default="none")
    p.add_argument("--preset", choices=list(PRESETS), default="sd3")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Runs the benchmark; returns the best seconds per image."""
    args = parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    cfg, label = PRESETS[args.preset]
    t0 = time.monotonic()
    job = build(args.preset, args.quant, steps=args.steps, method=args.flow_method,
                device=device)
    print(f"params: {job.n_params / 1e9:.2f}B, built+uploading {time.monotonic() - t0:.0f}s",
          flush=True)
    if args.quant != "none":
        print(f"mmdit weights quantized: {args.quant}", flush=True)
    t0 = time.monotonic()
    for _ in range(2):
        job.image()
    _sync(device)
    print(f"warmup {time.monotonic() - t0:.0f}s", flush=True)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        job.image()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    print(f"{label} {cfg.height}x{cfg.width} {args.steps}-step flow-CFG b=1 "
          f"quant={args.quant}: {best:.3f}s ({1 / best:.4f} img/s/chip, "
          f"{best / args.steps * 1e3:.1f} ms/step)", flush=True)
    return best


if __name__ == "__main__":
    main()
