"""Weight-only quantization accuracy harness (the port's counterpart of
benchmarks/quant_eval.py).

    python3 tools/quant_eval_torch.py [--quant int8|fp8|int4] [--ckpt PATH]
        [--steps 20] [--preset sd15|tiny] [--cpu]

The checkpoint-agnostic signal chain of the JAX tool, on the port's
SD1.5 (bf16) or TINY (fp32) model with its UNet quantized by
io/quantize_tree.quantize_params:

  1. eps-prediction error mean|eps_q - eps_dense| / mean|eps_dense| at
     t = 981, 501 and 21 (one UNet call each, the same latent and context);
  2. end to end: one ``--steps``-step DDIM CFG 7.5 image dense and one
     quantized from the same latent and ids, and between the two the image
     PSNR, the largest pixel change and the share of pixels changed.

With real weights (``--ckpt``, an SD1.x file) these numbers bound the
CLIP / FID drift; with random weights they regression-test the quantized
path end to end. Without ``--ckpt`` the weights are the port's seeded
init (``StableDiffusion(seed=0)``: the JAX init's distributions drawn by
a torch.Generator on the device), since the JAX tool's fill lives in
bench.py, which imports jax. The latent is ``sd.initial_latent(1, ...)``
and the context a seeded normal draw (seed 2), not jax.random's. Runs on
the GPU unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tinyfusers_tpu_torch.io import quantize_tree  # noqa: E402
from tinyfusers_tpu_torch.io.quantize_tree import QDTYPES  # noqa: E402
from tinyfusers_tpu_torch.models import unet as unet_model  # noqa: E402
from tinyfusers_tpu_torch.pipeline import sd  # noqa: E402

TIMESTEPS = (981, 501, 21)
GUIDANCE = 7.5


def psnr(a: np.ndarray, b: np.ndarray, peak: float) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / mse)


def quantized_copy(model: sd.StableDiffusion, quant: str) -> sd.StableDiffusion:
    """The model with a quantized copy of its UNet, sharing the CLIP and
    VAE modules (the JAX tool's {**params, "unet": quantize_params(...)})."""
    return quantize_tree.quantized_copy(model, QDTYPES[quant])


@torch.inference_mode()
def evaluate(model: sd.StableDiffusion, qmodel: sd.StableDiffusion, latent: torch.Tensor,
             ctx: torch.Tensor, ids: torch.Tensor, steps: int) -> Dict[str, object]:
    """The harness's numbers: eps error by timestep, then the two images
    and what changed between them."""
    eps = {}
    for t in TIMESTEPS:
        tt = torch.full((latent.shape[0],), float(t), device=latent.device)
        e_d = unet_model.apply(model.unet, latent, tt, ctx).float()
        e_q = unet_model.apply(qmodel.unet, latent, tt, ctx).float()
        eps[t] = ((e_q - e_d).abs().mean() / e_d.abs().mean().clamp_min(1e-9)).item()
    img_d = sd.generate(model, ids, ids, latent, GUIDANCE, num_steps=steps).cpu().numpy()
    img_q = sd.generate(qmodel, ids, ids, latent, GUIDANCE, num_steps=steps).cpu().numpy()
    return {"eps_rel": eps, "images": (img_d, img_q), "psnr": psnr(img_d, img_q, 255.0),
            "max_pixel_delta": int(np.abs(img_d.astype(int) - img_q.astype(int)).max()),
            "changed": float((img_d != img_q).mean())}


def report(out: Dict[str, object], quant: str, steps: int) -> None:
    """Prints the numbers as the JAX tool prints them."""
    print(f"== eps-prediction error ({quant}, per-channel weight-only)")
    for t, rel in out["eps_rel"].items():
        print(f"  t={t:4d}: mean|Δeps|/mean|eps| = {rel:.4f}")
    print(f"== end-to-end ({steps} steps)")
    print(f"  image PSNR: {out['psnr']:.2f} dB")
    print(f"  max |Δpixel|: {out['max_pixel_delta']}")
    print(f"  changed pixels: {out['changed'] * 100:.2f}%")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quant", choices=list(QDTYPES), default="int8")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--preset", choices=["sd15", "tiny"], default="sd15")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Runs the harness and prints its report; returns its numbers."""
    args = parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    cfg = sd.SD15 if args.preset == "sd15" else sd.TINY
    dtype = torch.bfloat16 if args.preset == "sd15" else torch.float32
    if args.ckpt:
        from tinyfusers_tpu_torch.io import checkpoints

        model = checkpoints.load_sd_params(args.ckpt, cfg, device=device, dtype=dtype)
    else:
        model = sd.StableDiffusion(cfg, device=device, dtype=dtype, seed=0)
    dev = next(model.parameters()).device
    latent = sd.initial_latent(1, 1, cfg, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(2)
    ctx = torch.randn((1, cfg.clip.max_length, cfg.unet.context_dim), generator=gen,
                      device=dev).to(dtype)
    ids = torch.full((1, cfg.clip.max_length), 49407 % cfg.clip.vocab_size, dtype=torch.long,
                     device=dev)
    out = evaluate(model, quantized_copy(model, args.quant), latent, ctx, ids, args.steps)
    report(out, args.quant, args.steps)
    return out


if __name__ == "__main__":
    main()
