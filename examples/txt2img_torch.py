"""Text-to-image CLI of the PyTorch + CUDA port (tinyfusers_tpu_torch): the
counterpart of examples/txt2img.py.

    python examples/txt2img_torch.py --preset tiny --cpu --dtype float32 \\
        --steps 4 --out /tmp/t.png
    python examples/txt2img_torch.py --preset sd21-v --ckpt sd21v.safetensors \\
        --sampler dpmpp_2m --schedule karras --cfg-rescale 0.7 --timing

Tokenize (CLIP BPE with "(word:1.2)" emphasis) -> CLIP on the prompt and
the negative prompt -> the sampler loop over the UNet -> VAE decode ->
PNG (or .npy without PIL). It runs on the GPU unless --cpu is given, and
raises without one. Weights: --ckpt loads an SD1.x / SD2.x checkpoint
(.safetensors or torch-zip .ckpt); without it, seeded random weights are
made on the device (their images are noise).

``main(argv)`` returns the first image as a uint8 array; ``build(args)``
gives the loaded job without running it, so that a caller in the same
process (chip_smoke.py, the tests) can time its images and read the
kernels' launch counts.
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PRESETS = {"sd15": "SD15", "sd15-quarter": "SD15_QUARTER", "sd21-base": "SD21_BASE",
           "sd21-v": "SD21_V", "tiny": "TINY"}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    from tinyfusers_tpu_torch.pipeline.samplers import SAMPLERS, SCHEDULES

    p = argparse.ArgumentParser(description="tinyfusers text-to-image (PyTorch port)")
    p.add_argument("--prompt", default="a horse sized cat eating a bagel")
    p.add_argument("--negative-prompt", default="")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--guidance", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default="rendered.png")
    p.add_argument("--ckpt", default=None, help="SD1.x / SD2.x .safetensors or .ckpt")
    p.add_argument("--fallback-tokenizer", action="store_true",
                   help="allow the byte-level tokenizer even with --ckpt (only for "
                        "synthetic weights: its ids are not CLIP's)")
    p.add_argument("--preset", choices=list(PRESETS), default="sd15",
                   help="tiny = toy config for smoke tests; sd15-quarter = SD1.5 at a "
                        "quarter of its channels")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    p.add_argument("--quant", choices=["none", "int8", "fp8", "int4"], default="none",
                   help="weight-only quantization of the UNet")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--sampler", choices=list(SAMPLERS), default="ddim")
    p.add_argument("--schedule", choices=list(SCHEDULES), default="ladder",
                   help="sigma spacing of the sigma-space samplers (karras: rho = 7)")
    p.add_argument("--uncond-interval", type=int, default=1,
                   help=">1: cached CFG (the uncond output every k-th network call)")
    p.add_argument("--cfg-rescale", type=float, default=0.0,
                   help="guidance rescale phi (Lin et al. 2023); ~0.7 for v models")
    p.add_argument("--no-cfg", action="store_true",
                   help="sample without guidance (distilled checkpoints; UNet batch B)")
    p.add_argument("--timing", action="store_true")
    return p.parse_args(argv)


@dataclass
class Job:
    """A loaded model and its inputs: ``image()`` makes the images as
    ``sd.generate`` does, ``latents()`` the sampled latents alone."""
    model: object
    ids: object
    uids: object
    weights: object
    latent: object
    args: argparse.Namespace

    def _generator(self):
        import torch

        # the ancestral samplers' noise, seeded anew for every image
        if "ancestral" not in self.args.sampler:
            return None
        return torch.Generator(device=self.latent.device).manual_seed(self.args.seed + 1)

    def _sampling(self):
        a = self.args
        return dict(num_steps=a.steps, method=a.sampler, schedule=a.schedule,
                    generator=self._generator(), uncond_interval=a.uncond_interval,
                    cfg_rescale=a.cfg_rescale)

    def image(self):
        from tinyfusers_tpu_torch.pipeline import sd

        return sd.generate(self.model, self.ids, self.uids, self.latent, self.args.guidance,
                           prompt_weights=self.weights, **self._sampling())

    def latents(self):
        import torch

        from tinyfusers_tpu_torch.pipeline import sd

        with torch.inference_mode():
            ctx = sd.encode_text(self.model, self.ids)
            uctx = None if self.uids is None else sd.encode_text(self.model, self.uids)
            if self.weights is not None:
                ctx = sd.apply_prompt_weights(ctx, self.weights)
            return sd.sample_latents(self.model.unet, self.latent, ctx, uctx,
                                     guidance=self.args.guidance, cfg=self.model.cfg,
                                     **self._sampling())


def build(args: argparse.Namespace) -> Job:
    """Load the weights and tokenize: everything before the first image."""
    import torch

    from tinyfusers_tpu_torch.device import resolve_device
    from tinyfusers_tpu_torch.pipeline import sd
    from tinyfusers_tpu_torch.tokenizer import bpe
    from tinyfusers_tpu_torch.tokenizer import prompt_weights as pw

    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = getattr(sd, PRESETS[args.preset])
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    t0 = time.monotonic()
    if args.ckpt:
        from tinyfusers_tpu_torch.io import checkpoints

        model = checkpoints.load_sd_params(args.ckpt, cfg, device=dev, dtype=dtype)
    else:
        print("no --ckpt given: seeded random weights (noise images)")
        model = sd.StableDiffusion(cfg, device=dev, dtype=dtype, seed=0)
    if args.quant != "none":
        from tinyfusers_tpu_torch.io.quantize_tree import quantize_params

        qdtype = {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "int4": "int4"}[args.quant]
        quantize_params(model.unet, qdtype)
    print(f"weights ready in {time.monotonic() - t0:.1f}s on {dev}")

    # with real weights the byte-level tokenizer would give garbage
    # conditioning: refused unless this is a random-weight run
    tok = bpe.ClipTokenizer.load_default(
        allow_fallback=args.ckpt is None or args.fallback_tokenizer)
    # SD2.x conditions on OpenCLIP, which pads with 0, not EOT
    pad = 0 if args.preset.startswith("sd21") else bpe.EOT
    length = cfg.clip.max_length

    def batch(row, dt=torch.long):
        return torch.tensor([row] * args.batch, dtype=dt, device=dev)

    wid, w = pw.encode_weighted(tok, args.prompt, length, pad_token=pad)
    weights = batch(w, torch.float32) if any(x != 1.0 for x in w) else None
    uids = None if args.no_cfg else batch(tok.encode(args.negative_prompt, length,
                                                     pad_token=pad))
    latent = sd.initial_latent(args.seed, args.batch, cfg, device=dev, dtype=dtype)
    return Job(model, batch(wid), uids, weights, latent, args)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def save(arr: np.ndarray, out: str) -> None:
    try:
        from PIL import Image
    except ImportError:
        np.save(out + ".npy", arr)
        print(f"PIL unavailable; wrote the raw array to {out}.npy")
        return
    Image.fromarray(arr).save(out)


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Run the CLI; returns the first image, uint8 (H, W, 3)."""
    args = parse_args(argv)
    job = build(args)
    dev = job.latent.device
    t0 = time.monotonic()
    img = job.image()
    _sync(dev)
    first = time.monotonic() - t0
    if args.timing:
        t0 = time.monotonic()
        img = job.image()
        _sync(dev)
        steady = time.monotonic() - t0
        print(f"first image (kernel builds included): {first:.2f}s; steady state: "
              f"{steady:.2f}s ({args.steps / steady:.2f} steps/s, "
              f"{args.batch / steady:.3f} images/s)")
    else:
        print(f"generated in {first:.2f}s")
    arr = img[0].cpu().numpy()
    save(arr, args.out)
    print(f"saved {args.out} ({arr.shape[0]}x{arr.shape[1]})")
    return arr


if __name__ == "__main__":
    main()
