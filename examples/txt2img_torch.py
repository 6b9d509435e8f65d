"""Text-to-image CLI of the PyTorch + CUDA port (tinyfusers_tpu_torch): the
counterpart of examples/txt2img.py.

    python examples/txt2img_torch.py --preset tiny --cpu --dtype float32 \\
        --steps 4 --out /tmp/t.png
    python examples/txt2img_torch.py --preset sd21-v --ckpt sd21v.safetensors \\
        --sampler dpmpp_2m --schedule karras --cfg-rescale 0.7 --timing
    python examples/txt2img_torch.py --preset tinyxl --cpu --dtype float32 \\
        --steps 4 --out /tmp/xl.png

Tokenize (CLIP BPE with "(word:1.2)" emphasis) -> CLIP on the prompt and
the negative prompt -> the sampler loop over the UNet -> VAE decode ->
PNG (or .npy without PIL). It runs on the GPU unless --cpu is given, and
raises without one. Weights: --ckpt loads an SD1.x / SD2.x checkpoint,
or an SDXL one with --preset sdxl / tinyxl (.safetensors or torch-zip
.ckpt); without it, seeded random weights are made on the device (their
images are noise). Options, as the JAX CLI's:
ControlNet (--control-ckpt, --control-image, --control-scale), DeepCache
(--deepcache-interval, --deepcache-split), FreeU (--freeu), textual
inversion (--ti WORD=PATH, repeatable) and the hires fix (--hires-scale,
--hires-strength).

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
# the SDXL presets: configs of pipeline/sdxl.py
XL_PRESETS = {"sdxl": "SDXL_BASE", "tinyxl": "TINY_XL"}


XL_REFUSED = ("--ti/--control-ckpt/--no-cfg are SD1.x/2.x-pipeline features; "
              "not wired into the SDXL CLI path yet")
HIRES_REFUSED = ("--hires-scale composes with samplers/schedules/cached CFG; "
                 "control/prompt-weights/DeepCache are not wired into the hires path yet")


def _parser() -> argparse.ArgumentParser:
    from tinyfusers_tpu_torch.pipeline.samplers import SAMPLERS, SCHEDULES

    p = argparse.ArgumentParser(description="tinyfusers text-to-image (PyTorch port)")
    p.add_argument("--prompt", default="a horse sized cat eating a bagel")
    p.add_argument("--negative-prompt", default="")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--guidance", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default="rendered.png")
    p.add_argument("--ckpt", default=None, help="SD1.x / SD2.x / SDXL .safetensors or .ckpt")
    p.add_argument("--fallback-tokenizer", action="store_true",
                   help="allow the byte-level tokenizer even with --ckpt (only for "
                        "synthetic weights: its ids are not CLIP's)")
    p.add_argument("--preset", choices=[*PRESETS, *XL_PRESETS], default="sd15",
                   help="tiny / tinyxl = toy configs for smoke tests; sd15-quarter = SD1.5 "
                        "at a quarter of its channels")
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
    p.add_argument("--deepcache-interval", type=int, default=1,
                   help=">1: DeepCache (full UNet every k steps)")
    p.add_argument("--deepcache-split", type=int, default=3,
                   help="shallow blocks kept per side when DeepCache is on")
    p.add_argument("--control-ckpt", default=None,
                   help="ControlNet checkpoint (control_model.* layout)")
    p.add_argument("--control-image", default=None,
                   help="hint image (edges/depth/pose), resized to 8x the latent grid")
    p.add_argument("--control-scale", type=float, default=1.0)
    p.add_argument("--ti", action="append", default=[], metavar="WORD=PATH",
                   help="textual-inversion embedding: placeholder word = embedding file "
                        "(.pt/.safetensors); repeatable")
    p.add_argument("--freeu", default=None, metavar="B1,B2,S1,S2",
                   help="FreeU backbone/skip reweighting (Si et al. 2023), e.g. "
                        "1.5,1.6,0.9,0.2 for SD1.5")
    p.add_argument("--hires-scale", type=int, default=1,
                   help=">1: hires-fix — sample at base res, latent-upscale by this "
                        "factor, denoise the tail at high res")
    p.add_argument("--hires-strength", type=float, default=0.6,
                   help="denoising strength of the hires tail pass")
    p.add_argument("--no-cfg", action="store_true",
                   help="sample without guidance (distilled checkpoints; UNet batch B)")
    p.add_argument("--timing", action="store_true")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The arguments, with --freeu as a tuple of 4 floats (or None). The
    JAX CLI's refusals exit here, in its order: --ti, --control-ckpt and
    --no-cfg on the SDXL presets, a malformed --freeu, then (SD1.x / SD2.x
    only) hires with ControlNet or DeepCache (hires with prompt weights in
    ``build``). As in the JAX CLI, the SDXL presets ignore the hires,
    DeepCache and --control-image flags and read no prompt weights."""
    p = _parser()
    args = p.parse_args(argv)
    args.xl = args.preset in XL_PRESETS
    if args.xl and (args.ti or args.control_ckpt or args.no_cfg):
        raise SystemExit(XL_REFUSED)
    args.freeu = (tuple(float(v) for v in args.freeu.split(","))
                  if args.freeu else None)
    if args.freeu is not None and len(args.freeu) != 4:
        p.error("--freeu needs exactly 4 comma-separated floats")
    if (not args.xl and args.hires_scale > 1
            and (args.control_ckpt or args.deepcache_interval > 1)):
        p.error(HIRES_REFUSED)
    return args


@dataclass
class Job:
    """A loaded model and its inputs: ``image()`` makes the images as
    ``sd.generate`` (or, with --hires-scale, ``sd.generate_hires``) does,
    ``latents()`` the sampled latents alone. ``control`` is (controlnet,
    hint, scale) or None."""
    model: object
    ids: object
    uids: object
    weights: object
    latent: object
    args: argparse.Namespace
    control: object = None

    def _generator(self, always: bool = False):
        import torch

        # the noise (ancestral samplers; the hires re-noising), seeded anew
        # for every image
        if not always and "ancestral" not in self.args.sampler:
            return None
        return torch.Generator(device=self.latent.device).manual_seed(self.args.seed + 1)

    def _sampling(self):
        a = self.args
        return dict(num_steps=a.steps, method=a.sampler, schedule=a.schedule,
                    generator=self._generator(), uncond_interval=a.uncond_interval,
                    cfg_rescale=a.cfg_rescale, freeu=a.freeu)

    def _extras(self):
        a = self.args
        return dict(deepcache_interval=a.deepcache_interval,
                    deepcache_split=a.deepcache_split, control=self.control)

    def image(self):
        from tinyfusers_tpu_torch.pipeline import sd

        a = self.args
        if a.hires_scale > 1:
            kw = self._sampling()
            del kw["generator"]  # the hires fix always draws (its re-noising)
            return sd.generate_hires(self.model, self.ids, self.uids, self.latent,
                                     self._generator(always=True), a.guidance,
                                     hires_scale=a.hires_scale,
                                     hires_strength=a.hires_strength, **kw)
        return sd.generate(self.model, self.ids, self.uids, self.latent, a.guidance,
                           prompt_weights=self.weights, **self._sampling(), **self._extras())

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
                                     **self._sampling(), **self._extras())


@dataclass
class XLJob:
    """A loaded StableDiffusionXL and its inputs: both towers' ids of the
    prompt and of the negative prompt; ``image()`` makes the images as
    ``sdxl.generate`` does, ``latents()`` the sampled latents alone."""
    model: object
    ids_l: object
    ids_g: object
    uids_l: object
    uids_g: object
    latent: object
    args: argparse.Namespace

    _generator = Job._generator
    _sampling = Job._sampling

    def image(self):
        from tinyfusers_tpu_torch.pipeline import sdxl

        return sdxl.generate(self.model, self.ids_l, self.ids_g, self.uids_l, self.uids_g,
                             self.latent, self.args.guidance, **self._sampling())

    def latents(self):
        import torch

        from tinyfusers_tpu_torch.pipeline import sdxl

        with torch.inference_mode():
            dt = self.latent.dtype
            cond = sdxl.conditioning(self.model, self.ids_l, self.ids_g, dt)
            uncond = sdxl.conditioning(self.model, self.uids_l, self.uids_g, dt)
            return sdxl.sample_latents(self.model.unet, self.latent, cond, uncond,
                                       self.args.guidance, **self._sampling())


def _load(args, dev, dtype):
    """The model of the preset: from --ckpt, or seeded random weights;
    the UNet quantized under --quant (after loading, as the JAX CLI does)."""
    import torch

    from tinyfusers_tpu_torch.io import checkpoints
    from tinyfusers_tpu_torch.pipeline import sd, sdxl

    t0 = time.monotonic()
    pipe, name = (sdxl, XL_PRESETS[args.preset]) if args.xl else (sd, PRESETS[args.preset])
    cfg = getattr(pipe, name)
    if args.ckpt:
        load = checkpoints.load_sdxl_params if args.xl else checkpoints.load_sd_params
        model = load(args.ckpt, cfg, device=dev, dtype=dtype)
    else:
        print("no --ckpt given: seeded random weights (noise images)")
        make = sdxl.StableDiffusionXL if args.xl else sd.StableDiffusion
        model = make(cfg, device=dev, dtype=dtype, seed=0)
    if args.quant != "none":
        from tinyfusers_tpu_torch.io.quantize_tree import quantize_params

        qdtype = {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "int4": "int4"}[args.quant]
        quantize_params(model.unet, qdtype)
    print(f"weights ready in {time.monotonic() - t0:.1f}s on {dev}")
    return model


def build(args: argparse.Namespace):
    """Load the weights and tokenize: everything before the first image. A
    Job, or an XLJob on the SDXL presets."""
    import torch

    from tinyfusers_tpu_torch.device import resolve_device
    from tinyfusers_tpu_torch.pipeline import sd, sdxl
    from tinyfusers_tpu_torch.tokenizer import bpe
    from tinyfusers_tpu_torch.tokenizer import prompt_weights as pw

    dev = resolve_device("cpu" if args.cpu else "cuda")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = _load(args, dev, dtype)
    cfg = model.cfg

    # with real weights the byte-level tokenizer would give garbage
    # conditioning: refused unless this is a random-weight run
    tok = bpe.ClipTokenizer.load_default(
        allow_fallback=args.ckpt is None or args.fallback_tokenizer)
    # SD2.x conditions on OpenCLIP, which pads with 0, not EOT; the SDXL
    # presets pad both towers with EOT, as the JAX CLI does
    pad = 0 if args.preset.startswith("sd21") else bpe.EOT

    def batch(row, dt=torch.long):
        return torch.tensor([row] * args.batch, dtype=dt, device=dev)

    if args.xl:
        def ids(text, tower):
            return batch(tok.encode(text, tower.max_length, pad_token=pad))

        latent = sdxl.initial_latent(args.seed, args.batch, cfg, device=dev, dtype=dtype)
        return XLJob(model, ids(args.prompt, cfg.clip_l), ids(args.prompt, cfg.clip_g),
                     ids(args.negative_prompt, cfg.clip_l),
                     ids(args.negative_prompt, cfg.clip_g), latent, args)
    length = cfg.clip.max_length

    ti_ids = None
    if args.ti:
        from tinyfusers_tpu_torch.io import textual_inversion as ti_mod

        embs = {}
        for spec in args.ti:
            word, _, tpath = spec.partition("=")
            embs[word] = ti_mod.load_embedding(tpath)
        ti_ids = ti_mod.extend_clip(model.clip, embs)
    wid, w = pw.encode_weighted(tok, args.prompt, length, pad_token=pad, placeholders=ti_ids)
    weights = batch(w, torch.float32) if any(x != 1.0 for x in w) else None
    if weights is not None and args.hires_scale > 1:
        _parser().error(HIRES_REFUSED)
    uids = None if args.no_cfg else batch(tok.encode(args.negative_prompt, length,
                                                     pad_token=pad))
    latent = sd.initial_latent(args.seed, args.batch, cfg, device=dev, dtype=dtype)
    control = None
    if args.control_ckpt:
        from tinyfusers_tpu_torch.io import checkpoints

        cn = checkpoints.load_controlnet_params(args.control_ckpt, cfg.unet, device=dev,
                                                dtype=dtype)
        hh, ww = latent.shape[1] * 8, latent.shape[2] * 8
        if args.control_image:
            from PIL import Image

            im = Image.open(args.control_image).convert("RGB").resize((ww, hh),
                                                                      Image.LANCZOS)
            hint = torch.tensor(np.asarray(im), dtype=torch.float32, device=dev)[None] / 255.0
        else:
            print("no --control-image: using a zero hint (smoke run)")
            hint = torch.zeros((1, hh, ww, 3), dtype=torch.float32, device=dev)
        control = (cn, hint, args.control_scale)
    return Job(model, batch(wid), uids, weights, latent, args, control)


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
