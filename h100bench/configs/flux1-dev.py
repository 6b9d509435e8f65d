"""FLUX.1-dev (configs/flux1-dev.json): the port's model with the
benchmark's seeded weights, the plain reference with the same weights,
and the work of each stage for the analytic counts.

The seeded draw is one 34 GB buffer; the port's model is built on the
meta device and takes views of it (``assign=True``), so that set-up
holds one copy of the weights, not two; a view that does not start on a
16-byte boundary (the VAE's, behind a 3-wide bias) is copied, as the
library's kernels read aligned weights.

T5's q projections are drawn at its checkpoint's init, (d_model ·
d_kv)^-1/2, on both sides: lib/weights.py draws every linear at
d_model^-1/2, and T5's attention is not scaled by 1/sqrt(d_kv), so its
logits would have a std of sqrt(d_kv) = 8; a softmax that sharp turns a
rounding into a different attention pattern, and after 24 layers the
states of any two computations would share nothing."""
from __future__ import annotations

import torch

from h100bench.counts import flops, flux as flux_counts
from h100bench.lib import weights
from h100bench.reference import flux_pipeline
from h100bench.reference.pipelines import DTYPES


def spec(cfg):
    return flux_pipeline.spec(cfg)


def _weights(cfg, seed: int, device, dtype):
    """The seeded draw, T5's q projections scaled to its checkpoint's init."""
    W = weights.make(spec(cfg), seed, device, dtype)
    with torch.no_grad():
        for i in range(cfg["t5"]["num_layers"]):
            W[f"t5.layers.{i}.attn.q.weight"].mul_(cfg["t5"]["head_dim"] ** -0.5)
    return W


def port_config(cfg):
    from tinyfusers_tpu_torch.models import clip, flux, t5, vae
    from tinyfusers_tpu_torch.pipeline import flux as pipe

    m = dict(cfg["transformer"], axes_dims_rope=tuple(cfg["transformer"]["axes_dims_rope"]))
    if not m.pop("guidance_embeds"):
        raise ValueError("the port's FLUX embeds a guidance scale (FLUX.1-dev): "
                         "guidance_embeds must be true")
    v = dict(cfg["vae"], channel_mult=tuple(cfg["vae"]["channel_mult"]))
    return pipe.FluxPipelineConfig(clip=clip.CLIPConfig(**cfg["clip"]), t5=t5.T5Config(**cfg["t5"]),
                                   transformer=flux.FluxConfig(**m), vae=vae.VAEConfig(**v),
                                   max_sequence_length=cfg["max_sequence_length"],
                                   height=cfg["height"], width=cfg["width"])


def build(cfg, seed: int, device):
    """The port's pipeline.flux.Flux holding the seeded weights."""
    from tinyfusers_tpu_torch.pipeline import flux as pipe

    dtype = DTYPES[cfg["dtype"]]
    model = pipe.Flux(port_config(cfg), device="meta", dtype=dtype)
    model.load_state_dict(_weights(cfg, seed, device, dtype), strict=True, assign=True)
    for p in model.parameters():
        if p.data_ptr() % 16:
            p.data = p.data.clone()
    return model


def reference(cfg, seed: int, device, prec: str = "fp32"):
    return flux_pipeline.Reference(cfg, _weights(cfg, seed, device, DTYPES[cfg["dtype"]]), prec)


def latent_hw(cfg):
    f = 2 ** (len(cfg["vae"]["channel_mult"]) - 2)
    return cfg["height"] // f, cfg["width"] // f


def work(cfg, kind: str, n: int):
    """(FLOPs, kernel calls) of one stage: "denoise" (one transformer
    forward on n images), "decode" (n images), "encode" (n prompts through
    CLIP and T5)."""
    h, w = latent_hw(cfg)
    t, item = cfg["max_sequence_length"], DTYPES[cfg["dtype"]].itemsize
    if kind == "denoise":
        m = cfg["transformer"]
        return (flux_counts.flux_flops(m, h, w, n, t), flux_counts.flux_calls(m, h, w, n, t, item))
    if kind == "decode":
        return (flops.vae_decode_flops(cfg["vae"], h, w, n),
                flops.vae_decode_calls(cfg["vae"], h, w, n, item))
    if kind == "encode":
        return flops.clip_flops(cfg["clip"], n) + flux_counts.t5_flops(cfg["t5"], n, t), []
    raise ValueError(kind)
