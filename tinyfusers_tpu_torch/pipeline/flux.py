"""FLUX.1-dev text-to-image pipeline: CLIP-L pooled + T5-XXL states ->
the FLUX transformer under the Euler flow sampler -> the 16-channel VAE.

``Flux`` holds the models as submodules: ``clip`` (CLIP ViT-L, its
pooled vector without a projection), ``t5`` (T5-v1.1-XXL encoder),
``transformer`` (models/flux.py) and ``vae``. The guidance is distilled
into the transformer (``guidance_in``): there is no CFG batch, every
step is one forward at the caller's batch. The Euler flow runs on BFL's
resolution-shifted ladder (``get_schedule``): mu on the line through
(256 tokens, 0.5) and (4096, 1.15), ``time_shift(mu, 1, t) = e^mu /
(e^mu + 1/t - 1)``, which is rectified_flow's shifted ladder with shift
e^mu (3.1582 at 1024², 4,096 image tokens). The T5 states condition
unmasked, padding included, as diffusers' FluxPipeline hands them over.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Union

import torch
from torch import nn

from ..device import resolve_device
from ..models import clip, flux, t5 as t5_model, vae
from ..utils import profiling
from . import rectified_flow as rf

# BFL's get_schedule: mu at 256 and at 4096 image tokens
BASE_SHIFT, MAX_SHIFT = 0.5, 1.15

# FLUX's autoencoder: SD3's 16-channel layout, its own latent scale and shift
FLUX_VAE_CONFIG = vae.VAEConfig(latent_channels=16, scale_factor=0.3611, shift_factor=0.1159,
                                use_quant_conv=False)


@dataclass(frozen=True)
class FluxPipelineConfig:
    clip: clip.CLIPConfig = field(default_factory=lambda: clip.CLIPConfig(projection_dim=0))
    t5: t5_model.T5Config = field(default_factory=lambda: t5_model.T5_XXL)
    transformer: flux.FluxConfig = field(default_factory=lambda: flux.FLUX1_DEV)
    vae: vae.VAEConfig = field(default_factory=lambda: FLUX_VAE_CONFIG)
    max_sequence_length: int = 512   # T5 tokens
    height: int = 1024
    width: int = 1024

    @property
    def latent_shape(self):
        f = self.vae.downsample_factor
        return (self.height // f, self.width // f, self.vae.latent_channels)


FLUX1_DEV_CFG = FluxPipelineConfig()

TINY_FLUX_CFG = FluxPipelineConfig(
    clip=clip.CLIPConfig(vocab_size=128, max_length=8, dim=16, num_layers=2, num_heads=4,
                         mlp_dim=32, projection_dim=0),
    t5=t5_model.T5Config(vocab_size=128, dim=32, ff_dim=64, num_layers=2, num_heads=4,
                         head_dim=8, rel_buckets=8, rel_max_distance=16),
    transformer=flux.TINY_FLUX,
    vae=vae.VAEConfig(base_channels=16, channel_mult=(1, 1, 2), num_groups=8,
                      latent_channels=4, scale_factor=0.3611, shift_factor=0.1159,
                      use_quant_conv=False),
    max_sequence_length=12, height=32, width=32)


class Flux(nn.Module):
    """CLIP-L + T5-XXL + the FLUX transformer + VAE on one device.

    The weights are left empty for a loader (``load_state_dict`` with
    BFL's and the encoders' names). device defaults to "cuda" and raises
    without a GPU; "meta" builds the tree without memory, for
    ``load_state_dict(..., assign=True)``.
    """

    def __init__(self, cfg: FluxPipelineConfig = FLUX1_DEV_CFG, *,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        if cfg.t5.dim != cfg.transformer.joint_attention_dim:
            raise ValueError("t5.dim must equal transformer.joint_attention_dim")
        self.cfg = cfg
        self.clip = clip.CLIPTextModel(cfg.clip, **kw)
        self.t5 = t5_model.T5Encoder(cfg.t5, **kw)
        self.transformer = flux.FluxTransformer(cfg.transformer, **kw)
        self.vae = vae.AutoencoderKL(cfg.vae, **kw)


def shift_for(image_tokens: int) -> float:
    """e^mu of BFL's get_schedule for a sequence of ``image_tokens``."""
    slope = (MAX_SHIFT - BASE_SHIFT) / (4096 - 256)
    return math.exp(BASE_SHIFT + slope * (image_tokens - 256))


def encode_text(model: Flux, clip_ids: torch.Tensor, t5_ids: torch.Tensor):
    """clip_ids (B, 77), t5_ids (B, max_sequence_length) -> (T5 states
    (B, T, joint_attention_dim), CLIP's pooled vector (B, dim))."""
    if t5_ids.shape[-1] != model.cfg.max_sequence_length:
        raise ValueError(f"T5 ids of length {t5_ids.shape[-1]}: pad them to "
                         f"max_sequence_length {model.cfg.max_sequence_length}")
    return t5_model.apply(model.t5, t5_ids), clip.apply_pooled(model.clip, clip_ids)


@torch.inference_mode()
def generate(model: Flux, clip_ids: torch.Tensor, t5_ids: torch.Tensor, latent: torch.Tensor,
             guidance: float = 3.5, num_steps: int = 28) -> torch.Tensor:
    """Tokens + initial noise (B, h, w, C) -> uint8 images (B, H, W, 3).
    Spans: ``generate`` around ``generate.encode`` / ``.denoise`` /
    ``.decode``, as sd3.generate's; the transformer's stacks inside."""
    b, h, w, _ = latent.shape
    with profiling.span("generate"):
        with profiling.span("generate.encode"):
            ctx, pooled = encode_text(model, clip_ids, t5_ids)
            ctx, pooled = ctx.to(latent.dtype), pooled.to(latent.dtype)
        with profiling.span("generate.denoise"):
            g = torch.full((b,), float(guidance), device=latent.device)
            lat = rf.sample(lambda x, t: flux.apply(model.transformer, x, t, ctx, pooled, g),
                            latent, num_steps, shift=shift_for((h // 2) * (w // 2)))
        with profiling.span("generate.decode"):
            return vae.to_image(vae.decode(model.vae, lat))


def initial_latent(seed: int, batch: int, cfg: FluxPipelineConfig = FLUX1_DEV_CFG, *,
                   device: Union[str, torch.device] = "cuda",
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard-normal initial noise (B, h, w, c), drawn on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, *cfg.latent_shape), generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)
