"""Stable Diffusion text-to-image pipeline (port of
tinyfusers_tpu/pipeline/sd.py).

``StableDiffusion`` holds the three models as submodules named after the
JAX param tree ("clip", "unet", "vae"). ``generate`` runs CLIP on the
prompt and the empty prompt, the CFG + DDIM loop with the UNet on the
cond+uncond batch of 2B, the VAE decode and the uint8 conversion.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import torch
from torch import nn

from ..device import resolve_device
from ..models import clip, unet, vae
from ..models.layers import init_weights
from . import ddim, samplers


@dataclass(frozen=True)
class SDConfig:
    clip: clip.CLIPConfig = field(default_factory=clip.CLIPConfig)
    unet: unet.UNetConfig = field(default_factory=lambda: unet.SD15_CONFIG)
    vae: vae.VAEConfig = field(default_factory=lambda: vae.SD_VAE_CONFIG)
    height: int = 512
    width: int = 512
    clip_skip_layers: int = 0
    clip_final_norm_on_skip: bool = False

    @property
    def latent_shape(self):
        f = self.vae.downsample_factor
        return (self.height // f, self.width // f, self.vae.latent_channels)


SD15 = SDConfig()

# Tiny end-to-end config for tests: same code paths, toy sizes.
TINY = SDConfig(
    clip=clip.CLIPConfig(vocab_size=128, max_length=16, dim=32, num_layers=2,
                         num_heads=4, mlp_dim=64),
    unet=unet.UNetConfig(model_channels=32, channel_mult=(1, 2),
                         attention_levels=(0, 1), context_dim=32,
                         num_heads=4, num_groups=8),
    vae=vae.TINY_VAE_CONFIG,
    height=32,
    width=32,
)


class StableDiffusion(nn.Module):
    """CLIP + UNet + VAE decoder on one device.

    device defaults to "cuda" and raises without a GPU. seed fills the
    weights with the JAX package's init distributions, drawn on the
    device; seed=None leaves them empty for a loader (io/from_jax.py).
    """

    def __init__(self, cfg: SDConfig = SD15, *,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32, seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.clip = clip.CLIPTextModel(cfg.clip, device=dev, dtype=dtype)
        self.unet = unet.UNet(cfg.unet, device=dev, dtype=dtype)
        self.vae = vae.AutoencoderKL(cfg.vae, device=dev, dtype=dtype)
        if seed is not None:
            init_weights(self, seed)


def encode_text(model: StableDiffusion, input_ids: torch.Tensor) -> torch.Tensor:
    """Token ids (B, T) -> conditioning context (B, T, dim)."""
    cfg = model.cfg
    return clip.apply(model.clip, input_ids,
                      skip_final_norm_layers=cfg.clip_skip_layers,
                      final_norm_on_skip=cfg.clip_final_norm_on_skip)


def denoise_step(unet_model: unet.UNet, latent, timestep, context2, guidance,
                 a_t, a_prev) -> torch.Tensor:
    """One CFG + DDIM update. latent (B, h, w, c); context2 (2B, S, D) =
    [uncond ‖ cond]; timestep, a_t, a_prev scalars."""
    b = latent.shape[0]
    lat2 = torch.cat([latent, latent], dim=0)
    t2 = torch.as_tensor(timestep, dtype=torch.float32,
                         device=latent.device).expand(2 * b)
    out = unet.apply(unet_model, lat2, t2, context2)
    e_t = ddim.cfg_combine(out[:b], out[b:], guidance)
    return ddim.ddim_step(latent, e_t, a_t, a_prev)


def sample_latents(unet_model: unet.UNet, latent: torch.Tensor,
                   context: torch.Tensor, uncond_context: torch.Tensor, *,
                   num_steps: int, guidance, method: str = "ddim") -> torch.Tensor:
    """Classifier-free-guided sampling: one UNet call on the batch of 2B
    ([uncond ‖ cond]) per step, combined with ``guidance``."""
    b = latent.shape[0]
    context2 = torch.cat([uncond_context, context], dim=0)
    g = torch.as_tensor(guidance, dtype=torch.float32, device=latent.device)

    def model_fn(lat, t):
        out = unet.apply(unet_model, torch.cat([lat, lat], dim=0),
                         t.expand(2 * b), context2)
        return ddim.cfg_combine(out[:b], out[b:], g)

    return samplers.sample(model_fn, latent, num_steps, method=method)


@torch.inference_mode()
def generate(model: StableDiffusion, input_ids: torch.Tensor,
             uncond_ids: torch.Tensor, latent: torch.Tensor, guidance, *,
             num_steps: int = 20, method: str = "ddim") -> torch.Tensor:
    """Tokens + initial noise -> uint8 images (B, H, W, 3)."""
    ctx = encode_text(model, input_ids)
    uctx = encode_text(model, uncond_ids)
    lat = sample_latents(model.unet, latent, ctx, uctx, num_steps=num_steps,
                         guidance=guidance, method=method)
    return vae.to_image(vae.decode(model.vae, lat))


def initial_latent(seed: int, batch: int, cfg: SDConfig = SD15, *,
                   device: Union[str, torch.device] = "cuda",
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard-normal initial noise (B, h, w, c), drawn on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, *cfg.latent_shape), generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)
