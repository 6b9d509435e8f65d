"""Stable Diffusion text-to-image pipeline (port of
tinyfusers_tpu/pipeline/sd.py): SD1.x and SD2.x, epsilon and v
prediction.

``StableDiffusion`` holds the three models as submodules named after the
JAX param tree ("clip", "unet", "vae"). ``generate`` runs CLIP on the
prompt and the negative prompt, the sampler loop (pipeline/samplers.py)
with the UNet on the cond+uncond batch of 2B (or on B alone without
guidance, or the two branches apart under cached CFG), the VAE decode and
the uint8 conversion. DeepCache, FreeU, ControlNet, hires, img2img and
inpainting are not ported yet.
"""
from __future__ import annotations

import functools
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
    # "epsilon" (SD1.x, SD2.x-base) or "v" (SD2.x 768-v: converted to eps
    # right after CFG)
    prediction_type: str = "epsilon"
    # text conditioning taps k layers before the end ("clip skip"); SD2.x
    # also runs the final layer norm on that state
    clip_skip_layers: int = 0
    clip_final_norm_on_skip: bool = False

    @property
    def latent_shape(self):
        f = self.vae.downsample_factor
        return (self.height // f, self.width // f, self.vae.latent_channels)


SD15 = SDConfig()

# SD 2.1-base (512, epsilon) and SD 2.1 (768, v-prediction): OpenCLIP-H
# penultimate-layer conditioning, 64-wide attention heads in the UNet.
SD21_BASE = SDConfig(
    clip=clip.OPENCLIP_H_CONFIG,
    unet=unet.SD21_CONFIG,
    clip_skip_layers=1,
    clip_final_norm_on_skip=True,
)
SD21_V = SDConfig(
    clip=clip.OPENCLIP_H_CONFIG,
    unet=unet.SD21_CONFIG,
    height=768,
    width=768,
    prediction_type="v",
    clip_skip_layers=1,
    clip_final_norm_on_skip=True,
)

# SD1.5 at a quarter of its channels: the real 4-level topology, attention
# levels, GN32 grouping and CLIP / VAE structure.
SD15_QUARTER = SDConfig(
    clip=clip.CLIPConfig(vocab_size=1024, max_length=77, dim=256,
                         num_layers=4, num_heads=8, mlp_dim=1024),
    unet=unet.UNetConfig(model_channels=128, channel_mult=(1, 2, 4, 4),
                         attention_levels=(0, 1, 2), context_dim=256,
                         num_heads=8, num_groups=32),
    vae=vae.VAEConfig(base_channels=64, channel_mult=(1, 1, 2, 4, 4)),
    height=256,
    width=256,
)

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


@functools.lru_cache(maxsize=None)
def _alphas_cumprod_on(device: torch.device) -> torch.Tensor:
    return ddim.alphas_cumprod(device=device)


def model_out_to_eps(out: torch.Tensor, latent: torch.Tensor, timestep,
                     cfg: SDConfig) -> torch.Tensor:
    """The UNet output as an epsilon prediction: the identity for epsilon
    models; for v models eps = sqrt(a_t) v + sqrt(1 - a_t) x_t, in fp32,
    cast to out's dtype. a_t is alphas_cumprod at t rounded to an integer
    (half to even), also at the continuous timesteps of the Karras
    schedule, as the JAX package does (ADVICE.md)."""
    if cfg.prediction_type == "epsilon":
        return out
    if cfg.prediction_type != "v":
        raise ValueError(f"unknown prediction_type {cfg.prediction_type!r}")
    acp = _alphas_cumprod_on(out.device)
    t = torch.as_tensor(timestep, dtype=torch.float32, device=out.device)
    a_t = acp[torch.round(t).long()]
    while a_t.ndim < out.ndim:  # per-batch timesteps broadcast over HWC
        a_t = a_t[..., None]
    eps = torch.sqrt(a_t) * out.float() + torch.sqrt(1.0 - a_t) * latent.float()
    return eps.to(out.dtype)


def apply_prompt_weights(context: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Each token's hidden state scaled about the sequence mean:
    h_i <- mean + (h_i - mean) * w_i. context (B, T, D), weights (B, T)."""
    mean = context.mean(dim=1, keepdim=True)
    return mean + (context - mean) * weights[..., None].to(context.dtype)


def denoise_step(unet_model: unet.UNet, latent, timestep, context2, guidance,
                 a_t, a_prev, cfg: SDConfig = SD15) -> torch.Tensor:
    """One CFG + DDIM update. latent (B, h, w, c); context2 (2B, S, D) =
    [uncond ‖ cond]; timestep, a_t, a_prev scalars."""
    b = latent.shape[0]
    lat2 = torch.cat([latent, latent], dim=0)
    t2 = torch.as_tensor(timestep, dtype=torch.float32,
                         device=latent.device).expand(2 * b)
    out = unet.apply(unet_model, lat2, t2, context2)
    o_t = ddim.cfg_combine(out[:b], out[b:], guidance)
    e_t = model_out_to_eps(o_t, latent, timestep, cfg)
    return ddim.ddim_step(latent, e_t, a_t, a_prev)


def sample_latents(unet_model: unet.UNet, latent: torch.Tensor,
                   context: torch.Tensor, uncond_context: Optional[torch.Tensor], *,
                   num_steps: int, guidance, cfg: SDConfig = SD15,
                   method: str = "ddim", schedule: str = "ladder",
                   start_index: int = 0, generator: Optional[torch.Generator] = None,
                   uncond_interval: int = 1, cfg_rescale: float = 0.0) -> torch.Tensor:
    """Sampling with classifier-free guidance: one UNet call on the batch of
    2B ([uncond ‖ cond]) per network call, combined with ``guidance``.

    method, schedule, start_index, generator: pipeline/samplers.py.
    uncond_context=None samples without guidance (distilled checkpoints, or
    guidance 1): the UNet runs on B alone and ``guidance`` is unused.
    uncond_interval k > 1 is cached CFG: the unconditional output is
    recomputed every k-th network call and reused in between (under every
    sampler; for the 2-call samplers k counts calls); approximate.
    cfg_rescale > 0 rescales the guided output (ddim.cfg_rescale) in
    model-output space, before the v -> eps step."""
    if uncond_context is None and uncond_interval > 1:
        raise ValueError(
            "guidance-free sampling (uncond_context=None) does not compose with "
            "cached CFG (uncond_interval > 1): there is no uncond branch to cache")
    b = latent.shape[0]
    g = torch.as_tensor(guidance, dtype=torch.float32, device=latent.device)
    run = functools.partial(samplers.sample, latent=latent, num_steps=num_steps,
                            method=method, schedule=schedule, start_index=start_index,
                            generator=generator)

    def combine(o_u, o_c):
        o = ddim.cfg_combine(o_u, o_c, g)
        return ddim.cfg_rescale(o, o_c, cfg_rescale) if cfg_rescale > 0.0 else o

    if uncond_context is None:
        def model_fn(lat, t):
            out = unet.apply(unet_model, lat, t.expand(b), context)
            return model_out_to_eps(out, lat, t, cfg)

        return run(model_fn)

    if uncond_interval <= 1:
        context2 = torch.cat([uncond_context, context], dim=0)

        def model_fn(lat, t):
            out = unet.apply(unet_model, torch.cat([lat, lat], dim=0),
                             t.expand(2 * b), context2)
            return model_out_to_eps(combine(out[:b], out[b:]), lat, t, cfg)

        return run(model_fn)

    # cached CFG: the aux state is (network calls so far, last uncond output)
    def model_fn(lat, t, aux):
        n, o_u = aux
        tb = t.expand(b)
        o_c = unet.apply(unet_model, lat, tb, context)
        if n % uncond_interval == 0:
            o_u = unet.apply(unet_model, lat, tb, uncond_context)
        return model_out_to_eps(combine(o_u, o_c), lat, t, cfg), (n + 1, o_u)

    return run(model_fn, aux_init=(0, None))


@torch.inference_mode()
def generate(model: StableDiffusion, input_ids: torch.Tensor,
             uncond_ids: Optional[torch.Tensor], latent: torch.Tensor, guidance, *,
             num_steps: int = 20, method: str = "ddim", schedule: str = "ladder",
             generator: Optional[torch.Generator] = None, uncond_interval: int = 1,
             cfg_rescale: float = 0.0,
             prompt_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tokens + initial noise -> uint8 images (B, H, W, 3).

    uncond_ids=None samples without guidance. prompt_weights (B, T) weighs
    the prompt's tokens (tokenizer/prompt_weights.py). The ancestral
    samplers draw their noise from ``generator``."""
    cfg = model.cfg
    ctx = encode_text(model, input_ids)
    uctx = None if uncond_ids is None else encode_text(model, uncond_ids)
    if prompt_weights is not None:
        ctx = apply_prompt_weights(ctx, prompt_weights)
    lat = sample_latents(model.unet, latent, ctx, uctx, num_steps=num_steps,
                         guidance=guidance, cfg=cfg, method=method, schedule=schedule,
                         generator=generator, uncond_interval=uncond_interval,
                         cfg_rescale=cfg_rescale)
    return vae.to_image(vae.decode(model.vae, lat))


def initial_latent(seed: int, batch: int, cfg: SDConfig = SD15, *,
                   device: Union[str, torch.device] = "cuda",
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard-normal initial noise (B, h, w, c), drawn on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, *cfg.latent_shape), generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)
