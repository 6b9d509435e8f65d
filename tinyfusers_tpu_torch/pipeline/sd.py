"""Stable Diffusion text-to-image pipeline (port of
tinyfusers_tpu/pipeline/sd.py): SD1.x and SD2.x, epsilon and v
prediction.

``StableDiffusion`` holds the three models as submodules named after the
JAX param tree ("clip", "unet", "vae"). ``generate`` runs CLIP on the
prompt and the negative prompt, the sampler loop (pipeline/samplers.py)
with the UNet on the cond+uncond batch of 2B (or on B alone without
guidance, or the two branches apart under cached CFG), the VAE decode and
the uint8 conversion, with DeepCache, FreeU and ControlNet residuals as
options. ``generate_hires`` (the hires fix), ``img2img`` and ``inpaint``
(the 9-channel UNet) are the other entry points.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional, Union

import torch
from torch import nn

from ..device import resolve_device
from ..models import clip, controlnet, unet, vae
from ..models.layers import init_weights
from ..utils import profiling
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


def _controlled(control):
    """(controlnet, hint, scale) -> the function giving fresh ControlNet
    residuals (skips, middle) at (latents, timesteps, context), with the
    hint encoded here, once per generation: it does not change between
    steps."""
    cn, hint, scale = control
    guided = controlnet.encode_hint(cn, hint)

    def ctrl_for(lat, t, ctx):
        g = guided.to(lat.dtype).expand(lat.shape[0], *guided.shape[1:])
        return controlnet.apply(cn, lat, None, t, ctx, scale=scale, hint_features=g)

    return ctrl_for


def sample_latents(unet_model: unet.UNet, latent: torch.Tensor,
                   context: torch.Tensor, uncond_context: Optional[torch.Tensor], *,
                   num_steps: int, guidance, cfg: SDConfig = SD15,
                   method: str = "ddim", schedule: str = "ladder",
                   start_index: int = 0, generator: Optional[torch.Generator] = None,
                   uncond_interval: int = 1, deepcache_interval: int = 1,
                   deepcache_split: int = 3, cfg_rescale: float = 0.0,
                   control=None, freeu=None) -> torch.Tensor:
    """Sampling with classifier-free guidance: one UNet call on the batch of
    2B ([uncond ‖ cond]) per network call, combined with ``guidance``.

    method, schedule, start_index, generator: pipeline/samplers.py.
    uncond_context=None samples without guidance (distilled checkpoints, or
    guidance 1): the UNet runs on B alone and ``guidance`` is unused.
    uncond_interval k > 1 is cached CFG: the unconditional output is
    recomputed every k-th network call and reused in between (under every
    sampler; for the 2-call samplers k counts calls); approximate.
    deepcache_interval k > 1 is DeepCache: the whole UNet every k-th network
    call, in between only its first and last ``deepcache_split`` blocks
    around the cached deep feature; approximate. With uncond_interval > 1
    too, the cond branch runs DeepCache and the uncond branch a full UNet
    every uncond_interval-th call (_deepcache_cached_cfg_fn).
    cfg_rescale > 0 rescales the guided output (ddim.cfg_rescale) in
    model-output space, before the v -> eps step.
    control: (models.controlnet.ControlNet, hint (B, H, W, 3) in [0, 1] at
    the image's resolution, scale): ControlNet residuals into every UNet
    call, refreshed on full passes and reused on DeepCache's shallow ones.
    freeu: (b1, b2, s1, s2), FreeU in every UNet call."""
    if uncond_context is None and (uncond_interval > 1 or deepcache_interval > 1):
        raise ValueError(
            "guidance-free sampling (uncond_context=None) does not compose with "
            "cached-CFG/DeepCache intervals — there is no uncond branch to cache")
    b = latent.shape[0]
    g = torch.as_tensor(guidance, dtype=torch.float32, device=latent.device)
    run = functools.partial(samplers.sample, latent=latent, num_steps=num_steps,
                            method=method, schedule=schedule, start_index=start_index,
                            generator=generator)
    ctrl_for = None if control is None else _controlled(control)

    def combine(o_u, o_c):
        o = ddim.cfg_combine(o_u, o_c, g)
        return ddim.cfg_rescale(o, o_c, cfg_rescale) if cfg_rescale > 0.0 else o

    def unet_apply(lat, t, ctx):
        ctrl = None if ctrl_for is None else ctrl_for(lat, t, ctx)
        return unet.apply(unet_model, lat, t, ctx, control=ctrl, freeu=freeu)

    if deepcache_interval > 1:
        kw = dict(unet_model=unet_model, context=context, uncond_context=uncond_context,
                  combine=combine, cfg=cfg, split=deepcache_split, ctrl_for=ctrl_for,
                  freeu=freeu, b=b)
        if uncond_interval > 1:
            return run(_deepcache_cached_cfg_fn(dk=deepcache_interval, uk=uncond_interval,
                                                **kw), aux_init=(0, None, None, None))
        return run(_deepcache_fn(interval=deepcache_interval, **kw),
                   aux_init=(0, None, None))

    if uncond_context is None:
        def model_fn(lat, t):
            out = unet_apply(lat, t.expand(b), context)
            return model_out_to_eps(out, lat, t, cfg)

        return run(model_fn)

    if uncond_interval <= 1:
        context2 = torch.cat([uncond_context, context], dim=0)

        def model_fn(lat, t):
            out = unet_apply(torch.cat([lat, lat], dim=0), t.expand(2 * b), context2)
            return model_out_to_eps(combine(out[:b], out[b:]), lat, t, cfg)

        return run(model_fn)

    # cached CFG: the aux state is (network calls so far, last uncond output)
    def model_fn(lat, t, aux):
        n, o_u = aux
        tb = t.expand(b)
        o_c = unet_apply(lat, tb, context)
        if n % uncond_interval == 0:
            o_u = unet_apply(lat, tb, uncond_context)
        return model_out_to_eps(combine(o_u, o_c), lat, t, cfg), (n + 1, o_u)

    return run(model_fn, aux_init=(0, None))


def _deepcache_passes(unet_model, split, ctrl_for, freeu):
    """(full, shallow) UNet passes of DeepCache at split ``split``, each
    (lat, t, ctx, cache, ctrl_cache) -> (eps, cache, ctrl_cache). A full
    pass refreshes the ControlNet residuals and keeps the first ``split``
    skip residuals for the shallow passes; the deeper residuals act through
    the cached deep feature."""
    def full(lat, t, ctx, cache, ctrl_cache):
        ctrl = None if ctrl_for is None else ctrl_for(lat, t, ctx)
        eps, cache = unet.apply(unet_model, lat, t, ctx, deepcache=("full", split),
                                control=ctrl, freeu=freeu)
        return eps, cache, ctrl_cache if ctrl is None else tuple(ctrl[0][:split])

    def shallow(lat, t, ctx, cache, ctrl_cache):
        eps, cache = unet.apply(unet_model, lat, t, ctx, deepcache=("shallow", split),
                                cache=cache, control=ctrl_cache, freeu=freeu)
        return eps, cache, ctrl_cache

    return full, shallow


def _deepcache_fn(*, unet_model, context, uncond_context, combine, cfg, interval, split,
                  ctrl_for, freeu, b):
    """DeepCache under CFG on the batch of 2B, as the JAX package's
    _sample_deepcache: a full UNet every ``interval``-th network call, the
    shallow pass between. The aux state is (calls so far, deep-feature
    cache, cached first-split ControlNet residuals), None until the first
    full pass fills it."""
    full, shallow = _deepcache_passes(unet_model, split, ctrl_for, freeu)
    context2 = torch.cat([uncond_context, context], dim=0)

    def model_fn(lat, t, aux):
        n, cache, ctrl_cache = aux
        lat2, t2 = torch.cat([lat, lat], dim=0), t.float().expand(2 * b)
        step = full if n % interval == 0 else shallow
        eps, cache, ctrl_cache = step(lat2, t2, context2, cache, ctrl_cache)
        return model_out_to_eps(combine(eps[:b], eps[b:]), lat, t, cfg), (n + 1, cache,
                                                                          ctrl_cache)

    return model_fn


def _deepcache_cached_cfg_fn(*, unet_model, context, uncond_context, combine, cfg, dk, uk,
                             split, ctrl_for, freeu, b):
    """DeepCache on the cond branch (batch B) and cached CFG on the uncond
    branch, as the JAX package's _sample_deepcache_cached_cfg: the cond
    branch runs a full pass every ``dk``-th network call and the shallow
    pass between; the uncond branch runs the whole UNet, with fresh
    ControlNet residuals, every ``uk``-th call and is reused between. The
    aux state is (calls so far, last uncond output, cache, cached
    residuals)."""
    full, shallow = _deepcache_passes(unet_model, split, ctrl_for, freeu)

    def model_fn(lat, t, aux):
        n, o_u, cache, ctrl_cache = aux
        tb = t.float().expand(b)
        step = full if n % dk == 0 else shallow
        o_c, cache, ctrl_cache = step(lat, tb, context, cache, ctrl_cache)
        if n % uk == 0:
            ctrl = None if ctrl_for is None else ctrl_for(lat, tb, uncond_context)
            o_u = unet.apply(unet_model, lat, tb, uncond_context, control=ctrl, freeu=freeu)
        return model_out_to_eps(combine(o_u, o_c), lat, t, cfg), (n + 1, o_u, cache,
                                                                  ctrl_cache)

    return model_fn


def _contexts(model: StableDiffusion, input_ids, uncond_ids, prompt_weights=None):
    ctx = encode_text(model, input_ids)
    uctx = None if uncond_ids is None else encode_text(model, uncond_ids)
    if prompt_weights is not None:
        ctx = apply_prompt_weights(ctx, prompt_weights)
    return ctx, uctx


@torch.inference_mode()
def generate(model: StableDiffusion, input_ids: torch.Tensor,
             uncond_ids: Optional[torch.Tensor], latent: torch.Tensor, guidance, *,
             num_steps: int = 20, method: str = "ddim", schedule: str = "ladder",
             generator: Optional[torch.Generator] = None, uncond_interval: int = 1,
             deepcache_interval: int = 1, deepcache_split: int = 3,
             cfg_rescale: float = 0.0, freeu=None,
             prompt_weights: Optional[torch.Tensor] = None, control=None,
             mesh=None) -> torch.Tensor:
    """Tokens + initial noise -> uint8 images (B, H, W, 3).

    uncond_ids=None samples without guidance. prompt_weights (B, T) weighs
    the prompt's tokens (tokenizer/prompt_weights.py). The ancestral
    samplers draw their noise from ``generator``. deepcache_interval,
    deepcache_split, freeu and control (controlnet, hint, scale): see
    sample_latents.

    mesh (parallel.make_mesh): on each rank of the mesh's data axis its
    rows of the global batch (``run_on_mesh``): the ids, latents, prompt
    weights and a hint with a row per image (a one-row hint goes to every
    rank, as the dense call broadcasts it), through its tensor-parallel
    text encoder, UNet and ControlNet (``parallel.shard_params`` on the
    model and on the ControlNet), with ``mesh`` the ambient mesh of a ring
    self-attention (``UNetConfig.self_attn_impl``) and the generator's
    draws this rank's rows of the global draw; the images gathered back in
    row order on every rank.

    Spans (utils/profiling.py): ``generate`` with ``generate.encode``,
    ``generate.denoise`` and ``generate.decode``; on a mesh, the inner
    call's alone."""
    kw = dict(num_steps=num_steps, method=method, schedule=schedule, generator=generator,
              uncond_interval=uncond_interval, deepcache_interval=deepcache_interval,
              deepcache_split=deepcache_split, cfg_rescale=cfg_rescale, freeu=freeu)
    if mesh is not None:
        cn, hint, scale = control if control is not None else (None, None, None)
        per_row = hint is not None and hint.shape[0] == latent.shape[0] > 1

        def local(input_ids, uncond_ids, latent, prompt_weights, hint_rows):
            ctrl = None if cn is None else (cn, hint_rows if per_row else hint, scale)
            return generate(model, input_ids, uncond_ids, latent, guidance,
                            prompt_weights=prompt_weights, control=ctrl, **kw)

        return run_on_mesh(mesh, local, input_ids=input_ids, uncond_ids=uncond_ids,
                           latent=latent, prompt_weights=prompt_weights,
                           hint_rows=hint if per_row else None)
    with profiling.span("generate"):
        with profiling.span("generate.encode"):
            ctx, uctx = _contexts(model, input_ids, uncond_ids, prompt_weights)
        with profiling.span("generate.denoise"):
            lat = sample_latents(model.unet, latent, ctx, uctx, guidance=guidance,
                                 cfg=model.cfg, control=control, **kw)
        with profiling.span("generate.decode"):
            return vae.to_image(vae.decode(model.vae, lat))


def run_on_mesh(mesh, fn, **rows) -> torch.Tensor:
    """``fn(**rows)`` on this rank's rows of the global batch: each tensor
    of ``rows`` (batch leading; None passes as it is) cut to its part of
    the mesh's data axis, under ``parallel.use_mesh(mesh)`` and
    ``samplers.global_rows`` (a generator's draws are this rank's rows of
    the global draw); fn's images gathered back in row order on every
    rank."""
    from ..parallel import tp
    from ..parallel.mesh import DATA_AXIS, axis, use_mesh

    n, r, group = axis(mesh, DATA_AXIS)
    for name, x in rows.items():
        if x is not None and x.shape[0] % n:
            raise ValueError(f"{name}: batch {x.shape[0]} does not split over {n} data ranks")
    mine = {k: None if x is None else tp.rank_slice(x, 0, r, n) for k, x in rows.items()}
    with use_mesh(mesh), samplers.global_rows(r, n):
        images = fn(**mine)
    return tp.all_gather(images, group, dim=0)


def noise_to_rung(z0: torch.Tensor, noise: torch.Tensor, sigma) -> torch.Tensor:
    """A clean latent z0 noised to the ladder rung of noise level ``sigma``,
    in DDPM space, as samplers.sample takes a tail start (start_index > 0):
    x_t = sqrt(a) z0 + sqrt(1-a) n = (z0 + sigma n) / sqrt(1 + sigma^2),
    fp32, in z0's dtype."""
    x = z0.float() + sigma * noise.float()
    return (x / torch.sqrt(1.0 + sigma ** 2)).to(z0.dtype)


def hires_tail_start(steps: int, strength: float) -> int:
    """The rung the hires tail starts at: ``steps`` less the rungs run,
    round(steps * strength) clipped to [1, steps], with Python's round, as
    the JAX package does (its documentation says ceil; ADVICE.md)."""
    return steps - max(1, min(steps, int(round(steps * strength))))


@torch.inference_mode()
def generate_hires(model: StableDiffusion, input_ids: torch.Tensor,
                   uncond_ids: Optional[torch.Tensor], latent: torch.Tensor,
                   generator: torch.Generator, guidance, *, num_steps: int = 20,
                   method: str = "ddim", schedule: str = "ladder", hires_scale: int = 2,
                   hires_steps: int = 0, hires_strength: float = 0.6,
                   uncond_interval: int = 1, cfg_rescale: float = 0.0,
                   freeu=None, mesh=None) -> torch.Tensor:
    """Hires fix: sample at the config's resolution, upscale the latent
    bilinearly by ``hires_scale`` (fp32), noise it to a rung of a
    ``hires_steps`` ladder (0: num_steps), and sample the tail from there
    at the high resolution; uint8 images at hires_scale times the size.

    hires_strength is the share of that ladder run from the noise
    (hires_tail_start). ``generator`` draws, in order: the base pass's
    ancestral noise, the re-noising, the tail's ancestral noise (the JAX
    package splits one key three ways). mesh: as generate's, each draw
    this rank's rows of the global draw."""
    if mesh is not None:
        kw = dict(num_steps=num_steps, method=method, schedule=schedule,
                  hires_scale=hires_scale, hires_steps=hires_steps,
                  hires_strength=hires_strength, uncond_interval=uncond_interval,
                  cfg_rescale=cfg_rescale, freeu=freeu)
        return run_on_mesh(mesh, lambda input_ids, uncond_ids, latent: generate_hires(
            model, input_ids, uncond_ids, latent, generator, guidance, **kw),
            input_ids=input_ids, uncond_ids=uncond_ids, latent=latent)
    cfg = model.cfg
    ctx, uctx = _contexts(model, input_ids, uncond_ids)
    common = dict(guidance=guidance, cfg=cfg, method=method, schedule=schedule,
                  generator=generator, uncond_interval=uncond_interval,
                  cfg_rescale=cfg_rescale, freeu=freeu)
    lat = sample_latents(model.unet, latent, ctx, uctx, num_steps=num_steps, **common)
    b, h, w, _ = lat.shape
    hi = torch.nn.functional.interpolate(
        lat.float().permute(0, 3, 1, 2), size=(h * hires_scale, w * hires_scale),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    hs = hires_steps or num_steps
    start = hires_tail_start(hs, hires_strength)
    _, sigmas = samplers.sigma_ladder(hs, "ladder" if method == "ddim" else schedule,
                                      device=lat.device)
    noise = samplers._normal(generator, hi)
    x_t = noise_to_rung(hi.to(lat.dtype), noise, sigmas[start])
    lat_hi = sample_latents(model.unet, x_t, ctx, uctx, num_steps=hs, start_index=start,
                            **common)
    return vae.to_image(vae.decode(model.vae, lat_hi))


def _unit_image(image: torch.Tensor) -> torch.Tensor:
    """uint8 or float [0, 1] images -> fp32 in [0, 1]."""
    if image.dtype == torch.uint8:
        return image.float() / 255.0
    return image.float()


def _param_dtype(module: nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


@torch.inference_mode()
def img2img(model: StableDiffusion, image: torch.Tensor, input_ids: torch.Tensor,
            uncond_ids: torch.Tensor, generator: torch.Generator, guidance, *,
            num_steps: int = 20, start_step: int = 15, mesh=None) -> torch.Tensor:
    """Image to image: VAE-encode ``image`` (B, H, W, 3), uint8 or float in
    [0, 1]; noise the latent to the DDIM ladder's timestep start_step - 1
    (its alpha; the noise from ``generator``, in the latent's dtype); run
    the last start_step steps of the num_steps ladder with CFG; decode.
    start_step / num_steps is the usual "strength". mesh: as generate's."""
    if mesh is not None:
        return run_on_mesh(mesh, lambda image, input_ids, uncond_ids: img2img(
            model, image, input_ids, uncond_ids, generator, guidance, num_steps=num_steps,
            start_step=start_step), image=image, input_ids=input_ids, uncond_ids=uncond_ids)
    cfg = model.cfg
    dtype = _param_dtype(model.unet)
    z0 = vae.encode(model.vae, (_unit_image(image) * 2.0 - 1.0).to(dtype))
    ctx, uctx = _contexts(model, input_ids, uncond_ids)
    k = min(start_step, num_steps)
    alphas, _ = ddim.ddim_alphas(num_steps, device=z0.device)
    a0 = alphas[k - 1]
    noise = samplers._normal(generator, z0).to(z0.dtype)
    lat = (torch.sqrt(a0) * z0.float() + torch.sqrt(1.0 - a0) * noise.float()).to(dtype)
    lat = sample_latents(model.unet, lat, ctx, uctx, num_steps=num_steps, guidance=guidance,
                         cfg=cfg, start_index=num_steps - k)
    return vae.to_image(vae.decode(model.vae, lat))


def latent_mask(mask: torch.Tensor, f: int) -> torch.Tensor:
    """A (B, H, W, 1) mask on the latent grid (B, H/f, W/f, 1), fp32: the
    pixel nearest each latent cell's centre (pixels f/2, 3f/2, ...), as
    jax.image.resize's "nearest" picks it; torch's "nearest" would take
    each block's first pixel."""
    return torch.nn.functional.interpolate(
        mask.float().permute(0, 3, 1, 2), size=(mask.shape[1] // f, mask.shape[2] // f),
        mode="nearest-exact").permute(0, 2, 3, 1)


@torch.inference_mode()
def inpaint(model: StableDiffusion, image: torch.Tensor, mask: torch.Tensor,
            input_ids: torch.Tensor, uncond_ids: torch.Tensor, latent: torch.Tensor,
            guidance, *, num_steps: int = 20, mesh=None) -> torch.Tensor:
    """Inpainting with a 9-channel UNet (unet.SD15_INPAINT_CONFIG): every
    step's input is [x_t (4) ‖ mask (1) ‖ VAE(masked image) (4)], DDIM with
    CFG from the initial noise ``latent``.

    image (B, H, W, 3), uint8 or float in [0, 1]; mask (B, H, W, 1), 1 =
    repaint, reaching the latent grid through ``latent_mask``. Where mask
    <= 0.5 the source image is pasted back. mesh: as generate's."""
    if mesh is not None:
        return run_on_mesh(mesh, lambda image, mask, input_ids, uncond_ids, latent: inpaint(
            model, image, mask, input_ids, uncond_ids, latent, guidance, num_steps=num_steps),
            image=image, mask=mask, input_ids=input_ids, uncond_ids=uncond_ids, latent=latent)
    cfg = model.cfg
    dtype = _param_dtype(model.unet)
    image = _unit_image(image)
    masked = image * (1.0 - mask.float())
    z_masked = vae.encode(model.vae, (masked * 2.0 - 1.0).to(dtype))
    mask_small = latent_mask(mask, cfg.vae.downsample_factor).to(dtype)
    ctx, uctx = _contexts(model, input_ids, uncond_ids)
    context2 = torch.cat([uctx, ctx], dim=0)
    g = torch.as_tensor(guidance, dtype=torch.float32, device=latent.device)
    b = latent.shape[0]

    def model_fn(lat, t):
        nine = torch.cat([lat, mask_small, z_masked], dim=-1)
        out = unet.apply(model.unet, torch.cat([nine, nine], dim=0), t.expand(2 * b),
                         context2)
        return model_out_to_eps(ddim.cfg_combine(out[:b], out[b:], g), lat, t, cfg)

    lat = samplers.sample(model_fn, latent, num_steps, method="ddim")
    out = vae.to_image(vae.decode(model.vae, lat))
    src = (image.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return torch.where(mask <= 0.5, src, out)


def initial_latent(seed: int, batch: int, cfg: SDConfig = SD15, *,
                   device: Union[str, torch.device] = "cuda",
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard-normal initial noise (B, h, w, c), drawn on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, *cfg.latent_shape), generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)
