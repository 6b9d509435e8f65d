"""SDXL-base text-to-image pipeline (port of tinyfusers_tpu/pipeline/sdxl.py).

``StableDiffusionXL`` holds the models as submodules named after the JAX
param tree: ``clip_l`` (CLIP ViT-L), ``clip_g`` (OpenCLIP bigG), ``unet``
(models/unet.SDXL_CONFIG: 3 levels, transformer depths (0, 2, 10), 64-wide
heads, the ADM MLP) and ``vae`` (scale factor 0.13025).

The conditioning is both towers' penultimate states (no final norm) side
by side, a 2048-wide context; the ADM vector is bigG's pooled embedding
followed by the sinusoidal embeddings of the six sizes (original height
and width, crop top and left, target height and width). ``generate`` runs
the CFG batch [uncond ‖ cond], contexts and ADM vectors alike, through
the sampler loop (pipeline/samplers.py), or the two branches apart under
cached CFG, then decodes.
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
from . import sd as sd_pipeline


@dataclass(frozen=True)
class SDXLConfig:
    clip_l: clip.CLIPConfig = field(default_factory=clip.CLIPConfig)
    clip_g: clip.CLIPConfig = field(default_factory=lambda: clip.OPENCLIP_BIGG_CONFIG)
    unet: unet.UNetConfig = field(default_factory=lambda: unet.SDXL_CONFIG)
    vae: vae.VAEConfig = field(default_factory=lambda: vae.VAEConfig(scale_factor=0.13025))
    height: int = 1024
    width: int = 1024
    size_emb_dim: int = 256  # the sinusoidal width of each of the six sizes

    @property
    def latent_shape(self):
        f = self.vae.downsample_factor
        return (self.height // f, self.width // f, self.vae.latent_channels)


SDXL_BASE = SDXLConfig()

TINY_XL = SDXLConfig(
    clip_l=clip.CLIPConfig(vocab_size=128, max_length=16, dim=16,
                           num_layers=2, num_heads=4, mlp_dim=32),
    clip_g=clip.CLIPConfig(vocab_size=128, max_length=16, dim=32,
                           num_layers=2, num_heads=4, mlp_dim=64,
                           act="gelu", projection_dim=32),
    unet=unet.UNetConfig(model_channels=32, channel_mult=(1, 2),
                         attention_levels=(1,), transformer_depth=(0, 2),
                         context_dim=48, num_heads=-1, head_dim=16,
                         num_groups=8, adm_in_channels=32 + 6 * 8),
    vae=vae.VAEConfig(base_channels=16, channel_mult=(1, 1, 2),
                      num_groups=8, scale_factor=0.13025),
    height=64,
    width=64,
    size_emb_dim=8,
)


class StableDiffusionXL(nn.Module):
    """CLIP-L + bigG + the SDXL UNet + VAE on one device.

    device defaults to "cuda" and raises without a GPU. seed fills the
    weights with the JAX package's init distributions, drawn on the
    device; seed=None leaves them empty for a loader (io/from_jax.py,
    io/checkpoints.load_sdxl_params)."""

    def __init__(self, cfg: SDXLConfig = SDXL_BASE, *,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32, seed: Optional[int] = 0):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.cfg = cfg
        self.clip_l = clip.CLIPTextModel(cfg.clip_l, **kw)
        self.clip_g = clip.CLIPTextModel(cfg.clip_g, **kw)
        self.unet = unet.UNet(cfg.unet, **kw)
        self.vae = vae.AutoencoderKL(cfg.vae, **kw)
        if seed is not None:
            init_weights(self, seed)


def encode_text(model: StableDiffusionXL, ids_l: torch.Tensor, ids_g: torch.Tensor):
    """-> (context (B, T, clip_l.dim + clip_g.dim), pooled (B, projection_dim)).

    Both towers give their penultimate state without the final norm; the
    pooled embedding is bigG's final-norm state at the first EOT through
    its text_projection. The JAX package runs bigG twice for the two; one
    pass gives both here."""
    hl = clip.apply(model.clip_l, ids_l, skip_final_norm_layers=1)
    hg, pooled = clip.apply_penultimate_and_pooled(model.clip_g, ids_g)
    return torch.cat([hl, hg], dim=-1), pooled


def size_embeddings(sizes: torch.Tensor, dim: int) -> torch.Tensor:
    """sizes (B, 6) = (orig_h, orig_w, crop_t, crop_l, tgt_h, tgt_w) ->
    (B, 6 * dim): each size's fp32 timestep embedding, cos then sin."""
    emb = unet.timestep_embedding(sizes.reshape(-1).float(), dim)
    return emb.reshape(sizes.shape[0], -1)


def make_adm_cond(pooled: torch.Tensor, sizes: torch.Tensor, cfg: SDXLConfig) -> torch.Tensor:
    """The UNet's ADM vector: pooled ‖ size embeddings (in pooled's dtype)."""
    return torch.cat([pooled, size_embeddings(sizes, cfg.size_emb_dim).to(pooled.dtype)],
                     dim=-1)


def default_sizes(batch: int, cfg: SDXLConfig, *,
                  device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """(batch, 6) fp32: the config's size as original and target, no crop."""
    row = torch.tensor([[cfg.height, cfg.width, 0, 0, cfg.height, cfg.width]],
                       dtype=torch.float32, device=device)
    return row.expand(batch, 6)


def conditioning(model: StableDiffusionXL, ids_l: torch.Tensor, ids_g: torch.Tensor,
                 dtype: torch.dtype):
    """(context, ADM vector) of the prompt's ids, both in ``dtype`` (the
    latent's), at the config's default sizes."""
    ctx, pooled = encode_text(model, ids_l, ids_g)
    sizes = default_sizes(ids_l.shape[0], model.cfg, device=ids_l.device)
    return ctx.to(dtype), make_adm_cond(pooled, sizes, model.cfg).to(dtype)


def sample_latents(unet_model: unet.UNet, latent: torch.Tensor, cond, uncond, guidance, *,
                   num_steps: int = 20, method: str = "ddim", schedule: str = "ladder",
                   generator: Optional[torch.Generator] = None, uncond_interval: int = 1,
                   cfg_rescale: float = 0.0, freeu=None) -> torch.Tensor:
    """CFG sampling; cond and uncond are (context, ADM vector) pairs.

    uncond_interval k <= 1: one UNet call on the batch of 2B, [uncond ‖
    cond] for the contexts and the ADM vectors alike. k > 1 is cached CFG:
    the cond branch at batch B every network call, the uncond branch
    recomputed every k-th call and reused between. cfg_rescale > 0
    rescales the guided output (ddim.cfg_rescale). SDXL-base is an
    epsilon model: the combined output is the eps prediction."""
    b = latent.shape[0]
    g = torch.as_tensor(guidance, dtype=torch.float32, device=latent.device)
    (ctx_c, adm_c), (ctx_u, adm_u) = cond, uncond

    def combine(e_u, e_c):
        o = ddim.cfg_combine(e_u, e_c, g)
        return ddim.cfg_rescale(o, e_c, cfg_rescale) if cfg_rescale > 0.0 else o

    def unet_apply(lat, t, ctx, adm):
        return unet.apply(unet_model, lat, t, ctx, adm_cond=adm, freeu=freeu)

    run = dict(method=method, schedule=schedule, generator=generator)
    if uncond_interval <= 1:
        context2, adm2 = torch.cat([ctx_u, ctx_c]), torch.cat([adm_u, adm_c])

        def model_fn(lat, t):
            eps = unet_apply(torch.cat([lat, lat]), t.expand(2 * b), context2, adm2)
            return combine(eps[:b], eps[b:])

        return samplers.sample(model_fn, latent, num_steps, **run)

    # the aux state is (network calls so far, last uncond output)
    def model_fn(lat, t, aux):
        n, e_u = aux
        tb = t.expand(b)
        e_c = unet_apply(lat, tb, ctx_c, adm_c)
        if n % uncond_interval == 0:
            e_u = unet_apply(lat, tb, ctx_u, adm_u)
        return combine(e_u, e_c), (n + 1, e_u)

    return samplers.sample(model_fn, latent, num_steps, aux_init=(0, None), **run)


@torch.inference_mode()
def generate(model: StableDiffusionXL, ids_l: torch.Tensor, ids_g: torch.Tensor,
             uids_l: torch.Tensor, uids_g: torch.Tensor, latent: torch.Tensor, guidance, *,
             num_steps: int = 20, method: str = "ddim", schedule: str = "ladder",
             generator: Optional[torch.Generator] = None, uncond_interval: int = 1,
             cfg_rescale: float = 0.0, freeu=None, mesh=None) -> torch.Tensor:
    """Both towers' tokens (prompt and negative prompt) + initial noise ->
    uint8 images (B, H, W, 3). method, schedule and generator:
    pipeline/samplers.py; uncond_interval and cfg_rescale: sample_latents;
    freeu (b1, b2, s1, s2) in every UNet call. mesh: as sd.generate's, each
    rank of the data axis sampling its rows of the batch."""
    if mesh is not None:
        kw = dict(num_steps=num_steps, method=method, schedule=schedule, generator=generator,
                  uncond_interval=uncond_interval, cfg_rescale=cfg_rescale, freeu=freeu)
        return sd_pipeline.run_on_mesh(
            mesh, lambda ids_l, ids_g, uids_l, uids_g, latent: generate(
                model, ids_l, ids_g, uids_l, uids_g, latent, guidance, **kw),
            ids_l=ids_l, ids_g=ids_g, uids_l=uids_l, uids_g=uids_g, latent=latent)
    cond = conditioning(model, ids_l, ids_g, latent.dtype)
    uncond = conditioning(model, uids_l, uids_g, latent.dtype)
    lat = sample_latents(model.unet, latent, cond, uncond, guidance, num_steps=num_steps,
                         method=method, schedule=schedule, generator=generator,
                         uncond_interval=uncond_interval, cfg_rescale=cfg_rescale,
                         freeu=freeu)
    return vae.to_image(vae.decode(model.vae, lat))


def initial_latent(seed: int, batch: int, cfg: SDXLConfig = SDXL_BASE, *,
                   device: Union[str, torch.device] = "cuda",
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard-normal initial noise (B, h, w, c), drawn on the device from
    a torch.Generator seeded with ``seed`` (not jax.random's numbers)."""
    return sd_pipeline.initial_latent(seed, batch, cfg, device=device, dtype=dtype)
