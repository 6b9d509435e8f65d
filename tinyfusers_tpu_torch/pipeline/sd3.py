"""SD3 text-to-image pipeline: MMDiT + rectified flow (port of
tinyfusers_tpu/pipeline/sd3.py).

``StableDiffusion3`` holds the models as submodules named after the JAX
param tree: ``clip_l`` (CLIP ViT-L), ``clip_g`` (OpenCLIP bigG),
``mmdit``, ``vae`` (16-channel decoder) and, in the T5 configurations,
``t5`` (T5-XXL). The conditioning is the two CLIP towers' penultimate
states side by side, zero-padded to the MMDiT's context width, with the
T5 states appended on the token axis when the config has T5 and T5 ids
are given; the pooled vector is the two towers' pooled embeddings.
``generate`` runs the CFG batch [uncond ‖ cond] through the MMDiT at every
step of the Euler (or Heun) rectified-flow integration, then decodes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..models import clip, mmdit, t5 as t5_model, vae
from ..models.layers import init_weights
from ..utils import profiling
from . import ddim
from . import sd as sd_pipeline
from . import rectified_flow as rf


@dataclass(frozen=True)
class SD3Config:
    clip_l: clip.CLIPConfig = field(default_factory=lambda: clip.CLIPConfig(
        projection_dim=768))
    clip_g: clip.CLIPConfig = field(
        default_factory=lambda: clip.OPENCLIP_BIGG_CONFIG)
    mmdit: mmdit.MMDiTConfig = field(default_factory=lambda: mmdit.SD3_MEDIUM)
    vae: vae.VAEConfig = field(default_factory=lambda: vae.SD3_VAE_CONFIG)
    # Optional T5-XXL tower; t5.dim must equal mmdit.context_dim.
    t5: Optional[t5_model.T5Config] = None
    height: int = 1024
    width: int = 1024
    shift: float = 3.0

    @property
    def latent_shape(self):
        f = self.vae.downsample_factor
        return (self.height // f, self.width // f, self.vae.latent_channels)


SD3_MEDIUM_CFG = SD3Config()
SD3_MEDIUM_T5_CFG = SD3Config(t5=t5_model.T5_XXL)
SD35_LARGE_CFG = SD3Config(mmdit=mmdit.SD35_LARGE)
SD35_LARGE_T5_CFG = SD3Config(mmdit=mmdit.SD35_LARGE, t5=t5_model.T5_XXL)

TINY_SD3 = SD3Config(
    clip_l=clip.CLIPConfig(vocab_size=128, max_length=8, dim=16,
                           num_layers=2, num_heads=4, mlp_dim=32,
                           projection_dim=16),
    clip_g=clip.CLIPConfig(vocab_size=128, max_length=8, dim=32,
                           num_layers=2, num_heads=4, mlp_dim=64,
                           act="gelu", projection_dim=32),
    mmdit=mmdit.MMDiTConfig(input_size=16, patch_size=2, in_channels=4,
                            out_channels=4, dim=64, depth=2, num_heads=4,
                            context_dim=64, pooled_dim=48, context_len=8),
    vae=vae.VAEConfig(base_channels=16, channel_mult=(1, 1, 2), num_groups=8,
                      latent_channels=4, scale_factor=1.5305,
                      use_quant_conv=False),
    height=32,
    width=32,
)

TINY_SD3_T5 = SD3Config(
    clip_l=TINY_SD3.clip_l, clip_g=TINY_SD3.clip_g, mmdit=TINY_SD3.mmdit,
    vae=TINY_SD3.vae, height=32, width=32,
    t5=t5_model.T5Config(vocab_size=128, dim=64, ff_dim=128, num_layers=2,
                         num_heads=4, head_dim=16, rel_buckets=8,
                         rel_max_distance=16),
)


class StableDiffusion3(nn.Module):
    """CLIP-L + bigG (+ T5) + MMDiT + VAE decoder on one device.

    device defaults to "cuda" and raises without a GPU. seed fills the
    weights with the JAX package's init distributions (adaLN-Zero: every
    modulation and the final projection are zeros), drawn on the device;
    seed=None leaves them empty for a loader (io/from_jax.py,
    io/checkpoints.load_sd3_params). learned_pos_embed: the MMDiT holds a
    learned pos_embed, as SD3's single-file checkpoints do.
    """

    def __init__(self, cfg: SD3Config = SD3_MEDIUM_CFG, *,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32, seed: Optional[int] = 0,
                 learned_pos_embed: bool = False):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype)
        self.cfg = cfg
        self.clip_l = clip.CLIPTextModel(cfg.clip_l, **kw)
        self.clip_g = clip.CLIPTextModel(cfg.clip_g, **kw)
        self.mmdit = mmdit.MMDiT(cfg.mmdit, learned_pos_embed=learned_pos_embed, **kw)
        self.vae = vae.AutoencoderKL(cfg.vae, **kw)
        if cfg.t5 is not None:
            self.t5 = t5_model.T5Encoder(cfg.t5, **kw)
        if seed is not None:
            init_weights(self, seed)


def encode_text(model: StableDiffusion3, ids_l: torch.Tensor, ids_g: torch.Tensor,
                ids_t5: Optional[torch.Tensor] = None):
    """-> (context (B, T, mmdit.context_dim), pooled (B, pooled_dim)).

    T is the CLIP length, plus the T5 length when the config has T5 and
    ids_t5 is given."""
    cfg = model.cfg
    hl, pool_l = clip.apply_penultimate_and_pooled(model.clip_l, ids_l)
    hg, pool_g = clip.apply_penultimate_and_pooled(model.clip_g, ids_g)
    joint = torch.cat([hl, hg], dim=-1)
    pad = cfg.mmdit.context_dim - joint.shape[-1]
    if pad < 0:
        raise ValueError("mmdit.context_dim is smaller than the CLIP widths together")
    context = F.pad(joint, (0, pad))
    if cfg.t5 is not None and ids_t5 is not None:
        ht = t5_model.apply(model.t5, ids_t5)
        if ht.shape[-1] != cfg.mmdit.context_dim:
            raise ValueError("t5.dim must equal mmdit.context_dim")
        context = torch.cat([context, ht.to(context.dtype)], dim=1)
    return context, torch.cat([pool_l, pool_g], dim=-1)


def sample_latents(mmdit_model: mmdit.MMDiT, latent: torch.Tensor,
                   context2: torch.Tensor, pooled2: torch.Tensor, guidance, *,
                   num_steps: int, shift: float = 3.0,
                   method: str = "euler") -> torch.Tensor:
    """Classifier-free-guided flow integration: one MMDiT call on the batch
    of 2B per model evaluation, context2 / pooled2 = [uncond ‖ cond]."""
    b = latent.shape[0]
    g = torch.as_tensor(guidance, dtype=torch.float32, device=latent.device)

    def model_fn(x, t):
        v = mmdit.apply(mmdit_model, torch.cat([x, x], dim=0), torch.cat([t, t], dim=0),
                        context2, pooled2)
        return ddim.cfg_combine(v[:b], v[b:], g)

    return rf.sample(model_fn, latent, num_steps, shift=shift, method=method)


@torch.inference_mode()
def generate(model: StableDiffusion3, ids_l: torch.Tensor, ids_g: torch.Tensor,
             uids_l: torch.Tensor, uids_g: torch.Tensor, latent: torch.Tensor,
             guidance, *, num_steps: int = 28, method: str = "euler",
             ids_t5: Optional[torch.Tensor] = None,
             uids_t5: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Tokens + initial noise -> uint8 images (B, H, W, 3). mesh: as
    sd.generate's, each rank of the data axis sampling its rows of the
    batch, with ``mesh`` the ambient mesh of a ring or pipelined MMDiT.
    Spans: as sd.generate's."""
    if mesh is not None:
        return sd_pipeline.run_on_mesh(
            mesh, lambda ids_l, ids_g, uids_l, uids_g, latent, ids_t5, uids_t5: generate(
                model, ids_l, ids_g, uids_l, uids_g, latent, guidance, num_steps=num_steps,
                method=method, ids_t5=ids_t5, uids_t5=uids_t5),
            ids_l=ids_l, ids_g=ids_g, uids_l=uids_l, uids_g=uids_g, latent=latent,
            ids_t5=ids_t5, uids_t5=uids_t5)
    with profiling.span("generate"):
        with profiling.span("generate.encode"):
            ctx_c, pool_c = encode_text(model, ids_l, ids_g, ids_t5)
            ctx_u, pool_u = encode_text(model, uids_l, uids_g, uids_t5)
            ctx2 = torch.cat([ctx_u, ctx_c], dim=0).to(latent.dtype)
            pool2 = torch.cat([pool_u, pool_c], dim=0).to(latent.dtype)
        with profiling.span("generate.denoise"):
            lat = sample_latents(model.mmdit, latent, ctx2, pool2, guidance,
                                 num_steps=num_steps, shift=model.cfg.shift, method=method)
        with profiling.span("generate.decode"):
            return vae.to_image(vae.decode(model.vae, lat))


def initial_latent(seed: int, batch: int, cfg: SD3Config = SD3_MEDIUM_CFG, *,
                   device: Union[str, torch.device] = "cuda",
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard-normal initial noise (B, h, w, c), drawn on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, *cfg.latent_shape), generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)
