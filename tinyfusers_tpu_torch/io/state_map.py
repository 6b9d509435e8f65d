"""SD1.x / SD2.x and ControlNet checkpoint names <-> the port's parameters
(port of the SD and ControlNet parts of tinyfusers_tpu/io/state_map.py).

The LDM layout of an SD checkpoint is torch's own (linear weights (out,
in), conv weights OIHW), and so is the port's, so each checkpoint tensor
goes to one parameter as it is. The exceptions are OpenCLIP's: its fused
``in_proj`` is split into q, k and v, its ``positional_embedding`` is a
bare tensor, and its ``text_projection`` is applied as ``x @ W`` (stored
(in, out)). The JAX package stacks CLIP's layers for ``lax.scan``; the
port's are a ModuleList, so nothing is stacked here.

Each ``*_from_state`` writes a checkpoint into a module: every parameter
is written exactly once, every shape must match, and a missing key or
parameter raises with its name. Keys the module does not use (EMA
weights, schedules, ...) are left alone, as in the JAX package. Each
``*_to_state`` is the inverse and gives the checkpoint's tensors.

Checkpoint prefixes:
  model.diffusion_model.*                       UNet (SDXL's with label_emb.0.{0,2})
  first_stage_model.*                           VAE
  cond_stage_model.transformer.text_model.*     CLIP, HF layout (SD1.x)
  cond_stage_model.model.*                      OpenCLIP layout (SD2.x)
  conditioner.embedders.0.transformer.text_model.*   SDXL's CLIP-L, HF layout
  conditioner.embedders.1.model.*               SDXL's bigG, OpenCLIP layout
  control_model.*                               ControlNet (a file of its own)
  model.diffusion_model.*                       SD3's MMDiT (joint_blocks, ...)
  text_encoders.clip_{l,g}.transformer.text_model.*  SD3's towers, HF layout
  text_encoders.t5xxl.transformer.*             SD3's T5-XXL (HF T5EncoderModel)
  vision_model.*, visual_projection.weight      the CLIP scorer's ViT (HF CLIPModel)

SD3's single-file layout differs from torch's own in two places: the
fused ``attn.qkv`` stores its rows [q | k | v], while the port's are
head-interleaved (models/dit.py ``split_fused_qkv``), so the rows and the
bias are permuted on the way in and out; and the last ``context_block`` is
``pre_only`` (a 2-chunk adaLN, no ``attn.proj`` or ``mlp``), which goes
into the first 2·d rows of the port's 6·d ``mod`` with the rest, ``proj``
and ``mlp`` zero (gated by zero and never read). A learned ``pos_embed``
grid (192² in SD3-medium's file) is centre-cropped to the model's grid,
and written back cropped, as the JAX package does.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models import controlnet as cn_model
from ..models import unet as unet_model

# (port parameter name, checkpoint key, what to take from the key's tensor)
# and, where the checkpoint's tensor is not the parameter, a fourth item:
# what to give the checkpoint from the parameter. A key of None marks a
# parameter the checkpoint does not hold; it is written as zeros.
Entry = Tuple  # (str, Optional[str], Optional[Callable]) or with a fourth Callable

UNET_PREFIX = "model.diffusion_model"
VAE_PREFIX = "first_stage_model"
CLIP_PREFIX = "cond_stage_model.transformer.text_model"
OPENCLIP_PREFIX = "cond_stage_model.model"
CONTROLNET_PREFIX = "control_model"
SDXL_CLIP_L_PREFIX = "conditioner.embedders.0.transformer.text_model"
SDXL_CLIP_G_PREFIX = "conditioner.embedders.1.model"


def _leaf(out: List[Entry], port: str, key: str, bias: bool = True) -> None:
    out.append((f"{port}.weight", f"{key}.weight", None))
    if bias:
        out.append((f"{port}.bias", f"{key}.bias", None))


def _tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))


def _write(module: nn.Module, state: Mapping, entries: List[Entry], what: str) -> None:
    params = dict(module.named_parameters())
    written = set()
    for name, key, take, *_ in entries:
        if key is None:  # no tensor in the checkpoint: zeros
            with torch.no_grad():
                params[name].zero_()
            written.add(name)
            continue
        if key not in state:
            raise KeyError(f"{what}: the checkpoint has no {key!r} (for {name})")
        if name not in params:
            raise ValueError(f"{what}: {key!r} maps to {name}, which the module lacks")
        if name in written:
            raise ValueError(f"{what}: {name} would be written twice")
        t = _tensor(state[key])
        if take is not None:
            t = take(t)
        p = params[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{what}: {key!r} has shape {tuple(t.shape)}, but {name} "
                             f"is {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(t)
        written.add(name)
    missing = [n for n in params if n not in written]
    if missing:
        raise ValueError(f"{what}: parameters not in the checkpoint map: {missing[:8]}")


def _read(module: nn.Module, entries: List[Entry]) -> Dict[str, torch.Tensor]:
    params = dict(module.named_parameters())
    out = {}
    for name, key, _, *give in entries:
        if key is not None:
            t = params[name].detach()
            out[key] = give[0](t) if give else t
    return out


# ---------------------------------------------------------------------------
# UNet (the checkpoint's block indices are build_plan's order)
# ---------------------------------------------------------------------------

def _block_entries(out: List[Entry], port: str, key: str, specs) -> None:
    """One block of build_plan's: the UNet's and the ControlNet's alike."""
    for j, spec in enumerate(specs):
        p, k = f"{port}.{j}", f"{key}.{j}"
        if spec == "conv_in":
            _leaf(out, p, k)
        elif isinstance(spec, unet_model.ResSpec):
            _leaf(out, f"{p}.norm1", f"{k}.in_layers.0")
            _leaf(out, f"{p}.conv1", f"{k}.in_layers.2")
            _leaf(out, f"{p}.emb", f"{k}.emb_layers.1")
            _leaf(out, f"{p}.norm2", f"{k}.out_layers.0")
            _leaf(out, f"{p}.conv2", f"{k}.out_layers.3")
            if spec.in_ch != spec.out_ch:
                _leaf(out, f"{p}.skip", f"{k}.skip_connection")
        elif isinstance(spec, unet_model.AttnSpec):
            _leaf(out, f"{p}.norm", f"{k}.norm")
            _leaf(out, f"{p}.proj_in", f"{k}.proj_in")
            for d in range(spec.depth):
                bp, bk = f"{p}.blocks.{d}", f"{k}.transformer_blocks.{d}"
                for n in ("norm1", "norm2", "norm3"):
                    _leaf(out, f"{bp}.{n}", f"{bk}.{n}")
                for a in ("attn1", "attn2"):
                    for n in ("to_q", "to_k", "to_v"):
                        _leaf(out, f"{bp}.{a}.{n}", f"{bk}.{a}.{n}", bias=False)
                    _leaf(out, f"{bp}.{a}.to_out", f"{bk}.{a}.to_out.0")
                _leaf(out, f"{bp}.ff.proj", f"{bk}.ff.net.0.proj")
                _leaf(out, f"{bp}.ff.out", f"{bk}.ff.net.2")
            _leaf(out, f"{p}.proj_out", f"{k}.proj_out")
        elif isinstance(spec, unet_model.SampleSpec):
            # Downsample keeps its conv under .op, Upsample under .conv
            _leaf(out, f"{p}.conv", f"{k}.op" if spec.mode == "down" else f"{k}.conv")
        else:
            raise ValueError(spec)


def _unet_entries(cfg: unet_model.UNetConfig) -> List[Entry]:
    out: List[Entry] = []
    pre = UNET_PREFIX
    _leaf(out, "time_embed.fc1", f"{pre}.time_embed.0")
    _leaf(out, "time_embed.fc2", f"{pre}.time_embed.2")
    if cfg.adm_in_channels:  # SDXL's ADM MLP: Linear, SiLU, Linear
        _leaf(out, "label_emb.fc1", f"{pre}.label_emb.0.0")
        _leaf(out, "label_emb.fc2", f"{pre}.label_emb.0.2")
    inp, mid, outp = unet_model.build_plan(cfg)
    for i, b in enumerate(inp):
        _block_entries(out, f"input.{i}", f"{pre}.input_blocks.{i}", b)
    _block_entries(out, "middle", f"{pre}.middle_block", mid)
    for i, b in enumerate(outp):
        _block_entries(out, f"output.{i}", f"{pre}.output_blocks.{i}", b)
    _leaf(out, "out_norm", f"{pre}.out.0")
    _leaf(out, "out_conv", f"{pre}.out.2")
    return out


def unet_from_state(state: Mapping, unet: nn.Module) -> None:
    """Write the UNet of an SD or SDXL checkpoint into ``unet`` (a
    models.unet.UNet; its label_emb too when its config has ADM)."""
    _write(unet, state, _unet_entries(unet.cfg), "unet")


def unet_to_state(unet: nn.Module) -> Dict[str, torch.Tensor]:
    return _read(unet, _unet_entries(unet.cfg))


# ---------------------------------------------------------------------------
# ControlNet (lllyasviel/ControlNet's cldm layout)
# ---------------------------------------------------------------------------

def _controlnet_entries(cfg: unet_model.UNetConfig, prefix: str) -> List[Entry]:
    """The UNet's encoder-block names under ``prefix``; the hint convs at
    the even indices of input_hint_block (SiLUs between), the zero convs
    under zero_convs.{i}.0 and middle_block_out.0."""
    out: List[Entry] = []
    _leaf(out, "time_embed.fc1", f"{prefix}.time_embed.0")
    _leaf(out, "time_embed.fc2", f"{prefix}.time_embed.2")
    inp, mid, _ = unet_model.build_plan(cfg)
    for i, b in enumerate(inp):
        _block_entries(out, f"input.{i}", f"{prefix}.input_blocks.{i}", b)
    _block_entries(out, "middle", f"{prefix}.middle_block", mid)
    for i in range(len(cn_model._HINT_LADDER) + 1):
        _leaf(out, f"input_hint.{i}", f"{prefix}.input_hint_block.{2 * i}")
    for i in range(len(cn_model._skip_channels(cfg))):
        _leaf(out, f"zero_convs.{i}", f"{prefix}.zero_convs.{i}.0")
    _leaf(out, "middle_out", f"{prefix}.middle_block_out.0")
    return out


def controlnet_from_state(state: Mapping, controlnet: nn.Module,
                          prefix: str = CONTROLNET_PREFIX) -> None:
    """Write a ControlNet checkpoint (``control_model.*`` keys) into
    ``controlnet`` (a models.controlnet.ControlNet)."""
    _write(controlnet, state, _controlnet_entries(controlnet.cfg, prefix), "controlnet")


def controlnet_to_state(controlnet: nn.Module,
                        prefix: str = CONTROLNET_PREFIX) -> Dict[str, torch.Tensor]:
    return _read(controlnet, _controlnet_entries(controlnet.cfg, prefix))


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def _vae_entries(vae: nn.Module) -> List[Entry]:
    out: List[Entry] = []
    pre = VAE_PREFIX

    def resnet(p: str, k: str, block) -> None:
        for n in ("norm1", "conv1", "norm2", "conv2"):
            _leaf(out, f"{p}.{n}", f"{k}.{n}")
        if hasattr(block, "nin_shortcut"):
            _leaf(out, f"{p}.nin_shortcut", f"{k}.nin_shortcut")

    def mid(p: str, k: str, m) -> None:
        resnet(f"{p}.block_1", f"{k}.block_1", m.block_1)
        for n in ("norm", "q", "k", "v", "proj_out"):
            _leaf(out, f"{p}.attn_1.{n}", f"{k}.attn_1.{n}")
        resnet(f"{p}.block_2", f"{k}.block_2", m.block_2)

    enc, dec = vae.encoder, vae.decoder
    _leaf(out, "encoder.conv_in", f"{pre}.encoder.conv_in")
    for i, stage in enumerate(enc.down):
        for j, bp in enumerate(stage.block):
            resnet(f"encoder.down.{i}.block.{j}", f"{pre}.encoder.down.{i}.block.{j}", bp)
        if hasattr(stage, "downsample"):
            _leaf(out, f"encoder.down.{i}.downsample", f"{pre}.encoder.down.{i}.downsample.conv")
    mid("encoder.mid", f"{pre}.encoder.mid", enc.mid)
    _leaf(out, "encoder.norm_out", f"{pre}.encoder.norm_out")
    _leaf(out, "encoder.conv_out", f"{pre}.encoder.conv_out")
    _leaf(out, "decoder.conv_in", f"{pre}.decoder.conv_in")
    mid("decoder.mid", f"{pre}.decoder.mid", dec.mid)
    for i, stage in enumerate(dec.up):
        for j, bp in enumerate(stage.block):
            resnet(f"decoder.up.{i}.block.{j}", f"{pre}.decoder.up.{i}.block.{j}", bp)
        if hasattr(stage, "upsample"):
            _leaf(out, f"decoder.up.{i}.upsample", f"{pre}.decoder.up.{i}.upsample.conv")
    _leaf(out, "decoder.norm_out", f"{pre}.decoder.norm_out")
    _leaf(out, "decoder.conv_out", f"{pre}.decoder.conv_out")
    if vae.cfg.use_quant_conv:
        _leaf(out, "quant_conv", f"{pre}.quant_conv")
        _leaf(out, "post_quant_conv", f"{pre}.post_quant_conv")
    return out


def vae_from_state(state: Mapping, vae: nn.Module) -> None:
    """Write the VAE of an SD checkpoint into ``vae`` (a models.vae.AutoencoderKL)."""
    _write(vae, state, _vae_entries(vae), "vae")


def vae_to_state(vae: nn.Module) -> Dict[str, torch.Tensor]:
    return _read(vae, _vae_entries(vae))


# ---------------------------------------------------------------------------
# CLIP text encoder: HF layout (SD1.x) and OpenCLIP layout (SD2.x)
# ---------------------------------------------------------------------------

def _encoder_entries(out: List[Entry], num_layers: int, prefix: str) -> None:
    """HF CLIP's encoder layers (the text and the vision tower alike)."""
    for i in range(num_layers):
        p, k = f"layers.{i}", f"{prefix}.encoder.layers.{i}"
        _leaf(out, f"{p}.layer_norm1", f"{k}.layer_norm1")
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _leaf(out, f"{p}.self_attn.{n}", f"{k}.self_attn.{n}")
        _leaf(out, f"{p}.layer_norm2", f"{k}.layer_norm2")
        _leaf(out, f"{p}.mlp.fc1", f"{k}.mlp.fc1")
        _leaf(out, f"{p}.mlp.fc2", f"{k}.mlp.fc2")


def _clip_entries(cfg, prefix: str = CLIP_PREFIX) -> List[Entry]:
    out: List[Entry] = []
    out.append(("token_embedding.weight", f"{prefix}.embeddings.token_embedding.weight", None))
    out.append(("position_embedding.weight",
                f"{prefix}.embeddings.position_embedding.weight", None))
    _encoder_entries(out, cfg.num_layers, prefix)
    _leaf(out, "final_layer_norm", f"{prefix}.final_layer_norm")
    if cfg.projection_dim:
        # a sibling of text_model (CLIPTextModelWithProjection), (proj, dim)
        parent = prefix.rsplit(".text_model", 1)[0]
        _leaf(out, "text_projection", f"{parent}.text_projection", bias=False)
    return out


def clip_from_state(state: Mapping, clip: nn.Module, prefix: str = CLIP_PREFIX) -> None:
    """Write an HF-layout CLIP text tower into ``clip`` (a models.clip.CLIPTextModel)."""
    _write(clip, state, _clip_entries(clip.cfg, prefix), "clip")


def clip_to_state(clip: nn.Module, prefix: str = CLIP_PREFIX) -> Dict[str, torch.Tensor]:
    return _read(clip, _clip_entries(clip.cfg, prefix))


# ---------------------------------------------------------------------------
# CLIP vision tower: HF CLIPModel / CLIPVisionModelWithProjection layout
# ---------------------------------------------------------------------------

CLIP_VISION_PREFIX = "vision_model"


def _clip_vision_entries(cfg, prefix: str = CLIP_VISION_PREFIX) -> List[Entry]:
    """{prefix}.embeddings.{class_embedding, patch_embedding.weight (dim, 3,
    P, P: the port's OIHW), position_embedding.weight}, {prefix}.pre_layrnorm
    (HF's spelling) and post_layernorm, the encoder layers, and
    visual_projection.weight (proj, dim), a sibling of the tower."""
    out: List[Entry] = [("class_embedding", f"{prefix}.embeddings.class_embedding", None)]
    _leaf(out, "patch_embedding", f"{prefix}.embeddings.patch_embedding", bias=False)
    out.append(("position_embedding.weight",
                f"{prefix}.embeddings.position_embedding.weight", None))
    _leaf(out, "pre_layernorm", f"{prefix}.pre_layrnorm")
    _encoder_entries(out, cfg.num_layers, prefix)
    _leaf(out, "post_layernorm", f"{prefix}.post_layernorm")
    # "vision_model" -> "visual_projection", "x.vision_model" -> "x.visual_projection"
    parent = prefix[:-len("vision_model")] if prefix.endswith("vision_model") else ""
    _leaf(out, "visual_projection", f"{parent}visual_projection", bias=False)
    return out


def clip_vision_from_state(state: Mapping, vision: nn.Module,
                           prefix: str = CLIP_VISION_PREFIX) -> None:
    """Write the vision tower of an HF CLIPModel or
    CLIPVisionModelWithProjection state into ``vision`` (a
    models.clip_vision.CLIPVisionModel)."""
    _write(vision, state, _clip_vision_entries(vision.cfg, prefix), "clip_vision")


def clip_vision_to_state(vision: nn.Module,
                         prefix: str = CLIP_VISION_PREFIX) -> Dict[str, torch.Tensor]:
    return _read(vision, _clip_vision_entries(vision.cfg, prefix))


def _rows(i: int, d: int) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda t: t[i * d:(i + 1) * d]


def _openclip_entries(cfg, prefix: str) -> List[Entry]:
    out: List[Entry] = []
    d = cfg.dim
    out.append(("token_embedding.weight", f"{prefix}.token_embedding.weight", None))
    # a bare parameter in OpenCLIP
    out.append(("position_embedding.weight", f"{prefix}.positional_embedding", None))
    for i in range(cfg.num_layers):
        p, k = f"layers.{i}", f"{prefix}.transformer.resblocks.{i}"
        _leaf(out, f"{p}.layer_norm1", f"{k}.ln_1")
        for j, n in enumerate(("q_proj", "k_proj", "v_proj")):  # the fused (3d, d) in_proj
            out.append((f"{p}.self_attn.{n}.weight", f"{k}.attn.in_proj_weight", _rows(j, d)))
            out.append((f"{p}.self_attn.{n}.bias", f"{k}.attn.in_proj_bias", _rows(j, d)))
        _leaf(out, f"{p}.self_attn.out_proj", f"{k}.attn.out_proj")
        _leaf(out, f"{p}.layer_norm2", f"{k}.ln_2")
        _leaf(out, f"{p}.mlp.fc1", f"{k}.mlp.c_fc")
        _leaf(out, f"{p}.mlp.fc2", f"{k}.mlp.c_proj")
    _leaf(out, "final_layer_norm", f"{prefix}.ln_final")
    if cfg.projection_dim:
        # applied as x @ W: stored (in, out), the transpose of a Linear's
        out.append(("text_projection.weight", f"{prefix}.text_projection", lambda t: t.t()))
    return out


def openclip_from_state(state: Mapping, clip: nn.Module, prefix: str = OPENCLIP_PREFIX) -> None:
    """Write an OpenCLIP-layout text tower (fused in_proj, resblocks, ln_1
    / ln_2, c_fc / c_proj, ln_final, text_projection) into ``clip``."""
    _write(clip, state, _openclip_entries(clip.cfg, prefix), "openclip")


def openclip_to_state(clip: nn.Module, prefix: str = OPENCLIP_PREFIX) -> Dict[str, torch.Tensor]:
    """Inverse of openclip_from_state: q, k and v fused back into in_proj."""
    params = dict(clip.named_parameters())
    parts: Dict[str, List[torch.Tensor]] = {}
    for name, key, _ in _openclip_entries(clip.cfg, prefix):
        t = params[name].detach()
        parts.setdefault(key, []).append(t.t() if key.endswith(".text_projection") else t)
    # q, k and v, in that order, are the rows of a fused in_proj
    return {key: torch.cat(ts) if len(ts) > 1 else ts[0] for key, ts in parts.items()}


# ---------------------------------------------------------------------------
# The whole SD model
# ---------------------------------------------------------------------------

def sd_from_state(state: Mapping, model: nn.Module) -> None:
    """Write a whole SD1.x / SD2.x checkpoint into ``model`` (a
    pipeline.sd.StableDiffusion). The text encoder's layout is read from the
    keys: SD2.x keeps it in OpenCLIP's, SD1.x in HF's."""
    if any(k.startswith(OPENCLIP_PREFIX + ".") for k in state):
        openclip_from_state(state, model.clip)
    else:
        clip_from_state(state, model.clip)
    unet_from_state(state, model.unet)
    vae_from_state(state, model.vae)


def sd_state_from_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model as an SD checkpoint's flat dict (CLIP in HF layout, as the
    JAX package writes it)."""
    out = clip_to_state(model.clip)
    out.update(unet_to_state(model.unet))
    out.update(vae_to_state(model.vae))
    return out


# ---------------------------------------------------------------------------
# SDXL (sd_xl_base's layout)
# ---------------------------------------------------------------------------

def sdxl_params_from_state(state: Mapping, model: nn.Module) -> None:
    """Write an SDXL checkpoint into ``model`` (a
    pipeline.sdxl.StableDiffusionXL): CLIP-L in HF's layout, bigG in
    OpenCLIP's, the UNet with its label_emb, the VAE. The JAX package's
    clip_hf_* and sdxl_unet_* maps are clip_* under the SDXL prefix and
    unet_* here (the UNet map reads label_emb when the config has ADM)."""
    clip_from_state(state, model.clip_l, SDXL_CLIP_L_PREFIX)
    openclip_from_state(state, model.clip_g, SDXL_CLIP_G_PREFIX)
    unet_from_state(state, model.unet)
    vae_from_state(state, model.vae)


def sdxl_state_from_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model as an SDXL checkpoint's flat dict, the JAX package's
    layout."""
    out = clip_to_state(model.clip_l, SDXL_CLIP_L_PREFIX)
    out.update(openclip_to_state(model.clip_g, SDXL_CLIP_G_PREFIX))
    out.update(unet_to_state(model.unet))
    out.update(vae_to_state(model.vae))
    return out


# ---------------------------------------------------------------------------
# SD3 (sd3_medium*.safetensors, the single-file layout)
# ---------------------------------------------------------------------------

MMDIT_PREFIX = "model.diffusion_model"
SD3_CLIP_L_PREFIX = "text_encoders.clip_l.transformer.text_model"
SD3_CLIP_G_PREFIX = "text_encoders.clip_g.transformer.text_model"
T5_PREFIX = "text_encoders.t5xxl.transformer"


def _fused_qkv_from_torch(num_heads: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """torch's fused qkv rows [q | k | v] (a weight's (3d, in) or a bias's
    (3d,)) -> the head-interleaved rows [h0: q k v | h1: q k v | ...]."""
    def take(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(3, num_heads, -1, *t.shape[1:]).transpose(0, 1).reshape(t.shape)
    return take


def _fused_qkv_to_torch(num_heads: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """The inverse of _fused_qkv_from_torch."""
    def give(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(num_heads, 3, -1, *t.shape[1:]).transpose(0, 1).reshape(t.shape)
    return give


def _crop_pos_embed(pe: torch.Tensor, grid: int) -> torch.Tensor:
    """Centre crop of the stored (1, G*G, dim) learned pos-embed grid to
    (1, grid*grid, dim): SD3's cropped_pos_embed."""
    g2, dim = pe.shape[-2], pe.shape[-1]
    g = int(round(g2 ** 0.5))
    if g * g != g2:
        raise ValueError(f"pos_embed token count {g2} is not square")
    if grid > g:
        raise ValueError(f"target grid {grid} exceeds stored grid {g}")
    top = (g - grid) // 2
    crop = pe.reshape(g, g, dim)[top:top + grid, top:top + grid]
    return crop.reshape(1, grid * grid, dim)


def _mmdit_stream_entries(out: List[Entry], port: str, key: str, cfg, pre_only: bool) -> None:
    d, heads = cfg.dim, cfg.num_heads
    if pre_only:
        # (shift, scale) of the pre-attention LN only: the first 2d rows of
        # the 6d mod; the rest gate the stream's unread output and are zero
        pad = lambda t: torch.cat([t, t.new_zeros((4 * d, *t.shape[1:]))])  # noqa: E731
        first = lambda t: t[:2 * d]  # noqa: E731
        for n in ("weight", "bias"):
            out.append((f"{port}.mod.{n}", f"{key}.adaLN_modulation.1.{n}", pad, first))
    else:
        _leaf(out, f"{port}.mod", f"{key}.adaLN_modulation.1")
    for n in ("weight", "bias"):
        out.append((f"{port}.qkv.{n}", f"{key}.attn.qkv.{n}", _fused_qkv_from_torch(heads),
                    _fused_qkv_to_torch(heads)))
    if cfg.qk_norm:  # SD3.5: per-head RMS gains, shared across heads
        _leaf(out, f"{port}.ln_q", f"{key}.attn.ln_q", bias=False)
        _leaf(out, f"{port}.ln_k", f"{key}.attn.ln_k", bias=False)
    for p, k in (("proj", "attn.proj"), ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
        if pre_only:
            out.extend((f"{port}.{p}.{n}", None, None) for n in ("weight", "bias"))
        else:
            _leaf(out, f"{port}.{p}", f"{key}.{k}")


def _mmdit_entries(mmdit: nn.Module) -> List[Entry]:
    cfg, pre = mmdit.cfg, MMDIT_PREFIX
    out: List[Entry] = []
    _leaf(out, "patch_embed", f"{pre}.x_embedder.proj")
    _leaf(out, "context_embed", f"{pre}.context_embedder")
    _leaf(out, "time_mlp.fc1", f"{pre}.t_embedder.mlp.0")
    _leaf(out, "time_mlp.fc2", f"{pre}.t_embedder.mlp.2")
    _leaf(out, "pooled_mlp.fc1", f"{pre}.y_embedder.mlp.0")
    _leaf(out, "pooled_mlp.fc2", f"{pre}.y_embedder.mlp.2")
    for i in range(cfg.depth):
        k = f"{pre}.joint_blocks.{i}"
        _mmdit_stream_entries(out, f"blocks.{i}.img", f"{k}.x_block", cfg, False)
        _mmdit_stream_entries(out, f"blocks.{i}.txt", f"{k}.context_block", cfg,
                              i == cfg.depth - 1)
    _leaf(out, "final.mod", f"{pre}.final_layer.adaLN_modulation.1")
    _leaf(out, "final.proj", f"{pre}.final_layer.linear")
    if mmdit.pos_embed is not None:
        grid = cfg.input_size // cfg.patch_size
        out.append(("pos_embed", f"{pre}.pos_embed", lambda t: _crop_pos_embed(t, grid)))
    return out


def mmdit_from_state(state: Mapping, mmdit: nn.Module) -> None:
    """Write the MMDiT of an SD3 checkpoint into ``mmdit`` (a
    models.mmdit.MMDiT). The file's learned ``pos_embed``, when it has one,
    is centre-cropped to the model's grid, so the module must hold one
    (``MMDiT(learned_pos_embed=True)``); without the key the module must
    not, and computes the fixed sin-cos table."""
    if f"{MMDIT_PREFIX}.pos_embed" in state and mmdit.pos_embed is None:
        raise ValueError("mmdit: the checkpoint has a learned pos_embed, the module none "
                         "(make it with MMDiT(learned_pos_embed=True))")
    _write(mmdit, state, _mmdit_entries(mmdit), "mmdit")


def mmdit_to_state(mmdit: nn.Module) -> Dict[str, torch.Tensor]:
    """The MMDiT in SD3's layout: the pre-only last context_block without
    its proj, mlp and upper 4 mod chunks; a learned pos_embed as the model
    holds it (cropped), as the JAX package writes it."""
    return _read(mmdit, _mmdit_entries(mmdit))


def _t5_entries(cfg, prefix: str, embedding_key: str) -> List[Entry]:
    out: List[Entry] = [("token_embedding.weight", f"{prefix}.{embedding_key}", None)]
    # one relative-bias table for every layer, stored in block 0's attention
    out.append(("rel_bias.weight",
                f"{prefix}.encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
                None))
    for i in range(cfg.num_layers):
        p, k = f"layers.{i}", f"{prefix}.encoder.block.{i}.layer"
        _leaf(out, f"{p}.attn_norm", f"{k}.0.layer_norm", bias=False)
        for n in ("q", "k", "v", "o"):
            _leaf(out, f"{p}.attn.{n}", f"{k}.0.SelfAttention.{n}", bias=False)
        _leaf(out, f"{p}.ff_norm", f"{k}.1.layer_norm", bias=False)
        for n in ("wi_0", "wi_1", "wo"):
            _leaf(out, f"{p}.ff.{n}", f"{k}.1.DenseReluDense.{n}", bias=False)
    _leaf(out, "final_norm", f"{prefix}.encoder.final_layer_norm", bias=False)
    return out


def t5_from_state(state: Mapping, t5: nn.Module, prefix: str = T5_PREFIX) -> None:
    """Write an HF T5EncoderModel (SD3's t5xxl) into ``t5`` (a
    models.t5.T5Encoder). The embedding is ``shared.weight``, or
    ``encoder.embed_tokens.weight`` where an export stores only that."""
    emb = "shared.weight"
    if f"{prefix}.{emb}" not in state:
        emb = "encoder.embed_tokens.weight"
    _write(t5, state, _t5_entries(t5.cfg, prefix, emb), "t5")


def t5_to_state(t5: nn.Module, prefix: str = T5_PREFIX) -> Dict[str, torch.Tensor]:
    return _read(t5, _t5_entries(t5.cfg, prefix, "shared.weight"))


def sd3_params_from_state(state: Mapping, model: nn.Module) -> None:
    """Write an SD3 single-file checkpoint into ``model`` (a
    pipeline.sd3.StableDiffusion3): both CLIP towers in HF's layout with
    their text_projection, the MMDiT, the VAE and, where the model has a
    T5 tower and the file carries it, T5-XXL (a model whose file lacks it
    keeps its T5 as it was)."""
    clip_from_state(state, model.clip_l, SD3_CLIP_L_PREFIX)
    clip_from_state(state, model.clip_g, SD3_CLIP_G_PREFIX)
    mmdit_from_state(state, model.mmdit)
    vae_from_state(state, model.vae)
    if getattr(model, "t5", None) is not None and any(
            k.startswith(T5_PREFIX + ".") for k in state):
        t5_from_state(state, model.t5)


def sd3_state_from_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model as an SD3 single-file checkpoint's flat dict."""
    out = clip_to_state(model.clip_l, SD3_CLIP_L_PREFIX)
    out.update(clip_to_state(model.clip_g, SD3_CLIP_G_PREFIX))
    out.update(mmdit_to_state(model.mmdit))
    out.update(vae_to_state(model.vae))
    if getattr(model, "t5", None) is not None:
        out.update(t5_to_state(model.t5))
    return out
