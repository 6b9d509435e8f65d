"""Diffusion Transformer, DiT-style (port of tinyfusers_tpu/models/dit.py).

A latent-space transformer denoiser: patchify -> ``depth`` identical
blocks with adaLN-Zero modulation -> unpatchify. The conditioning is the
timestep embedding, plus an optional class label (the null class is
``num_classes``, for CFG) and an optional pooled vector, through one MLP.
The JAX package stacks the blocks for ``lax.scan``; here ``blocks`` is an
``nn.ModuleList`` (io/from_jax.py splits the stacked leaves). The MMDiT
borrows ``_pos_embed_2d``, ``_modulate`` and ``split_fused_qkv``.

What is kept exactly as the JAX package does it: the fused qkv is
head-interleaved; the layer norms have no affine and eps 1e-5; the MLP is
``gelu_tanh``; the timestep embedding (models/unet.py, 256 wide) is cast
to x's dtype before the MLP; the sin-cos positions are added in the
tokens' dtype; ``mod`` and ``final`` start at zero (adaLN-Zero); the
unpatchify transpose is (0, 1, 3, 2, 4, 5). ``ops.packed_beneficial``
picks the attention's layout: on CUDA at >= 1024 tokens (DiT-XL/2 at
512x512: 16 heads of 72) the heads-packed flash kernel, below it (256
tokens at 256x256) and on the CPU the math route.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn

from .. import ops
from ..device import resolve_device
from .layers import Conv, Embedding, Linear, ZeroLinear, init_weights
from .unet import timestep_embedding


@dataclass(frozen=True)
class DiTConfig:
    input_size: int = 32          # latent H = W
    patch_size: int = 2
    in_channels: int = 4
    out_channels: int = 4
    dim: int = 1152               # DiT-XL/2
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: int = 4
    num_classes: int = 0          # >0: class-conditional (label embedding)
    cond_dim: int = 0             # >0: external cond vector (pooled text)

    @property
    def num_tokens(self) -> int:
        return (self.input_size // self.patch_size) ** 2


DIT_XL_2 = DiTConfig()
TINY_DIT = DiTConfig(input_size=8, patch_size=2, dim=64, depth=2, num_heads=4)


def _pos_embed_2d(tokens_per_side: int, dim: int,
                  device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """Fixed 2D sin-cos position embedding, (n*n, dim) fp32: the h half
    (sin then cos of the row index), repeated across each row's n tokens,
    then the w half (the same of the column index), tiled n times."""
    def _1d(pos, d):
        omega = torch.exp(-math.log(10000.0)
                          * torch.arange(d // 2, dtype=torch.float32, device=device)
                          / (d // 2))
        out = pos[:, None] * omega[None, :]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)

    n = tokens_per_side
    coords = torch.arange(n, dtype=torch.float32, device=device)
    emb = _1d(coords, dim // 2)  # (n, dim/2), the same for h and w
    return torch.cat([emb.repeat_interleave(n, dim=0), emb.repeat(n, 1)], dim=-1)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def split_fused_qkv(qkv: torch.Tensor, num_heads: int):
    """(B, T, 3*D) fused projection -> q, k, v, each (B, T, H, hd) views.

    The fused weight's output axis is HEAD-INTERLEAVED,
    ``[h0:(q,k,v) | h1:(q,k,v) | ...]``, not torch's ``[q | k | v]``: the
    JAX package lays it out so for tensor parallelism, and its checkpoint
    mappers permute at load.
    """
    b, t, d3 = qkv.shape
    hd = d3 // (3 * num_heads)
    qkv = qkv.reshape(b, t, num_heads, 3, hd)
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


class _Attn(nn.Module):
    def __init__(self, d: int, heads: int, **kw):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(d, 3 * d, **kw)
        self.proj = Linear(d, d, **kw)


class _MLP(nn.Module):
    def __init__(self, din: int, dhid: int, dout: int, **kw):
        super().__init__()
        self.fc1 = Linear(din, dhid, **kw)
        self.fc2 = Linear(dhid, dout, **kw)


class _Block(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        d = cfg.dim
        self.mod = ZeroLinear(d, 6 * d, **kw)  # shift / scale / gate x 2
        self.attn = _Attn(d, cfg.num_heads, **kw)
        self.mlp = _MLP(d, cfg.mlp_ratio * d, d, **kw)


class _Final(nn.Module):
    def __init__(self, cfg: DiTConfig, **kw):
        super().__init__()
        p = cfg.patch_size
        self.mod = ZeroLinear(cfg.dim, 2 * cfg.dim, **kw)
        self.proj = ZeroLinear(cfg.dim, p * p * cfg.out_channels, **kw)


class DiT(nn.Module):
    """The DiT's parameters, named after the JAX param tree; ``forward``
    is ``apply``.

    device defaults to "cuda" and raises without a GPU. seed fills the
    weights with the JAX init's distributions (the adaLN-Zero leaves
    zero), drawn on the device; seed=None leaves them empty for a loader
    (io/from_jax.load_dit)."""

    STACKED = ("blocks",)  # one stacked leaf per name in the JAX tree

    def __init__(self, cfg: DiTConfig = DIT_XL_2, *,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32, seed: Optional[int] = 0):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.cfg = cfg
        self.patch_embed = Conv(cfg.in_channels, cfg.dim, cfg.patch_size, **kw)
        self.time_mlp = _MLP(256, cfg.dim, cfg.dim, **kw)
        self.blocks = nn.ModuleList(_Block(cfg, **kw) for _ in range(cfg.depth))
        self.final = _Final(cfg, **kw)
        if cfg.num_classes:  # + 1: the null class, for CFG
            self.label_embed = Embedding(cfg.num_classes + 1, cfg.dim, **kw)
        if cfg.cond_dim:
            self.cond_proj = Linear(cfg.cond_dim, cfg.dim, **kw)
        if seed is not None:
            init_weights(self, seed)

    def forward(self, x, timesteps, *, labels=None, cond=None):
        return apply(self, x, timesteps, labels=labels, cond=cond)


def _block(p: _Block, x: torch.Tensor, c: torch.Tensor, cfg: DiTConfig) -> torch.Tensor:
    """x (B, T, D); c (B, D) conditioning."""
    b, t, _ = x.shape
    sh1, sc1, g1, sh2, sc2, g2 = p.mod(ops.silu(c)).chunk(6, dim=-1)
    h = _modulate(ops.layer_norm(x), sh1, sc1)  # adaLN: no learned affine
    # under tensor parallelism this rank's heads and their width
    heads = p.attn.heads
    d = heads * (cfg.dim // cfg.num_heads)
    q, k, v = split_fused_qkv(p.attn.qkv(h), heads)
    if ops.packed_beneficial(t, t, d, heads, x.element_size(), device=x.device):
        a = ops.sdpa_packed(q.reshape(b, t, d), k.reshape(b, t, d), v.reshape(b, t, d),
                            heads=heads)
    else:
        a = ops.sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        a = a.transpose(1, 2).reshape(b, t, d)
    x = x + g1[:, None, :] * p.attn.proj(a)
    h = _modulate(ops.layer_norm(x), sh2, sc2)
    h = p.mlp.fc2(ops.gelu_tanh(p.mlp.fc1(h)))
    return x + g2[:, None, :] * h


def apply(model: DiT, x: torch.Tensor, timesteps: torch.Tensor, *,
          labels: Optional[torch.Tensor] = None,
          cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, H, W, C) NHWC latents -> noise prediction, same shape.

    labels (B,) int class ids (num_classes = the null class); cond
    (B, cond_dim) external vector conditioning."""
    cfg = model.cfg
    b, h, w, _ = x.shape
    p = cfg.patch_size
    tokens = model.patch_embed(x, stride=p).reshape(b, -1, cfg.dim)
    tokens = tokens + _pos_embed_2d(h // p, cfg.dim, x.device).to(tokens.dtype)

    t_emb = timestep_embedding(timesteps, 256).to(x.dtype)
    c = model.time_mlp.fc2(ops.silu(model.time_mlp.fc1(t_emb)))
    if cfg.num_classes:
        if labels is None:
            raise ValueError("a class-conditional DiT needs labels")
        c = c + ops.embedding(labels, model.label_embed.weight)
    if cfg.cond_dim:
        if cond is None:
            raise ValueError("a DiT with cond_dim needs cond")
        c = c + model.cond_proj(cond.to(x.dtype))

    for blk in model.blocks:
        tokens = _block(blk, tokens, c, cfg)

    shift, scale = model.final.mod(ops.silu(c)).chunk(2, dim=-1)
    out = model.final.proj(_modulate(ops.layer_norm(tokens), shift, scale))
    # unpatchify: (B, h/p * w/p, p*p*C) -> (B, H, W, C)
    hp, wp = h // p, w // p
    out = out.reshape(b, hp, wp, p, p, cfg.out_channels)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, cfg.out_channels)
