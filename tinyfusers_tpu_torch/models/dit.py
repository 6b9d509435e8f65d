"""Pieces of the diffusion transformer that the MMDiT uses (port of
tinyfusers_tpu/models/dit.py: ``_pos_embed_2d``, ``_modulate``,
``split_fused_qkv``). The DiT model itself is a later part of the port.
"""
from __future__ import annotations

import math
from typing import Union

import torch


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
