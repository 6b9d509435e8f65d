"""Rotary position embedding over several position axes (FLUX's RoPE).

Each token carries one position per axis (FLUX: text tokens (0, 0, 0),
image tokens (0, row, col)). Axis i owns ``axes_dim[i]`` of the head's
channels, and rotates its pairs (2k, 2k+1) by the angle pos_i * w_k with
w_k = theta^(-2k / axes_dim[i]), k < axes_dim[i] / 2; the axes' pairs lie
side by side in axis order. The angles and their cosines and sines are
taken in float64 and kept in float32; the rotation is float32 and its
result is cast back to the input's dtype.

Plain torch ops: ``rope_table`` once per forward, ``apply_rope`` on q and
k of every attention that reads the table.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_table(ids: torch.Tensor, axes_dim: Sequence[int],
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids (N, len(axes_dim)) positions -> (cos, sin), each (N, sum(axes_dim) / 2)
    float32, the pairs of axis 0 first."""
    angles = []
    for i, d in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=ids.device) / d)
        angles.append(ids[:, i].double()[:, None] * omega[None])
    a = torch.cat(angles, dim=-1)
    return torch.cos(a).float(), torch.sin(a).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, N, H, D) rotated on its pairs (2k, 2k+1) by the table of
    ``rope_table`` (N, D / 2): (x0 cos - x1 sin, x0 sin + x1 cos)."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(x.shape).to(x.dtype)
