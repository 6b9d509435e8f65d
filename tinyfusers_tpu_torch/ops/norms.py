"""LayerNorm and GroupNorm on channels-last input (port of
tinyfusers_tpu/ops/norms.py).

Statistics are fp32 and use the single-pass variance E[x^2] - E[x]^2
(clamped at 0), as the JAX package does, not torch's Welford kernels.
eps is passed per call site: 1e-5 for the UNet ResBlocks, 1e-6 for the
SpatialTransformer and every VAE norm.
"""
from __future__ import annotations

from typing import Optional

import torch


def _affine(y: torch.Tensor, weight, bias) -> torch.Tensor:
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    ex2 = xf.square().mean(dim=-1, keepdim=True)
    var = torch.clamp(ex2 - mean.square(), min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return _affine(y, weight, bias).to(x.dtype)


def group_norm(
    x: torch.Tensor,
    num_groups: int,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over channels-last input (N, ..., C), fp32 statistics.

    Group g covers channels [g*C/G, (g+1)*C/G) over all spatial positions:
    per-channel sums first, then the tiny (N, C) moments are combined per
    group, as in the JAX package.
    """
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xf = x.reshape(n, -1, c).float()
    hw = xf.shape[1]
    cpg = c // num_groups
    cnt = float(hw * cpg)
    s1 = xf.sum(dim=1).reshape(n, num_groups, cpg).sum(-1)
    s2 = xf.square().sum(dim=1).reshape(n, num_groups, cpg).sum(-1)
    mean_g = s1 / cnt
    var_g = torch.clamp(s2 / cnt - mean_g.square(), min=0.0)
    rstd_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(cpg, dim=1)[:, None, :]
    rstd_c = rstd_g.repeat_interleave(cpg, dim=1)[:, None, :]
    y = ((xf - mean_c) * rstd_c).reshape(x.shape)
    return _affine(y, weight, bias).to(x.dtype)
