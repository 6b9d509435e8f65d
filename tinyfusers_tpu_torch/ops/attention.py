"""Scaled dot-product attention (port of tinyfusers_tpu/ops/attention.py).

Two routes, dispatched as the JAX package does with "on the TPU" read as
"tensor on CUDA":

- ``sdpa_math``: plain math, softmax(scale * q @ k^T + mask) @ v with
  fp32 logits and statistics (the JAX package's ``sdpa_xla``);
- the hand-written flash kernels (kernels/flash_attention.py), taken for
  CUDA tensors when there is no mask and Sq >= 1024 (the UNet's 64x64 and
  32x32 levels, the VAE's mid attention). CLIP's 77 tokens with their
  causal mask and the UNet's 16x16 and 8x8 levels take the math route.

The JAX package's ``packed_ok`` and block tables are TPU VMEM bounds, not
semantics: on the GPU every packed call with Sq >= 1024 takes the packed
kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention import flash_bhsd, flash_packed


def sdpa_math(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(scale * q @ k^T + mask) @ v over (..., S, D).

    mask broadcasts to (..., Sq, Sk): additive, or boolean (True = keep).
    """
    dtype = q.dtype
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights.to(dtype).float(), v.float()).to(dtype)


def _takes_kernel(q: torch.Tensor, mask) -> bool:
    return q.is_cuda and mask is None and q.shape[-2] >= 1024


def _math(q, k, v, mask, scale, kv_len) -> torch.Tensor:
    if kv_len is not None:
        k = k[..., :kv_len, :]
        v = v[..., :kv_len, :]
    return sdpa_math(q, k, v, mask, scale=scale)


def sdpa_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    heads: int,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """SDPA over channel-packed activations: q (B, Sq, H*d), k/v
    (B, Sk, H*d) -> (B, Sq, H*d). kv_len: real key count of padded k/v."""
    if _takes_kernel(q, None):
        return flash_packed(q, k, v, heads=heads, scale=scale, kv_len=kv_len)
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // heads
    unpack = lambda x, s: x.reshape(b, s, heads, d).transpose(1, 2)  # noqa: E731
    o = _math(unpack(q, sq), unpack(k, sk), unpack(v, sk), None, scale, kv_len)
    return o.transpose(1, 2).reshape(b, sq, c)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Dispatching SDPA over (..., S, D): the bhsd kernel or the math."""
    if _takes_kernel(q, mask):
        return flash_bhsd(q, k, v, scale=scale, kv_len=kv_len)
    return _math(q, k, v, mask, scale, kv_len)
