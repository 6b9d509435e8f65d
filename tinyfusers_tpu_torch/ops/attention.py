"""Scaled dot-product attention (port of tinyfusers_tpu/ops/attention.py).

Two routes, dispatched as the JAX package does with "on the TPU" read as
"tensor on CUDA" (``impl=None``; ``impl`` "xla" asks for the math route,
"flash" for the kernels, "ring[:seq_axis[,batch_axis]]" for ring attention
over the ambient mesh, parallel/ring_attention.py):

- ``sdpa_math``: plain math, softmax(scale * q @ k^T + mask) @ v with
  fp32 logits and statistics (the JAX package's ``sdpa_xla``);
- the hand-written flash kernels (kernels/flash_attention.py), taken for
  CUDA tensors when there is no mask and Sq >= 1024 (the UNet's 64x64 and
  32x32 levels, the VAE's mid attention, the MMDiT's joint attention).
  CLIP's 77 tokens with their causal mask, T5's with their position bias,
  and the UNet's 16x16 and 8x8 levels take the math route. The kernel
  route goes through the kernels' autograd Functions, so training
  differentiates through it (the JAX package's ``_flash_packed_diff`` /
  ``_flash_bhsd_diff``): the kernel forward, the math route's gradient.

The JAX package's ``packed_ok`` / ``packed_multik_ok`` and block tables
are TPU VMEM bounds, not semantics: on the GPU every packed call with
Sq >= 1024 takes the packed kernel. ``packed_beneficial`` is the models'
choice of layout (models/mmdit.py asks it for the joint attention): true
on CUDA when the heads-packed kernel applies, false on the CPU, as the
JAX function is false off the TPU, so on the CPU both packages take the
bhsd math route.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..kernels.flash_attention import flash_bhsd_diff, flash_packed_diff


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


def packed_beneficial(sq: int, sk: int, channels: int, heads: int,
                      itemsize: int = 2, *,
                      device: Union[str, torch.device]) -> bool:
    """Whether a model should hand ``sdpa_packed`` channel-packed
    activations on ``device``: a CUDA device, Sq >= 1024 and whole heads.
    sk and itemsize fed the TPU's VMEM bounds and do not matter here."""
    return (torch.device(device).type == "cuda" and sq >= 1024
            and channels % heads == 0)


def _route(q: torch.Tensor, mask, impl: Optional[str]) -> str:
    if impl is None:
        return "flash" if _takes_kernel(q, mask) else "xla"
    if impl in ("xla", "flash") or impl.startswith("ring"):
        return impl
    raise ValueError(f"sdpa: unknown impl {impl!r}")


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
    impl: Optional[str] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """SDPA over channel-packed activations: q (B, Sq, H*d), k/v
    (B, Sk, H*d) -> (B, Sq, H*d). kv_len: real key count of padded k/v.
    The kernel route takes the packed layout as it is; the others unpack
    to (B, H, S, d), go through ``sdpa`` and pack back."""
    route = _route(q, None, impl)
    if route == "flash":
        return flash_packed_diff(q, k, v, heads=heads, scale=scale, kv_len=kv_len)
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // heads
    unpack = lambda x, s: x.reshape(b, s, heads, d).transpose(1, 2)  # noqa: E731
    o = sdpa(unpack(q, sq), unpack(k, sk), unpack(v, sk), scale=scale, impl=route,
             kv_len=kv_len)
    return o.transpose(1, 2).reshape(b, sq, c)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Dispatching SDPA over (..., S, D): impl None | "xla" | "flash" |
    "ring[:seq_axis[,batch_axis]]" (ring attention, no mask or kv_len)."""
    route = _route(q, mask, impl)
    if route == "flash":
        if mask is not None:
            raise ValueError("sdpa: the flash kernels take kv_len, not a mask")
        return flash_bhsd_diff(q, k, v, scale=scale, kv_len=kv_len)
    if route.startswith("ring"):
        from ..parallel.ring_attention import ring_sdpa

        if mask is not None or kv_len is not None:
            raise ValueError("ring attention takes no mask and no kv_len")
        return ring_sdpa(q, k, v, route, scale=scale)
    return _math(q, k, v, mask, scale, kv_len)
