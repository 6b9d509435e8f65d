"""Weight-only quantization containers, INT8 / FP8 / INT4 (port of
tinyfusers_tpu/ops/quant.py).

The quantizers repeat the JAX package's arithmetic step for step: fp32
absmax, scale = max(absmax / qmax, 1e-12), ``w / scale``, round half to
even, clip to +-127 (int8) or +-7 (int4), the int4 group size clipped to
the packed axis, nibbles packed ``lo | hi << 4``. The values, packed
bytes and scales are bit-identical to the JAX package's for the same
input, as it runs them: eagerly, the way ``quantize_params`` is called.
(Under ``jax.jit`` XLA turns ``absmax / qmax`` into a product with the
fp32 reciprocal of qmax, which moves some scales by one ulp.)

Layout. The containers carry the JAX package's logical shapes, so the
ops and the tests see what the JAX package sees: a linear weight
(in, out) = (K, N) with per-output scales (1, N), or packed along K as
(K/2, N) with scales (K/g, N); a conv weight HWIO. The storage is torch's
order, the one the kernels read: a linear's values (N, K) with K
contiguous, its int4 bytes (N, K/2) and scales (N, K/g); a conv's OIHW.
A model's containers (``models/layers.py``) are transposed views of that
storage, so ``values.t()``, ``packed.t()`` and ``scales.t()`` are the
kernels' operands without a copy. A container built from a contiguous
(K, N) tensor works as well; the kernel wrapper then copies it into that
order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


class QuantizedTensor(NamedTuple):
    """values: int8 or float8 tensor with the weight's logical shape.
    scales: float32, keepdims along every axis but the channel axis, so
    dequantization is ``values * scales``."""

    values: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self):
        return tuple(self.values.shape)

    @property
    def dtype(self):
        return self.values.dtype

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.values.float() * self.scales).to(dtype)


def quantize(w: torch.Tensor, dtype=torch.int8, axis: int = -1) -> QuantizedTensor:
    """Symmetric per-channel quantization; ``axis`` keeps its resolution
    (axis=-1 on an (in, out) linear weight: per output channel)."""
    if dtype not in _QMAX:
        raise ValueError(f"unsupported quant dtype {dtype}")
    w = w.float()
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    absmax = w.abs().amax(dim=reduce_axes, keepdim=True)
    scale = torch.clamp_min(absmax / _QMAX[dtype], 1e-12)
    q = w / scale
    if dtype == torch.int8:
        q = torch.clamp(torch.round(q), -127.0, 127.0)
    return QuantizedTensor(values=q.to(dtype), scales=scale)


class Int4Tensor:
    """Two 4-bit values per uint8 byte, paired along ``axis`` (byte r holds
    rows 2r in its low and 2r+1 in its high nibble), with symmetric fp32
    scales per ``group_size`` rows of that axis."""

    def __init__(self, packed: torch.Tensor, scales: torch.Tensor, *, axis: int,
                 group_size: int, orig_dim: int):
        self.packed = packed      # uint8, axis dim = orig_dim // 2
        self.scales = scales      # fp32,  axis dim = orig_dim // group_size
        self.axis = axis
        self.group_size = group_size
        self.orig_dim = orig_dim

    @property
    def shape(self):
        s = list(self.packed.shape)
        s[self.axis] = self.orig_dim
        return tuple(s)

    @property
    def ndim(self):
        return self.packed.ndim

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        ax = self.axis % self.packed.ndim
        p = self.packed.to(torch.int16)
        lo = ((p & 0xF) ^ 8) - 8
        hi = (((p >> 4) & 0xF) ^ 8) - 8
        shape = self.shape
        q = torch.stack([lo, hi], dim=ax + 1).reshape(shape).float()
        g = self.group_size
        grouped = shape[:ax] + (shape[ax] // g, g) + shape[ax + 1:]
        q = q.reshape(grouped) * self.scales.unsqueeze(ax + 1)
        return q.reshape(shape).to(dtype)


def quantize_int4(w: torch.Tensor, axis: int = 0, group_size: int = 64) -> Int4Tensor:
    """Symmetric per-group INT4, packed along ``axis`` (the contraction
    axis: 0 for (in, out) linears, 2 for HWIO convs). The group size is
    clipped to the axis length and halved until it divides it."""
    w = w.float()
    ax = axis % w.ndim
    k = w.shape[ax]
    if k % 2:
        raise ValueError(f"int4 pack axis must be even, got {k}")
    g = min(group_size, k)
    while k % g:
        g //= 2
    shape = tuple(w.shape)
    wg = w.reshape(shape[:ax] + (k // g, g) + shape[ax + 1:])
    absmax = wg.abs().amax(dim=ax + 1)
    scale = torch.clamp_min(absmax / 7.0, 1e-12)
    q = torch.clamp(torch.round(wg / scale.unsqueeze(ax + 1)), -7.0, 7.0)
    qp = q.to(torch.int16).reshape(shape[:ax] + (k // 2, 2) + shape[ax + 1:])
    lo, hi = qp.select(ax + 1, 0), qp.select(ax + 1, 1)
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8)
    return Int4Tensor(packed, scale, axis=ax, group_size=g, orig_dim=k)


def dequantize(w, dtype=torch.float32) -> torch.Tensor:
    """A dense tensor of a quantized weight's logical shape (a dense
    weight is returned cast to ``dtype``)."""
    return w.dequantize(dtype) if is_quantized(w) else w.to(dtype)


def is_quantized(x) -> bool:
    return isinstance(x, (QuantizedTensor, Int4Tensor))
