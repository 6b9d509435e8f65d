"""2D convolution on NHWC activations with HWIO weights (port of
tinyfusers_tpu/ops/conv.py).

Convolution stays a library call here, as the JAX package leaves it to
XLA outside any Pallas kernel. The NHWC tensor goes to ``F.conv2d`` as
its NCHW ``permute`` view, which is already channels_last in memory, so
no layout copy is made around the call. The bias goes into the same call.
In fp32 that is the JAX package's arithmetic; in bf16 the library rounds
where it rounds, which can differ from the JAX package's single rounding
of the fp32 sum plus bias by one bf16 ulp. The 9-shifted-GEMM route of the JAX package is a TPU layout choice and is
not ported.

Quantized weights, as in the JAX package: a ``QuantizedTensor`` (per
output channel) convolves with its values in the compute dtype and no
bias, then the output is multiplied by the scales and the bias is added,
in fp32. In bf16 the library's output is rounded once before the scale,
where the JAX package rounds only the final fp32 sum, so the two may differ
by 2^-8 of the scaled sum beyond the last rounding; the library call
keeps the bf16 tensor cores, which an fp32 conv would give up. An
``Int4Tensor`` (packed along the input channels, HWIO axis 2) is
dequantized to the compute dtype and convolved like a dense weight.

Row invariance: cuDNN may split a convolution's sums by output tile, so
that the same batch row rounds differently at another position in the
batch (on the H100, SD1.5's 3x3 convs with 1280 output channels at 16x16
and 32x32, batch 8). Under a ``RowInvariance`` (the serving engine's, so
that a request's image does not depend on its slot) each conv2d call shape
is probed once, and a shape whose rows move with their position runs one
row at a time.
"""
from __future__ import annotations

import contextvars
import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .quant import Int4Tensor, QuantizedTensor

PadLike = Union[int, Sequence[int]]


def _normalize_padding(padding: PadLike) -> Tuple[int, int, int, int]:
    """int p, (ph, pw) or (top, bottom, left, right) -> (t, b, l, r)."""
    if isinstance(padding, int):
        return (padding,) * 4
    padding = tuple(padding)
    if len(padding) == 2:
        return (padding[0], padding[0], padding[1], padding[1])
    if len(padding) == 4:
        return padding
    raise ValueError(f"bad padding {padding}")


_row_invariance: contextvars.ContextVar = contextvars.ContextVar("row_invariance",
                                                                default=None)


class RowInvariance:
    """``with policy:`` makes every conv2d call inside compute each batch row
    as it would at any other position in the batch. A call shape is probed
    the first time it is seen: the conv of seeded random rows, rolled by one
    row, against the conv of the rolled rows; where they differ, that shape
    runs one row at a time from then on. The probe reads a result back to
    the host, so a caller that must not wait for the device runs its calls
    once under the policy beforehand. ``apart`` maps each probed shape to
    whether it runs row by row."""

    def __init__(self):
        self.apart: Dict[tuple, bool] = {}

    def __enter__(self) -> "RowInvariance":
        self._token = _row_invariance.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _row_invariance.reset(self._token)

    def rows_apart(self, key: tuple, run, x: torch.Tensor) -> bool:
        if key not in self.apart:
            g = torch.Generator(device=x.device).manual_seed(0)
            rows = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
            self.apart[key] = not torch.equal(run(rows.roll(1, 0)), run(rows).roll(1, 0))
        return self.apart[key]


def conv2d(
    x: torch.Tensor,
    w,
    b: Optional[torch.Tensor] = None,
    *,
    stride: Union[int, Tuple[int, int]] = 1,
    padding: PadLike = 0,
    compute_dtype=None,
) -> torch.Tensor:
    """x (N, H, W, Cin), w (kh, kw, Cin, Cout) -> (N, H', W', Cout); w may
    be a QuantizedTensor or an Int4Tensor of that shape."""
    run = functools.partial(_conv2d, w=w, b=b, stride=stride, padding=padding,
                            compute_dtype=compute_dtype)
    policy = _row_invariance.get()
    if policy is not None and x.shape[0] > 1:
        key = (tuple(x.shape), tuple(w.shape), stride, _normalize_padding(padding),
               x.dtype, compute_dtype, x.device)
        if policy.rows_apart(key, run, x):
            return torch.cat([run(x[i:i + 1]) for i in range(x.shape[0])])
    return run(x)


def _conv2d(x: torch.Tensor, w, b, *, stride, padding, compute_dtype) -> torch.Tensor:
    cd = compute_dtype or x.dtype
    if isinstance(w, Int4Tensor):
        w = w.dequantize(cd)
    scales = None
    if isinstance(w, QuantizedTensor):
        scales, w = w.scales, w.values
    t, bt, l, r = _normalize_padding(padding)
    xc = x.to(cd).permute(0, 3, 1, 2)
    wc = w.to(cd).permute(3, 2, 0, 1)
    if t == bt and l == r:
        pad = (t, l)
    else:
        xc = F.pad(xc, (l, r, t, bt))
        pad = 0
    call_bias = None if b is None or scales is not None else b.to(cd)
    y = F.conv2d(xc, wc, call_bias, stride=stride, padding=pad).permute(0, 2, 3, 1)
    if scales is not None:
        y = y.float() * scales.reshape(-1).float()
        if b is not None:
            y = y + b.float()
        y = y.to(cd)
    return y.contiguous()


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, h * 2, w * 2, c)
