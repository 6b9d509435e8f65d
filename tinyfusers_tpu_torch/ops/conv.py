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
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

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


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: Union[int, Tuple[int, int]] = 1,
    padding: PadLike = 0,
    compute_dtype=None,
) -> torch.Tensor:
    """x (N, H, W, Cin), w (kh, kw, Cin, Cout) -> (N, H', W', Cout)."""
    cd = compute_dtype or x.dtype
    t, bt, l, r = _normalize_padding(padding)
    xc = x.to(cd).permute(0, 3, 1, 2)
    wc = w.to(cd).permute(3, 2, 0, 1)
    if t == bt and l == r:
        pad = (t, l)
    else:
        xc = F.pad(xc, (l, r, t, bt))
        pad = 0
    y = F.conv2d(xc, wc, None if b is None else b.to(cd), stride=stride,
                 padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, h * 2, w * 2, c)
