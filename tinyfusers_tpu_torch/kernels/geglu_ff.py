"""Fused GEGLU -> output projection: y = (gx * gelu(gate)) @ w + b (port
of tinyfusers_tpu/kernels/geglu_ff.py).

``geglu_matmul`` replaces the Pallas ``_kernel``: for a CUDA tensor it
launches the hand-written kernel in ``csrc/geglu_ff.cu``, for a CPU
tensor it computes ``geglu_matmul_plain``. A CUDA tensor the kernel does
not take raises; it never falls back. ``geglu_matmul.launches`` counts its
launches and ``geglu_matmul.shapes`` counts them by call shape.

Semantics, as in the Pallas kernel: the GELU is fp32 with the
Abramowitz-Stegun 7.1.26 erf (within 1.5e-7 of the exact erf), the
product is rounded to gx's dtype before the matrix product, accumulation
and bias are fp32, the output is in gx's dtype.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from . import _build


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 erf, as the kernels compute it."""
    s = torch.sign(x)
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t
             - 0.284496736) * t + 0.254829592) * t
    return s * (1.0 - poly * torch.exp(-a * a))


def geglu_matmul_plain(gx: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel; same arguments."""
    g = gate.float()
    a = gx.float() * (0.5 * g * (1.0 + erf_as(g * 0.7071067811865476)))
    y = torch.matmul(a.to(gx.dtype).float(), w.float())
    if b is not None:
        y = y + b.float()
    return y.to(gx.dtype)


# (dtype, gx, gate, lda, wt, bias, out, M, N, K, stream)
_ARGS = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
         + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def geglu_matmul(gx: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(gx * gelu_erf(gate)) @ w + b.

    gx/gate (..., K); w (K, N); b (N,) or None -> (..., N) in gx's dtype.
    gx and gate may be strided views (the two halves of the FF projection's
    output): the kernel reads them through their row stride.
    """
    if gate.shape != gx.shape or w.dim() != 2 or w.shape[0] != gx.shape[-1]:
        raise ValueError(f"geglu_matmul: gx {tuple(gx.shape)}, gate "
                         f"{tuple(gate.shape)}, w {tuple(w.shape)}")
    if not gx.is_cuda:
        return geglu_matmul_plain(gx, gate, w, b)
    if not (gate.device == gx.device == w.device):
        raise ValueError("geglu_matmul: gx, gate and w must be on one CUDA device")
    if not (gate.dtype == gx.dtype == w.dtype):
        raise TypeError(f"geglu_matmul: mixed dtypes {gx.dtype} {gate.dtype} {w.dtype}")
    *lead, k = gx.shape
    n = w.shape[1]
    x2 = gx.reshape(-1, k)
    g2 = gate.reshape(-1, k)
    if x2.stride(1) != 1 or g2.stride(1) != 1 or x2.stride(0) != g2.stride(0):
        x2, g2 = x2.contiguous(), g2.contiguous()
    m = x2.shape[0]
    wt = w.t().contiguous()  # (N, K): a module's own (out, in) weight, no copy
    bias = None if b is None else b.to(device=gx.device, dtype=torch.float32).contiguous()
    out = torch.empty((m, n), dtype=gx.dtype, device=gx.device)
    _build.entry("geglu_ff", "tf_geglu_ff", _ARGS)(
        _build.dtype_code(gx.dtype), x2.data_ptr(), g2.data_ptr(), x2.stride(0),
        wt.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        m, n, k, torch.cuda.current_stream(gx.device).cuda_stream)
    geglu_matmul.launches += 1
    geglu_matmul.shapes[(m, k, n)] += 1
    return out.reshape(*lead, n)


geglu_matmul.launches = 0
geglu_matmul.shapes = collections.Counter()  # (M, K, N) -> launches
