"""Fused GEGLU -> output projection: y = (gx * gelu(gate)) @ w + b (port
of tinyfusers_tpu/kernels/geglu_ff.py).

``geglu_matmul`` replaces the Pallas ``_kernel``: for a CUDA tensor it
launches a hand-written kernel in ``csrc/geglu_ff.cu``, for a CPU tensor
it computes ``geglu_matmul_plain``. A CUDA tensor the kernels do not take
raises; nothing falls back. ``geglu_matmul.launches`` counts its
launches, ``.shapes`` counts them by call shape and ``.variants`` by
kernel variant.

The kernel comes from ``_plan``, a shape rule: ``wgmma`` (TMA ring, h
formed in wgmma's register A fragment, 64-row by 160- or 320-column output
tiles so that h is formed once per tile row band, split-K over a thread
block cluster for shapes whose tiles do not fill the card) for bf16 where TMA
reads the operands in place, which every SD1.5 FF shape satisfies;
``mma`` (mma.sync, masked loads) for the other bf16 shapes; ``fma``
(exact fp32) for fp32. A bf16 or fp32 bias goes to ``wgmma`` as it is.

Semantics, as in the Pallas kernel: the GELU is fp32 with the
Abramowitz-Stegun 7.1.26 erf (within 1.5e-7 of the exact erf), the
product is rounded to gx's dtype before the matrix product, accumulation
and bias are fp32, the output is in gx's dtype.

``geglu_matmul_diff`` (the JAX package's ``geglu_matmul_diff``) gives
gradients to gx, gate, w and b: its forward is ``geglu_matmul``, its
backward recomputes a = ops.activations.geglu(gx, gate) with the exact
erf GELU (not the kernel's polynomial, as the JAX backward does) and forms
da = g w^T with fp32 sums rounded to a's dtype, dw = a^T g in fp32
rounded to w's dtype and db summed in fp32 and rounded once to b's dtype.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from . import _build
from .quant_matmul import _kernel_bias


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


# (variant, dtype, gx, gate, lda, wt, bias, bias dtype, out, M, N, K, bn, split,
#  stream)
_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
         + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
         + [ctypes.c_void_p])
# variant -> the code tf_geglu_ff takes.
_VARIANTS = {"fma": 0, "mma": 1, "wgmma": 2}
_K_STEP = 64
# wgmma's plan, fitted to times of every (bn, split) at the four SD1.5 FF
# shapes on an H100 (tools/kernel_ab.py --kernel geglu --sweep): one block
# an SM of 64 rows, the widest column tile (h formed once per 320 columns)
# that gives about 100 blocks with K split at most twice, else 160 columns;
# where even that leaves the card half empty, K split up to 4 ways within
# one wave of blocks.
_BLOCKS = 100
_SMS = 132


def _plan(dtype, m: int, k: int, n: int, aligned: bool = True):
    """(variant, bn, split) of the kernel for gx, gate (m, k) and w (k, n).

    fp32 goes to the exact FMA kernel. bf16 goes to ``wgmma`` where TMA can
    read the operands in place: K % 64 == 0 (whole 64-deep steps), N % 8 ==
    0 (the output's rows) and ``aligned`` (16-byte aligned pointers and a
    row stride of gx and gate that is a multiple of 8 elements). Every
    SD1.5 FF shape (K = 1280 .. 5120, N = 320 .. 1280) is one. Other bf16
    shapes run the ``mma`` kernel. ``wgmma`` forms h once per ``bn`` output
    columns (r = ceil(n / bn) times in all) over blocks of 64 rows, and
    splits K 2 or 4 ways (never more than its 64-deep steps) where the
    output tiles do not fill the card. bn is 0 and split 1 outside
    ``wgmma``."""
    if dtype == torch.float32:
        return "fma", 0, 1
    if not (aligned and k % _K_STEP == 0 and n % 8 == 0):
        return "mma", 0, 1
    steps = k // _K_STEP
    for bn in (320, 160) if n > 160 else (160,):
        tiles = -(-m // 64) * -(-n // bn)
        for split in (1, 2):
            if split <= steps and tiles * split >= _BLOCKS:
                return "wgmma", bn, split
    split = 1
    while split < 4 and 2 * split <= steps and 2 * split * tiles <= _SMS:
        split *= 2
    return "wgmma", 160, split


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
    dtype = _build.dtype_code(gx.dtype)
    *lead, k = gx.shape
    n = w.shape[1]
    x2 = gx.reshape(-1, k)
    g2 = gate.reshape(-1, k)
    if x2.stride(1) != 1 or g2.stride(1) != 1 or x2.stride(0) != g2.stride(0):
        x2, g2 = x2.contiguous(), g2.contiguous()
    m = x2.shape[0]
    wt = w.t().contiguous()  # (N, K): a module's own (out, in) weight, no copy
    aligned = x2.stride(0) % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (x2, g2, wt))
    variant, bn, split = _plan(gx.dtype, m, k, n, aligned)
    bias = _kernel_bias(b, gx, variant)
    out = torch.empty((m, n), dtype=gx.dtype, device=gx.device)
    _build.entry("geglu_ff", "tf_geglu_ff", _ARGS)(
        _VARIANTS[variant], dtype, x2.data_ptr(), g2.data_ptr(), x2.stride(0), wt.data_ptr(),
        None if bias is None else bias.data_ptr(),
        _build.dtype_code(torch.float32 if bias is None else bias.dtype), out.data_ptr(),
        m, n, k, bn, split, torch.cuda.current_stream(gx.device).cuda_stream)
    geglu_matmul.launches += 1
    geglu_matmul.shapes[(m, k, n)] += 1
    geglu_matmul.variants[variant] += 1
    return out.reshape(*lead, n)


geglu_matmul.launches = 0
geglu_matmul.shapes = collections.Counter()  # (M, K, N) -> launches
geglu_matmul.variants = collections.Counter()  # "wgmma" | "mma" | "fma" -> launches


class _GegluMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gx, gate, w, b):
        ctx.save_for_backward(gx, gate, w)
        ctx.b_dtype = None if b is None else b.dtype
        return geglu_matmul(gx, gate, w, b)

    @staticmethod
    def backward(ctx, g):
        from ..ops.activations import geglu

        gx, gate, w = ctx.saved_tensors
        k, n = w.shape
        g2 = g.reshape(-1, n).float()
        with torch.enable_grad():
            leaves = [gx.detach().requires_grad_(), gate.detach().requires_grad_()]
            a = geglu(*leaves)
            da = (g2 @ w.to(g.dtype).float().t()).to(a.dtype).reshape(a.shape)
            dgx, dgate = torch.autograd.grad(a, leaves, da)
        a2 = a.detach().reshape(-1, k)
        dw = (a2.float().t() @ g2.to(a.dtype).float()).to(w.dtype)
        db = None if ctx.b_dtype is None else g2.sum(dim=0).to(ctx.b_dtype)
        return dgx, dgate, dw, db


def geglu_matmul_diff(gx: torch.Tensor, gate: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``geglu_matmul`` with gradients to gx, gate, w and b."""
    return _GegluMatmul.apply(gx, gate, w, b)
