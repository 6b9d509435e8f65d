"""Weight-only quantized matmuls: y = (x @ w_q) * scales + b (port of
tinyfusers_tpu/kernels/quant_matmul.py).

``quant_matmul`` replaces the Pallas ``_kernel`` (int8, fp8-e4m3 and
fp8-e5m2 weights, per-output-channel scales in the epilogue) and
``quant_matmul_int4`` replaces ``_int4_kernel`` (nibble pairs along K,
per-group scales applied to the weight before the product). For a CUDA
tensor each launches a hand-written kernel in ``csrc/quant_matmul.cu``,
which reads the quantized bytes and converts each weight tile on chip;
for a CPU tensor each computes its plain version. A CUDA tensor the
kernels do not take raises; nothing falls back. ``.launches`` counts a
wrapper's launches, ``.shapes`` counts them by call and ``.variants`` by
kernel variant.

Both wrappers' kernel comes from ``_plan``, a shape rule: ``wgmma`` (TMA
ring, the decoded weight as wgmma's register A operand, split-K over a
thread block cluster for shapes whose output tiles do not fill the card;
one kernel template over int8, e4m3, e5m2 and int4) for bf16 where TMA
reads the operands in place, which every SD1.5 UNet shape satisfies;
``mma`` (mma.sync, masked loads) for the other bf16 shapes; ``fma``
(exact fp32) for fp32. A bf16 or fp32 bias goes to ``wgmma`` as it is.

Semantics, as in the Pallas kernels (and the JAX package's XLA path off
the TPU): the weight is dequantized to x's dtype (int8 and fp8 exactly;
int4 as ``q * scale`` in fp32, rounded to x's dtype before the product),
sums are fp32, int8 / fp8 apply ``acc * scale[n]`` then ``+ b[n]`` in
fp32, int4 adds only the bias, and the output is rounded once to x's
dtype.

Weights use ``ops/quant.py``'s containers in the JAX layout: values
(K, N) with scales (1, N), or int4 packed on axis 0 as (K/2, N) with
scales (K/g, N). The kernels read them as (N, K), (N, K/2) and (N, K/g)
rows: the transposes of a model's containers, so no copy is made for
them.
"""
from __future__ import annotations

import collections
import ctypes
from typing import TYPE_CHECKING, Optional

import torch

from . import _build

if TYPE_CHECKING:  # ops imports this module: no import back at run time
    from ..ops.quant import Int4Tensor, QuantizedTensor

# weight dtype -> (format code of the C interface, name in the shape counts)
_FORMATS = {torch.int8: (0, "int8"), torch.float8_e4m3fn: (1, "fp8"),
            torch.float8_e5m2: (2, "e5m2")}


def _check(x: torch.Tensor, w: QuantizedTensor) -> None:
    if w.values.dim() != 2:
        raise ValueError(f"quant_matmul wants a 2D (K, N) weight, got {tuple(w.values.shape)}")
    k, n = w.values.shape
    if x.shape[-1] != k:
        raise ValueError(f"K mismatch: x has {x.shape[-1]}, w has {k}")
    if w.scales.numel() != n:
        raise ValueError(f"quant_matmul wants per-output-channel scales ({n}), got "
                         f"{tuple(w.scales.shape)}")


def _check_int4(x: torch.Tensor, w: Int4Tensor) -> None:
    if w.axis != 0 or w.packed.dim() != 2:
        raise ValueError("quant_matmul_int4 wants a 2D weight packed on axis 0, got "
                         f"axis={w.axis} ndim={w.packed.dim()}")
    if x.shape[-1] != w.orig_dim:
        raise ValueError(f"K mismatch: x has {x.shape[-1]}, w has {w.orig_dim}")
    k, g = w.orig_dim, w.group_size
    n = w.packed.shape[1]
    if (w.packed.shape[0] * 2 != k or k % g
            or tuple(w.scales.shape) != (k // g, n)):
        raise ValueError(f"int4 weight: packed {tuple(w.packed.shape)}, scales "
                         f"{tuple(w.scales.shape)} do not fit K={k}, g={g}")


def _finish(y: torch.Tensor, b: Optional[torch.Tensor], dtype) -> torch.Tensor:
    if b is not None:
        y = y + b.float()
    return y.to(dtype)


def quant_matmul_plain(x: torch.Tensor, w: QuantizedTensor,
                       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the int8 / fp8 kernel; same arguments."""
    _check(x, w)
    y = torch.matmul(x.float(), w.values.to(x.dtype).float())
    return _finish(y * w.scales.reshape(-1).float(), b, x.dtype)


def quant_matmul_int4_plain(x: torch.Tensor, w: Int4Tensor,
                            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the int4 kernel; same arguments."""
    _check_int4(x, w)
    y = torch.matmul(x.float(), w.dequantize(x.dtype).float())
    return _finish(y, b, x.dtype)


def _on_device(x: torch.Tensor, *tensors: torch.Tensor) -> None:
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, the weight and the bias must be on one CUDA device")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# (variant, dtype, format, x, w, scales, bias, bias dtype, out, M, N, K, g,
#  tile, split, stream)
_ARGS = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
         + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_INT4 = 3  # the int4 format code of the C interface
# variant -> the code tf_quant_matmul takes.
_VARIANTS = {"fma": 0, "mma": 1, "wgmma": 2}
# wgmma: x rows per block (wgmma's n) by M, and the splits of K (one
# thread block cluster, at most 8). Both rules were fitted to times of every
# (tile, split) at the 19 SD1.5 UNet shapes on an H100 (tools/kernel_ab.py
# --sweep, per format): about 100 blocks (two fit an SM) with at most 20 K
# steps each for int4 and 40 for the byte formats (their decode has no
# scale: a longer K loop beats a split's extra barriers at M = 2048 and
# 512), 64-row tiles where a block has few K steps (M = 154), 128 at M <=
# 1024, 160 above. An int4 block holds at most 32 groups of scales.
_SPLIT_BLOCKS = 100
_MAX_STEPS = {"int4": 20, "bytes": 40}
_K_STEP = 64
_MAX_GROUPS = 32


def _tile(m: int) -> int:
    if m <= 8:
        return 8
    if m <= 64:
        return 64
    if m <= 128:
        return 128
    if m <= 256:
        return 64
    return 128 if m <= 1024 else 160


def _groups(k: int, g: int, split: int) -> int:
    """The most groups of scales one block of a split reads (K % 64 == 0)."""
    ks, most = k // _K_STEP, 0
    for r in range(split):
        kb, ke = r * ks // split * _K_STEP, (r + 1) * ks // split * _K_STEP
        most = max(most, min(k // g, -(-ke // g)) - kb // g)
    return most


def _plan(dtype, m: int, k: int, n: int, g: Optional[int] = None):
    """(variant, tile, split) of the kernel for x (m, k) @ w (k, n): an
    int8 / fp8 weight (g None) or int4 with group size g.

    fp32 goes to the exact FMA kernel. bf16 goes to ``wgmma`` where TMA
    can read the operands in place: K % 64 == 0 (whole 64-deep steps; x
    rows of 2K bytes and weight rows of K or K/2 bytes are then multiples
    of 16) and N % 8 == 0 (the output's rows); for int4 also g % 16 == 0
    with g dividing 64 or a multiple of it. Every SD1.5 UNet shape (K in
    320 .. 5120, N in 320 .. 10240, g = 64) does. Other bf16 shapes (ragged
    K, odd N, g = 2) run the ``mma`` kernel. tile and split are 0 and 1
    outside ``wgmma``."""
    if dtype == torch.float32:
        return "fma", 0, 1
    int4 = g is not None
    if not (k % _K_STEP == 0 and n % 8 == 0 and (
            not int4 or (g % 16 == 0 and (_K_STEP % g == 0 or g % _K_STEP == 0)))):
        return "mma", 0, 1
    tile = _tile(m)
    tiles = -(-m // tile) * -(-n // 64)
    ks = k // _K_STEP
    most = min(8, ks)
    steps = _MAX_STEPS["int4" if int4 else "bytes"]
    split = min(most, max(1, int(_SPLIT_BLOCKS / tiles + 0.5), -(-ks // steps)))
    if int4:
        while _groups(k, g, split) > _MAX_GROUPS and split < most:
            split += 1
        if _groups(k, g, split) > _MAX_GROUPS:
            return "mma", 0, 1
    return "wgmma", tile, split


def _kernel_bias(b: Optional[torch.Tensor], x: torch.Tensor, variant: str):
    """The bias as the kernel reads it. ``wgmma`` reads a bf16 or fp32 bias
    as it is (bf16 -> fp32 is exact), so a model's bf16 bias costs no cast
    launch per call; the other variants, and other dtypes, get an fp32 copy."""
    if b is None:
        return None
    if variant == "wgmma" and b.dtype in (torch.bfloat16, torch.float32):
        _on_device(x, b)
        return b.reshape(-1).contiguous()
    return b.to(device=x.device, dtype=torch.float32).contiguous()


def _launch(wrapper, x: torch.Tensor, fmt: int, w_rows: torch.Tensor, scales: torch.Tensor,
            b: Optional[torch.Tensor], n: int, g: Optional[int]):
    """Runs the kernel _plan names for x (..., K) and the weight's rows
    ``w_rows`` (N, row bytes); counts the launch by variant on ``wrapper``.
    Returns (out (..., N), M)."""
    dtype = _build.dtype_code(x.dtype)
    *lead, k = x.shape
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    variant, tile, split = _plan(x.dtype, m, k, n, g)
    if variant == "wgmma" and any(t.data_ptr() % 16 for t in (x2, w_rows)):
        raise ValueError(f"{wrapper.__name__}: bf16 x and the weight must be 16-byte "
                         "aligned (TMA)")
    bias = _kernel_bias(b, x, variant)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.entry("quant_matmul", "tf_quant_matmul", _ARGS)(
        _VARIANTS[variant], dtype, fmt, x2.data_ptr(), w_rows.data_ptr(), scales.data_ptr(),
        None if bias is None else bias.data_ptr(),
        _build.dtype_code(torch.float32 if bias is None else bias.dtype), out.data_ptr(),
        m, n, k, 0 if g is None else g, tile, split, _stream(x))
    wrapper.launches += 1
    wrapper.variants[variant] += 1
    return out.reshape(*lead, n), m


def quant_matmul(x: torch.Tensor, w: QuantizedTensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) @ int8 / fp8 w (K, N) -> (..., N) in x's dtype."""
    _check(x, w)
    if not x.is_cuda:
        return quant_matmul_plain(x, w, b)
    _on_device(x, w.values, w.scales)
    if w.values.dtype not in _FORMATS:
        raise TypeError(f"quant_matmul takes int8, float8_e4m3fn or float8_e5m2 weights, "
                        f"not {w.values.dtype}")
    fmt, fmt_name = _FORMATS[w.values.dtype]
    k, n = w.values.shape
    wt = w.values.t().contiguous()  # (N, K): a model's own storage, no copy
    scales = w.scales.reshape(-1).to(torch.float32).contiguous()
    out, m = _launch(quant_matmul, x, fmt, wt, scales, b, n, None)
    quant_matmul.shapes[(fmt_name, m, k, n)] += 1
    return out


quant_matmul.launches = 0
quant_matmul.shapes = collections.Counter()  # ("int8" | "fp8" | "e5m2", M, K, N) -> launches
quant_matmul.variants = collections.Counter()  # "wgmma" | "mma" | "fma" -> launches


def quant_matmul_int4(x: torch.Tensor, w: Int4Tensor,
                      b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) @ int4 w (K, N), packed on axis 0 -> (..., N) in x's dtype."""
    _check_int4(x, w)
    if not x.is_cuda:
        return quant_matmul_int4_plain(x, w, b)
    _on_device(x, w.packed, w.scales)
    if w.packed.dtype != torch.uint8:
        raise TypeError(f"quant_matmul_int4 takes uint8 nibble pairs, not {w.packed.dtype}")
    k, n, g = w.orig_dim, w.packed.shape[1], w.group_size
    packed = w.packed.t().contiguous()                       # (N, K/2)
    scales = w.scales.t().to(torch.float32).contiguous()     # (N, K/g)
    out, m = _launch(quant_matmul_int4, x, _INT4, packed, scales, b, n, g)
    quant_matmul_int4.shapes[(m, k, n, g)] += 1
    return out


quant_matmul_int4.launches = 0
quant_matmul_int4.shapes = collections.Counter()  # (M, K, N, g) -> launches
quant_matmul_int4.variants = collections.Counter()  # "wgmma" | "mma" | "fma" -> launches
