"""Flash attention: wrappers, plain versions and launch counts (port of
tinyfusers_tpu/kernels/flash_attention.py).

``flash_packed`` replaces both heads-packed (B, S, H*d) Pallas kernels:
``_kernel_packed`` (the whole key sequence in one VMEM block: SD1.5's
UNet) and ``_kernel_packed_multik`` (many k blocks with per-head online
softmax statistics and ``kv_len``: SD3's joint attention, c = 1536). The
TPU needed the second kernel only because the first holds every key in
VMEM; the CUDA kernels walk key tiles with per-(batch, head, row)
statistics at any key length, so one kernel computes both.
``flash_bhsd`` replaces ``_kernel`` ((..., S, d) layout with ``causal``
and ``kv_len``), read by the same kernels as the packed layout with one
head. Both launch a hand-written CUDA kernel of
``csrc/flash_attention.cu`` for a CUDA tensor, the variant ``_plan``
chooses by shape, and compute their plain PyTorch version for a CPU
tensor; a CUDA tensor no kernel takes raises, it never falls back. Each
wrapper counts its launches in ``.launches``, by call shape (with the
real key count for ``flash_packed``) in ``.shapes`` and by variant in
``.variants``.

Shared semantics, as in the Pallas kernels: q is prescaled by
scale*log2(e) and rounded in q's dtype (by the kernel, as it reads q; by
``_prescale`` in the plain versions); logits are fp32; the softmax is
base 2 with fp32 statistics; P is rounded to v's dtype before P.V; key
columns >= kv_len (and above the diagonal when causal) are masked with
-1e30; a row with no unmasked key gives 0.

The plain versions take one softmax over all keys at once (the Pallas
single-k-block form); the kernels' online softmax over key tiles
equals it up to rounding.

Gradients (``flash_packed_diff``, ``flash_bhsd_diff``: the counterparts of
the JAX package's ``ops/attention.py::_flash_packed_diff`` and
``_flash_bhsd_diff``): the forward is the wrapper above, so the kernel on
CUDA and its launch count as in inference; the backward is the exact-math
attention's gradient (``ops.attention.sdpa_math``, the JAX package's
``sdpa_xla``) recomputed from the saved q, k and v over the unpacked heads
and the first kv_len keys, so dk and dv are zero past kv_len. No backward
kernel: the JAX package's backward is XLA recompute, not Pallas. Its
transient memory is the fp32 logits of the call, O(Sq * Sk) per head.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634


@functools.lru_cache(maxsize=None)
def _factor(scale: float, dtype) -> float:
    """scale * log2(e) rounded to q's dtype, on the host: a device tensor
    made here would be a blocking copy on every launch."""
    return float(torch.tensor(scale * LOG2E, dtype=dtype))


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    return q * _factor(scale, q.dtype)


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, sk_real: int,
                causal: bool) -> torch.Tensor:
    """s (..., Sq, Sk) fp32 base-2 logits, v (..., Sk, d) -> fp32 output."""
    sq, sk = s.shape[-2:]
    col = torch.arange(sk, device=s.device)
    keep = (col < sk_real).expand(sq, sk)
    if causal:
        keep = keep & (col[None, :] <= torch.arange(sq, device=s.device)[:, None])
    s = torch.where(keep, s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    p = torch.where(m <= NEG_INF, torch.zeros((), device=s.device), p)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones((), device=s.device), l)
    return torch.matmul(p.to(v.dtype).float(), v.float()) / l


def flash_packed_plain(q, k, v, *, heads: int, scale: Optional[float] = None,
                       kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the packed kernel; same arguments."""
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // heads
    qs = _prescale(q, scale if scale is not None else 1.0 / (d ** 0.5))
    split = lambda x, s: x.reshape(b, s, heads, d).transpose(1, 2)  # noqa: E731
    s = torch.matmul(split(qs, sq).float(), split(k, sk).float().transpose(-1, -2))
    o = _softmax_pv(s, split(v, sk), sk if kv_len is None else kv_len,
                    causal=False)
    return o.transpose(1, 2).reshape(b, sq, c).to(q.dtype)


def flash_bhsd_plain(q, k, v, *, scale: Optional[float] = None,
                     causal: bool = False,
                     kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the bhsd kernel; same arguments."""
    d = q.shape[-1]
    qs = _prescale(q, scale if scale is not None else 1.0 / (d ** 0.5))
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    o = _softmax_pv(s, v, k.shape[-2] if kv_len is None else kv_len, causal)
    return o.to(q.dtype)


# Variant -> the code tf_flash takes.
_VARIANTS = {"fma": 0, "wgmma": 1, "wgmma_wide": 2}
# (variant, q, k, v, o, B, H, Sq, Sk, kv_len, d, causal, factor, stream)
_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
         + [ctypes.c_float, ctypes.c_void_p])


def _plan(dtype, d: int):
    """The kernel variant for head width ``d`` and the head width it reads.

    fp32 goes to the exact FMA kernel (any d). bf16 goes to the TMA +
    wgmma kernels: ``wgmma`` for d <= 128, ``wgmma_wide`` for
    128 < d <= 512. TMA needs 16-byte row strides, so a bf16 head width
    that is not a multiple of 8 is read zero-padded to one (a copy, off
    every main path). bf16 heads wider than 512 raise."""
    if dtype == torch.float32:
        return "fma", d
    width = -(-d // 8) * 8
    if width > 512:
        raise ValueError(f"flash attention: bf16 head width {d} > 512")
    return ("wgmma" if width <= 128 else "wgmma_wide"), width


def _check_inputs(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash attention: q, k and v must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention: mixed dtypes {q.dtype} {k.dtype} {v.dtype}")
    _build.dtype_code(q.dtype)  # raises on a dtype no kernel takes
    if k.shape != v.shape:
        raise ValueError(f"flash attention: k {tuple(k.shape)} != v {tuple(v.shape)}")


def _sk_real(kv_len, sk):
    if kv_len is None:
        return sk
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len={kv_len} outside [0, {sk}]")
    return kv_len


def _dense(x: torch.Tensor, heads: int, d: int, width: int) -> torch.Tensor:
    """x (..., H*d) as the kernels read it: contiguous, each head
    zero-padded to ``width`` columns."""
    if width != d:
        x = torch.nn.functional.pad(x.reshape(*x.shape[:-1], heads, d), (0, width - d))
        return x.reshape(*x.shape[:-2], heads * width)
    return x.contiguous()


def _launch(fn, q, k, v, *, b, heads, d, causal, kv_len, scale):
    """q (..., Sq, H*d), k / v (..., Sk, H*d), the leading dims b in all,
    through the variant ``_plan`` picks -> (..., Sq, H*d) like q."""
    sq, sk = q.shape[-2], k.shape[-2]
    variant, width = _plan(q.dtype, d)
    factor = _factor(scale if scale is not None else 1.0 / (d ** 0.5), q.dtype)
    qd, kd, vd = (_dense(x, heads, d, width) for x in (q, k, v))
    if variant != "fma" and any(x.data_ptr() % 16 for x in (qd, kd, vd)):
        raise ValueError("flash attention: bf16 q, k and v must be 16-byte aligned (TMA)")
    out = torch.empty_like(qd)
    _build.entry("flash_attention", "tf_flash", _ARGS)(
        _VARIANTS[variant], qd.data_ptr(), kd.data_ptr(), vd.data_ptr(), out.data_ptr(),
        b, heads, sq, sk, _sk_real(kv_len, sk), width, int(causal), factor,
        torch.cuda.current_stream(q.device).cuda_stream)
    fn.launches += 1
    fn.variants[variant] += 1
    if width != d:
        out = out.reshape(*out.shape[:-1], heads, width)[..., :d].reshape(q.shape)
    return out


def flash_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 heads: int, scale: Optional[float] = None,
                 kv_len: Optional[int] = None) -> torch.Tensor:
    """Heads-packed attention: q (B, Sq, H*d), k/v (B, Sk, H*d) ->
    (B, Sq, H*d) in q's dtype; kv_len = the number of real keys."""
    if q.dim() != 3 or q.shape[-1] % heads:
        raise ValueError(f"packed layout needs (B, S, H*d), got {tuple(q.shape)}"
                         f" with heads={heads}")
    if not q.is_cuda:
        return flash_packed_plain(q, k, v, heads=heads, scale=scale, kv_len=kv_len)
    _check_inputs(q, k, v)
    b, sq, c = q.shape
    if k.dim() != 3 or k.shape[0] != b or k.shape[2] != c:
        raise ValueError(f"packed k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    sk = k.shape[1]
    out = _launch(flash_packed, q, k, v, b=b, heads=heads, d=c // heads, causal=False,
                  kv_len=kv_len, scale=scale)
    flash_packed.shapes[(b, sq, sk, c, heads, _sk_real(kv_len, sk))] += 1
    return out


flash_packed.launches = 0
# (B, Sq, Sk, H*d, H, real keys) -> launches
flash_packed.shapes = collections.Counter()
flash_packed.variants = collections.Counter()  # variant -> launches


def flash_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               scale: Optional[float] = None, causal: bool = False,
               kv_len: Optional[int] = None) -> torch.Tensor:
    """Attention over (..., S, d): q (..., Sq, d), k/v (..., Sk, d) ->
    (..., Sq, d) in q's dtype; kv_len = the number of real keys."""
    if not q.is_cuda:
        return flash_bhsd_plain(q, k, v, scale=scale, causal=causal, kv_len=kv_len)
    _check_inputs(q, k, v)
    *lead, sq, d = q.shape
    sk = k.shape[-2]
    if tuple(k.shape[:-2]) != tuple(lead) or k.shape[-1] != d:
        raise ValueError(f"bhsd k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    n = q.numel() // max(1, sq * d)
    out = _launch(flash_bhsd, q, k, v, b=n, heads=1, d=d, causal=causal, kv_len=kv_len,
                  scale=scale)
    flash_bhsd.shapes[(n, sq, sk, d)] += 1
    return out


flash_bhsd.launches = 0
flash_bhsd.shapes = collections.Counter()  # (batch*heads, Sq, Sk, d) -> launches
flash_bhsd.variants = collections.Counter()  # variant -> launches


class _FlashPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, scale, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale, ctx.kv_len = heads, scale, kv_len
        return flash_packed(q, k, v, heads=heads, scale=scale, kv_len=kv_len)

    @staticmethod
    def backward(ctx, g):
        from ..ops.attention import sdpa_math

        q, k, v = ctx.saved_tensors
        heads, kv_len = ctx.heads, ctx.kv_len
        b, sq, c = q.shape
        sk = k.shape[1]
        n = sk if kv_len is None else kv_len
        d = c // heads

        def ref(q_, k_, v_):
            unpack = lambda x, s: x[:, :s].reshape(b, s, heads, d).transpose(1, 2)  # noqa: E731
            o = sdpa_math(unpack(q_, sq), unpack(k_, n), unpack(v_, n), scale=ctx.scale)
            return o.transpose(1, 2).reshape(b, sq, c)

        return (*_vjp(ref, (q, k, v), g), None, None, None)


class _FlashBhsd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.kv_len = scale, kv_len
        return flash_bhsd(q, k, v, scale=scale, kv_len=kv_len)

    @staticmethod
    def backward(ctx, g):
        from ..ops.attention import sdpa_math

        kv_len = ctx.kv_len

        def ref(q_, k_, v_):
            if kv_len is not None:  # the slice's gradient is zero past kv_len
                k_, v_ = k_[..., :kv_len, :], v_[..., :kv_len, :]
            return sdpa_math(q_, k_, v_, scale=ctx.scale)

        return (*_vjp(ref, ctx.saved_tensors, g), None, None)


def _vjp(fn, inputs, g):
    """The gradients of fn(*inputs) against the cotangent g."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, g)


def flash_packed_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      heads: int, scale: Optional[float] = None,
                      kv_len: Optional[int] = None) -> torch.Tensor:
    """``flash_packed`` with gradients to q, k and v."""
    return _FlashPacked.apply(q, k, v, heads, scale, kv_len)


def flash_bhsd_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """``flash_bhsd`` (not causal) with gradients to q, k and v."""
    return _FlashBhsd.apply(q, k, v, scale, kv_len)
