"""Flash attention: wrappers, plain versions and launch counts (port of
tinyfusers_tpu/kernels/flash_attention.py).

``flash_packed`` replaces ``_kernel_packed`` (heads-packed (B, S, H*d)
layout) and ``flash_bhsd`` replaces ``_kernel`` ((..., S, d) layout with
``causal`` and ``kv_len``). Both launch the hand-written CUDA kernel in
``csrc/flash_attention.cu`` for a CUDA tensor, and compute their plain
PyTorch version for a CPU tensor; a CUDA tensor the kernel does not take
raises, it never falls back. Each wrapper counts its launches in
``.launches`` and, by call shape, in ``.shapes``.

Shared semantics, as in the Pallas kernels: q is prescaled by
scale*log2(e) and rounded in q's dtype here in the wrapper; logits are
fp32; the softmax is base 2 with fp32 statistics; P is rounded to v's
dtype before P.V; key columns >= kv_len (and above the diagonal when
causal) are masked with -1e30; a row with no unmasked key gives 0.

The plain versions take one softmax over all keys at once (the Pallas
single-k-block form); the kernel's online softmax over 64-key tiles
equals it up to rounding.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    # The factor is rounded to q's dtype on the host: a device tensor made
    # here would be a blocking copy on every launch.
    return q * float(torch.tensor(scale * LOG2E, dtype=q.dtype))


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


# (dtype, q, k, v, o, six ints, stream): both C entry points take this shape
_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _check_inputs(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash attention: q, k and v must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention: mixed dtypes {q.dtype} {k.dtype} {v.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"flash attention: k {tuple(k.shape)} != v {tuple(v.shape)}")


def _sk_real(kv_len, sk):
    if kv_len is None:
        return sk
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len={kv_len} outside [0, {sk}]")
    return kv_len


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
    d = c // heads
    qs = _prescale(q, scale if scale is not None else 1.0 / (d ** 0.5)).contiguous()
    k, v = k.contiguous(), v.contiguous()
    out = torch.empty_like(qs)
    _build.entry("flash_attention", "tf_flash_packed", _ARGS)(
        _build.dtype_code(q.dtype), qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, sq, sk, _sk_real(kv_len, sk), heads, d,
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_packed.launches += 1
    flash_packed.shapes[(b, sq, sk, c, heads)] += 1
    return out


flash_packed.launches = 0
flash_packed.shapes = collections.Counter()  # (B, Sq, Sk, H*d, H) -> launches


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
    qs = _prescale(q, scale if scale is not None else 1.0 / (d ** 0.5)).contiguous()
    k, v = k.contiguous(), v.contiguous()
    out = torch.empty_like(qs)
    n = qs.numel() // max(1, sq * d)
    _build.entry("flash_attention", "tf_flash_bhsd", _ARGS)(
        _build.dtype_code(q.dtype), qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), n, sq, sk, _sk_real(kv_len, sk), d, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_bhsd.launches += 1
    flash_bhsd.shapes[(n, sq, sk, d)] += 1
    return out


flash_bhsd.launches = 0
flash_bhsd.shapes = collections.Counter()  # (batch*heads, Sq, Sk, d) -> launches
