"""The port's kernels on the CPU: each plain version against its Pallas
kernel (run with interpret=True, as tests/test_kernels.py does), and the
CPU route of each wrapper. The CUDA kernels themselves are tested on the
card by tests/test_torch_cuda.py.

Tolerances: fp32 plain vs Pallas at rtol 1e-5 / atol 2e-6 (same
arithmetic, other summation order); bf16 at 1.6e-2 (one bf16 ulp of the
outputs: P and the GEGLU product are rounded to bf16 at the same points on
both sides, but from fp32 values summed in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinyfusers_tpu.kernels.flash_attention import flash_attention
from tinyfusers_tpu.kernels.geglu_ff import geglu_matmul as pallas_geglu
from tinyfusers_tpu_torch.kernels.flash_attention import (
    flash_bhsd, flash_bhsd_plain, flash_packed, flash_packed_plain)
from tinyfusers_tpu_torch.kernels.geglu_ff import (
    erf_as, geglu_matmul, geglu_matmul_plain)

from torch_parity import few_torch_threads  # noqa: F401

F32 = dict(rtol=1e-5, atol=2e-6)
BF16 = dict(rtol=1.6e-2, atol=1.6e-2)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def to_t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def to_j(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# -- plain versions vs the Pallas kernels -------------------------------------

@pytest.mark.parametrize("b,sq,sk,heads,d,kv_len", [
    (2, 300, 80, 2, 40, 77),    # d=40, ragged Sq, 77 real keys of 80
    (1, 256, 77, 4, 16, None),  # cross-attention style short kv
    (1, 128, 128, 2, 80, None),
])
def test_packed_plain_matches_pallas(b, sq, sk, heads, d, kv_len):
    c = heads * d
    q, k, v = rand(0, b, sq, c), rand(1, b, sk, c), rand(2, b, sk, c)
    want = flash_attention(to_j(q), to_j(k), to_j(v), layout="packed", heads=heads,
                           kv_len=kv_len, block_q=128, interpret=True)
    got = flash_packed_plain(to_t(q), to_t(k), to_t(v), heads=heads, kv_len=kv_len)
    close(got, want, F32)


def test_packed_plain_matches_pallas_bf16():
    """bf16: q's prescale is rounded in bf16 and P is rounded to bf16 at
    the same points on both sides."""
    q, k, v = rand(0, 1, 200, 80), rand(1, 1, 77, 80), rand(2, 1, 77, 80)
    want = flash_attention(to_j(q, jnp.bfloat16), to_j(k, jnp.bfloat16),
                           to_j(v, jnp.bfloat16), layout="packed", heads=2,
                           block_q=128, interpret=True)
    got = flash_packed_plain(to_t(q, torch.bfloat16), to_t(k, torch.bfloat16),
                             to_t(v, torch.bfloat16), heads=2)
    assert got.dtype == torch.bfloat16
    close(got, want, BF16)


@pytest.mark.parametrize("sq,sk,d,causal,kv_len", [
    (300, 300, 32, False, None),  # three k blocks of 128
    (256, 256, 32, True, None),   # causal, skipped blocks
    (200, 384, 48, False, 250),   # kv_len inside the last k block
    (384, 384, 16, True, 300),    # causal with kv_len
])
def test_bhsd_plain_matches_pallas(sq, sk, d, causal, kv_len):
    q, k, v = rand(0, 2, 3, sq, d), rand(1, 2, 3, sk, d), rand(2, 2, 3, sk, d)
    want = flash_attention(to_j(q), to_j(k), to_j(v), causal=causal, kv_len=kv_len,
                           block_q=128, block_k=128, interpret=True)
    got = flash_bhsd_plain(to_t(q), to_t(k), to_t(v), causal=causal, kv_len=kv_len)
    close(got, want, F32)


@pytest.mark.parametrize("m,k,n,bias", [
    (100, 256, 96, False),   # no bias, M not a multiple of the block
    (64, 128, 200, True),
])
def test_geglu_plain_matches_pallas(m, k, n, bias):
    gx, gate = rand(0, m, k), rand(1, m, k) * 2
    w = rand(2, k, n) * k ** -0.5
    b = rand(3, n) if bias else None
    want = pallas_geglu(to_j(gx), to_j(gate), to_j(w), None if b is None else to_j(b),
                        block_m=64, block_n=128, block_k=128, interpret=True)
    got = geglu_matmul_plain(to_t(gx), to_t(gate), to_t(w),
                             None if b is None else to_t(b))
    close(got, want, F32)


def test_geglu_plain_matches_pallas_bf16_lead_dims():
    gx, gate = rand(0, 2, 40, 128), rand(1, 2, 40, 128)
    w, b = rand(2, 128, 64) * 0.1, rand(3, 64)
    want = pallas_geglu(to_j(gx, jnp.bfloat16), to_j(gate, jnp.bfloat16),
                        to_j(w, jnp.bfloat16), to_j(b), block_m=64, interpret=True)
    got = geglu_matmul_plain(to_t(gx, torch.bfloat16), to_t(gate, torch.bfloat16),
                             to_t(w, torch.bfloat16), to_t(b))
    assert got.shape == (2, 40, 64) and got.dtype == torch.bfloat16
    close(got, want, BF16)


def test_erf_as_is_within_its_bound_of_erf():
    x = torch.linspace(-6, 6, 10001, dtype=torch.float64)
    assert (erf_as(x) - torch.erf(x)).abs().max().item() < 1.5e-7


# -- the wrappers on the CPU ----------------------------------------------------

def test_cpu_wrappers_use_the_plain_versions_and_count_nothing():
    counts = (flash_packed.launches, flash_bhsd.launches, geglu_matmul.launches)
    q, k = to_t(rand(0, 1, 64, 32)), to_t(rand(1, 1, 20, 32))
    assert torch.equal(flash_packed(q, k, k, heads=2, kv_len=17),
                       flash_packed_plain(q, k, k, heads=2, kv_len=17))
    q4, k4 = q[:, None], to_t(rand(1, 1, 1, 64, 32))
    assert torch.equal(flash_bhsd(q4, k4, k4, causal=True),
                       flash_bhsd_plain(q4, k4, k4, causal=True))
    gx, w = to_t(rand(2, 5, 32)), to_t(rand(3, 32, 8))
    assert torch.equal(geglu_matmul(gx, gx, w), geglu_matmul_plain(gx, gx, w))
    assert (flash_packed.launches, flash_bhsd.launches,
            geglu_matmul.launches) == counts
