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
    _plan, flash_bhsd, flash_bhsd_plain, flash_packed, flash_packed_plain)
from tinyfusers_tpu_torch.kernels.geglu_ff import (
    _plan as geglu_plan, erf_as, geglu_matmul, geglu_matmul_plain)

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


@pytest.mark.parametrize("b,sq,sk,heads,kv_len,block_k", [
    (1, 256, 320, 4, 300, 128),   # nk = 3, kv_len ragged inside the last k block
    (2, 200, 384, 2, None, 128),  # nk = 3, no padding keys, ragged Sq
    (1, 130, 512, 3, 250, 256),   # the last k block holds only padding keys
])
def test_packed_plain_matches_pallas_multik(b, sq, sk, heads, kv_len, block_k):
    """The multi-k-block heads-packed kernel (SD3's joint attention on the
    TPU) computes what the plain version computes: flash_packed is its
    counterpart too."""
    from tinyfusers_tpu.kernels.flash_attention import _flash_packed_multik

    c = heads * 64
    q, k, v = rand(0, b, sq, c), rand(1, b, sk, c), rand(2, b, sk, c)
    want = _flash_packed_multik(to_j(q), to_j(k), to_j(v), heads=heads, scale=None,
                                block_q=128, block_k=block_k, kv_len=kv_len,
                                interpret=True)
    got = flash_packed_plain(to_t(q), to_t(k), to_t(v), heads=heads, kv_len=kv_len)
    close(got, want, dict(rtol=2e-4, atol=2e-5))


def test_packed_plain_matches_pallas_multik_bf16():
    """bf16 at BF16: the same roundings (q's prescale, P to bf16), but the
    multi-k kernel rounds P against each k block's running max."""
    from tinyfusers_tpu.kernels.flash_attention import _flash_packed_multik

    q, k, v = rand(0, 1, 256, 256), rand(1, 1, 320, 256), rand(2, 1, 320, 256)
    bf = lambda x: to_j(x, jnp.bfloat16)  # noqa: E731
    want = _flash_packed_multik(bf(q), bf(k), bf(v), heads=4, scale=None, block_q=128,
                                block_k=128, kv_len=300, interpret=True)
    tb = lambda x: to_t(x, torch.bfloat16)  # noqa: E731
    got = flash_packed_plain(tb(q), tb(k), tb(v), heads=4, kv_len=300)
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
    variants = (dict(flash_packed.variants), dict(flash_bhsd.variants))
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
    assert (dict(flash_packed.variants), dict(flash_bhsd.variants)) == variants


def test_counters_take_back_and_add_again_what_was_counted():
    """What a CUDA graph's owner does with the wrappers' counters: take
    back what the capture counted (the counters read as before it, in
    place) and add it at each replay."""
    from tinyfusers_tpu_torch.kernels import counters

    before = counters.snapshot()
    shapes, variants = geglu_matmul.shapes, geglu_matmul.variants
    try:
        geglu_matmul.launches += 2
        geglu_matmul.shapes[(8, 32, 16)] += 2
        geglu_matmul.variants["wgmma"] += 2
        flash_bhsd.launches += 1
        grown = counters.take(before)
        assert counters.snapshot() == before
        assert geglu_matmul.shapes is shapes and geglu_matmul.variants is variants
        assert grown[1][0] == 1 and grown[2] == (2, {(8, 32, 16): 2}, {"wgmma": 2})
        counters.add(grown)
        counters.add(grown)
        after = counters.snapshot()
        assert after[2][0] == before[2][0] + 4 and after[1][0] == before[1][0] + 2
        assert after[2][1][(8, 32, 16)] == before[2][1][(8, 32, 16)] + 4
        assert after[0] == before[0] and after[3:] == before[3:]
    finally:
        counters.take(before)


# -- the CUDA wrappers' shape rule (no card needed) ---------------------------

@pytest.mark.parametrize("dtype,d,want", [
    # every bf16 attention of the main paths goes to the TMA + wgmma kernels
    (torch.bfloat16, 40, ("wgmma", 40)),        # SD1.5 64x64 self / cross
    (torch.bfloat16, 80, ("wgmma", 80)),        # SD1.5 32x32 self / cross
    (torch.bfloat16, 64, ("wgmma", 64)),        # SD3 joint, with or without T5
    (torch.bfloat16, 512, ("wgmma_wide", 512)),  # the VAEs' mid attention
    # fp32 goes to the exact FMA kernel at any width
    (torch.float32, 40, ("fma", 40)),
    (torch.float32, 36, ("fma", 36)),
    (torch.float32, 1000, ("fma", 1000)),
    # a bf16 width that is not a multiple of 8 is read zero-padded to one
    (torch.bfloat16, 36, ("wgmma", 40)),
    (torch.bfloat16, 20, ("wgmma", 24)),
    (torch.bfloat16, 128, ("wgmma", 128)),
    (torch.bfloat16, 130, ("wgmma_wide", 136)),
    (torch.bfloat16, 200, ("wgmma_wide", 200)),
])
def test_variant_rule(dtype, d, want):
    assert _plan(dtype, d) == want


def test_variant_rule_refuses_bf16_heads_wider_than_512():
    with pytest.raises(ValueError, match="512"):
        _plan(torch.bfloat16, 520)


@pytest.mark.parametrize("dtype,m,k,n,aligned,want", [
    # the four SD1.5 FF tails go to the TMA + wgmma kernel
    (torch.bfloat16, 8192, 1280, 320, True, "wgmma"),
    (torch.bfloat16, 2048, 2560, 640, True, "wgmma"),
    (torch.bfloat16, 512, 5120, 1280, True, "wgmma"),
    (torch.bfloat16, 128, 5120, 1280, True, "wgmma"),
    # other bf16 shapes, and operands TMA cannot read in place, go to mma
    (torch.bfloat16, 100, 96, 64, True, "mma"),     # K % 64 != 0
    (torch.bfloat16, 64, 128, 36, True, "mma"),     # N % 8 != 0
    (torch.bfloat16, 70, 100, 32, True, "mma"),     # K % 8 != 0
    (torch.bfloat16, 8192, 1280, 320, False, "mma"),  # a pointer or row stride off 16 bytes
    # fp32 goes to the exact FMA kernel
    (torch.float32, 8192, 1280, 320, True, "fma"),
    # the split never exceeds the 64-deep K steps
    (torch.bfloat16, 2, 64, 320, True, "wgmma"),
    (torch.bfloat16, 8, 128, 8, True, "wgmma"),
])
def test_geglu_plan(dtype, m, k, n, aligned, want):
    variant, bn, split = geglu_plan(dtype, m, k, n, aligned)
    assert variant == want
    if variant != "wgmma":
        assert (bn, split) == (0, 1)
        return
    assert bn in (160, 320) and split in (1, 2, 4)
    assert split <= k // 64
    # the plans the sweep of the four FF shapes chose (r = ceil(n / bn))
    sd15 = {(8192, 1280, 320): (320, 1), (2048, 2560, 640): (320, 2),
            (512, 5120, 1280): (160, 2), (128, 5120, 1280): (160, 4)}
    assert sd15.get((m, k, n), (bn, split)) == (bn, split)


# -- gradients: the autograd Functions against the JAX package's custom_vjps --
# The JAX functions run their Pallas forward in interpret mode (monkeypatched
# as tests/test_kernels.py does); the JAX tests' shapes and tolerances
# (atol 2e-4 / rtol 2e-3: the port's backward is the same exact-math
# gradient, summed in another order).

GRAD = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture
def interpret_flash(monkeypatch):
    import functools as ft

    from tinyfusers_tpu.kernels import flash_attention as fa_mod

    monkeypatch.setattr(fa_mod, "flash_attention",
                        ft.partial(fa_mod.flash_attention, interpret=True))


def _torch_grads(fn, *arrays):
    leaves = [to_t(a).requires_grad_() for a in arrays]
    (fn(*leaves) ** 2).sum().backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize("kv_len", [None, 200])
def test_flash_packed_diff_grads_match_jax(interpret_flash, kv_len):
    import jax

    from tinyfusers_tpu.ops import attention as att
    from tinyfusers_tpu_torch.kernels.flash_attention import flash_packed_diff

    b, s, h, d = 1, 256, 2, 40
    q, k, v = (rand(i, b, s, h * d) for i in range(3))
    want = jax.grad(lambda q, k, v: jnp.sum(att._flash_packed_diff(q, k, v, h, None, kv_len) ** 2),
                    argnums=(0, 1, 2))(to_j(q), to_j(k), to_j(v))
    got = _torch_grads(lambda q, k, v: flash_packed_diff(q, k, v, heads=h, kv_len=kv_len),
                       q, k, v)
    for g, w in zip(got, want):
        close(g, w, GRAD)
    if kv_len is not None:  # dk and dv are zero past kv_len
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


@pytest.mark.parametrize("kv_len", [None, 100])
def test_flash_bhsd_diff_grads_match_jax(interpret_flash, kv_len):
    import jax

    from tinyfusers_tpu.ops import attention as att
    from tinyfusers_tpu_torch.kernels.flash_attention import flash_bhsd_diff

    bh, s, d = 2, 256, 64
    q, k, v = (rand(i, bh, s, d) for i in range(3))
    want = jax.grad(lambda q, k, v: jnp.sum(att._flash_bhsd_diff(q, k, v, None, kv_len) ** 2),
                    argnums=(0, 1, 2))(to_j(q), to_j(k), to_j(v))
    got = _torch_grads(lambda q, k, v: flash_bhsd_diff(q, k, v, kv_len=kv_len), q, k, v)
    for g, w in zip(got, want):
        close(g, w, GRAD)
    if kv_len is not None:
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


@pytest.mark.parametrize("bias", [True, False])
def test_geglu_matmul_diff_grads_match_jax(monkeypatch, bias):
    """The JAX backward recomputes a with the exact erf, as the port's does.
    Without a bias the JAX ops pass fp32 zeros, whose gradient is dropped."""
    import functools as ft

    import jax

    import tinyfusers_tpu.kernels.geglu_ff as gf
    from tinyfusers_tpu_torch.kernels.geglu_ff import geglu_matmul_diff

    monkeypatch.setattr(gf, "geglu_matmul", ft.partial(gf.geglu_matmul, interpret=True))
    gx, gate = rand(0, 32, 128), rand(1, 32, 128)
    w, b = rand(2, 128, 64) / 11.3, (rand(3, 64) if bias else np.zeros(64, np.float32))
    want = jax.grad(lambda *a: jnp.sum(gf.geglu_matmul_diff(*a) ** 2),
                    argnums=(0, 1, 2, 3))(to_j(gx), to_j(gate), to_j(w), to_j(b))
    if bias:
        got = _torch_grads(geglu_matmul_diff, gx, gate, w, b)
    else:
        got = _torch_grads(lambda x, g, w: geglu_matmul_diff(x, g, w, None), gx, gate, w)
    for g, w_ in zip(got, want):
        close(g, w_, GRAD)


def test_geglu_matmul_diff_bf16_rounds_as_jax():
    """bf16: da with fp32 sums rounded to bf16, dw in fp32 rounded to w's
    dtype, db summed in fp32 and rounded once; against the JAX backward at
    BF16 (one bf16 ulp). The JAX backward is jitted, as it runs inside a
    jitted step (the port's gelu_erf rounds as jax.jit's does)."""
    import jax

    import tinyfusers_tpu.kernels.geglu_ff as gf
    from tinyfusers_tpu_torch.kernels.geglu_ff import geglu_matmul_diff

    gx, gate, w = rand(0, 2, 24, 128), rand(1, 2, 24, 128), rand(2, 128, 32) / 11.3
    b, g = rand(3, 32), rand(4, 2, 24, 32)
    bf = lambda x: to_j(x, jnp.bfloat16)  # noqa: E731
    want = jax.jit(gf._diff_bwd)((bf(gx), bf(gate), bf(w)), bf(g))
    tb = lambda x: to_t(x, torch.bfloat16).requires_grad_()  # noqa: E731
    leaves = [tb(gx), tb(gate), tb(w), tb(b)]
    geglu_matmul_diff(*leaves).backward(to_t(g, torch.bfloat16))
    for leaf, w_ in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16
        close(leaf.grad, np.asarray(w_, np.float32), BF16)
