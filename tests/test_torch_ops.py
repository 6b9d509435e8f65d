"""Parity of tinyfusers_tpu_torch.ops with tinyfusers_tpu.ops on the CPU.

Inputs come from a numpy seed and go to both packages; everything is
fp32, compared at rtol = atol = 1e-5 (the two sides differ only in
summation order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinyfusers_tpu import ops as jops
from tinyfusers_tpu_torch import ops as tops

from torch_parity import bf16_against_jax_jit, every_finite_bf16, few_torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("name", ["silu", "swish", "quick_gelu", "gelu_erf", "gelu_tanh"])
def test_activations(name):
    x = rand(0, 4, 33) * 4
    close(getattr(tops, name)(torch.from_numpy(x)), getattr(jops, name)(jnp.asarray(x)))


def test_geglu():
    x, g = rand(0, 3, 16), rand(1, 3, 16) * 3
    close(tops.geglu(torch.from_numpy(x), torch.from_numpy(g)),
          jops.geglu(jnp.asarray(x), jnp.asarray(g)))


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(affine):
    x = rand(0, 2, 7, 48) * 3 + 1
    w, b = (rand(1, 48), rand(2, 48)) if affine else (None, None)
    tw = None if w is None else torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b)
    jw = None if w is None else jnp.asarray(w)
    jb = None if b is None else jnp.asarray(b)
    close(tops.layer_norm(torch.from_numpy(x), tw, tb),
          jops.layer_norm(jnp.asarray(x), jw, jb))


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_channels_last(eps):
    x = rand(0, 2, 5, 6, 32) * 2 + 0.5
    w, b = rand(1, 32), rand(2, 32)
    close(tops.group_norm(torch.from_numpy(x), 8, torch.from_numpy(w),
                          torch.from_numpy(b), eps=eps),
          jops.group_norm(jnp.asarray(x), 8, jnp.asarray(w), jnp.asarray(b), eps=eps))


def test_group_norm_eps_matters_at_small_variance():
    """The two call-site eps values give different results on an input
    whose variance is near them, and each matches the JAX package's."""
    x = 1e-3 * rand(0, 1, 4, 4, 16)
    outs = []
    for eps in (1e-5, 1e-6):
        got = tops.group_norm(torch.from_numpy(x), 4, eps=eps)
        close(got, jops.group_norm(jnp.asarray(x), 4, eps=eps), rtol=1e-4, atol=1e-4)
        outs.append(got)
    assert not torch.allclose(outs[0], outs[1], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("k,stride,padding", [
    (3, 1, 1), (1, 1, 0), (3, 2, 1), (3, 2, (0, 1, 0, 1)), (3, 1, (1, 2)),
    (3, 1, (2, 0, 1, 1)),
])
def test_conv2d(k, stride, padding):
    x = rand(0, 2, 9, 8, 6)
    w = rand(1, k, k, 6, 5) * 0.3
    b = rand(2, 5)
    close(tops.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                      stride=stride, padding=padding),
          jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      stride=stride, padding=padding))


def test_conv2d_no_bias_and_upsample():
    x = rand(0, 1, 4, 5, 3)
    w = rand(1, 3, 3, 3, 2)
    close(tops.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1),
          jops.conv2d(jnp.asarray(x), jnp.asarray(w), padding=1))
    close(tops.upsample_nearest_2x(torch.from_numpy(x)),
          jops.upsample_nearest_2x(jnp.asarray(x)), rtol=0, atol=0)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    x, w = rand(0, 2, 5, 24), rand(1, 24, 12) * 0.2
    b = rand(2, 12) if bias else None
    close(tops.linear(torch.from_numpy(x), torch.from_numpy(w),
                      None if b is None else torch.from_numpy(b)),
          jops.linear(jnp.asarray(x), jnp.asarray(w),
                      None if b is None else jnp.asarray(b)))


def test_geglu_linear_cpu_path():
    gx, gate = rand(0, 2, 6, 32), rand(1, 2, 6, 32)
    w, b = rand(2, 32, 8) * 0.2, rand(3, 8)
    close(tops.geglu_linear(torch.from_numpy(gx), torch.from_numpy(gate),
                            torch.from_numpy(w), torch.from_numpy(b)),
          jops.geglu_linear(jnp.asarray(gx), jnp.asarray(gate), jnp.asarray(w),
                            jnp.asarray(b)))


def test_embedding():
    ids = np.array([[3, 0, 7], [7, 7, 1]], np.int32)
    w = rand(0, 10, 6)
    close(tops.embedding(torch.from_numpy(ids), torch.from_numpy(w)),
          jops.embedding(jnp.asarray(ids), jnp.asarray(w)), rtol=0, atol=0)


@pytest.mark.parametrize("mask_kind", [None, "additive", "bool"])
def test_sdpa_math_matches_sdpa_xla(mask_kind):
    q, k, v = rand(0, 2, 3, 9, 16), rand(1, 2, 3, 11, 16), rand(2, 2, 3, 11, 16)
    mask_np = None
    if mask_kind == "additive":
        mask_np = np.triu(np.full((9, 11), -np.inf, np.float32), k=1)[None, None]
    elif mask_kind == "bool":
        mask_np = np.tril(np.ones((9, 11), bool))[None, None]
    tm = None if mask_np is None else torch.from_numpy(mask_np)
    jm = None if mask_np is None else jnp.asarray(mask_np)
    close(tops.sdpa_math(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tm),
          jops.sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm))


def test_sdpa_dispatch_on_cpu_is_math_with_kv_len():
    """On CPU tensors sdpa/sdpa_packed take the math route (no kernel
    launch), including at Sq >= 1024, and honour kv_len."""
    from tinyfusers_tpu_torch.kernels.flash_attention import flash_bhsd, flash_packed

    before = (flash_packed.launches, flash_bhsd.launches)
    q = rand(0, 1, 1024, 8)
    k, v = rand(1, 1, 20, 8), rand(2, 1, 20, 8)
    got = tops.sdpa_packed(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), heads=2, kv_len=13)
    want = jops.sdpa_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            heads=2, impl="xla", kv_len=13)
    close(got, want)
    assert (flash_packed.launches, flash_bhsd.launches) == before


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_sdpa_impl_routes_on_cpu(impl):
    """impl "xla" is the math route; "flash" takes the kernel wrappers, whose
    plain versions run on CPU tensors (no launch; the JAX flash's q
    prescale rounded in q's dtype), both within the tolerance of the JAX
    sdpa(impl="xla")."""
    from tinyfusers_tpu_torch.kernels.flash_attention import flash_packed

    q, k, v = rand(3, 2, 1024, 16), rand(4, 2, 40, 16), rand(5, 2, 40, 16)
    before = flash_packed.launches
    got = tops.sdpa_packed(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           heads=2, impl=impl, kv_len=33)
    want = jops.sdpa_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=2,
                            impl="xla", kv_len=33)
    close(got, want)
    assert flash_packed.launches == before
    with pytest.raises(ValueError, match="unknown impl"):
        tops.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), impl="bogus")


def _every_finite_bf16() -> torch.Tensor:
    """All 65,280 finite bf16 values (both zeros included)."""
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    return x[torch.isfinite(x)]


def test_gelu_erf_bf16_equals_jax_jit_at_every_normal_value():
    """jax.jit(gelu_erf) keeps -x * sqrt_half in fp32, rounds erfc to bf16
    and forms (0.5 * x) * erfc in bf16; the port must give the same bits
    wherever the input and both outputs are normal (zero counts as normal).
    XLA on the CPU flushes subnormals, inputs, results and the fp32 erfc
    alike, to zero, so where either side's output is below bf16's smallest
    normal value or the input is, the values are counted, not compared;
    F.gelu (one rounding of an fp32 GELU) differs at 1,086 normal values."""
    import jax

    x = _every_finite_bf16()
    assert x.numel() == 65280
    want = torch.from_numpy(np.asarray(
        jax.jit(jops.gelu_erf)(jnp.asarray(x.float().numpy(), jnp.bfloat16)),
        np.float32)).to(torch.bfloat16)
    got = tops.gelu_erf(x)
    assert got.dtype == torch.bfloat16
    tiny = torch.finfo(torch.bfloat16).tiny
    a, g, w = x.float().abs(), got.float(), want.float()
    normal = (a == 0) | (a >= tiny)
    normal &= (g == w) | ((g.abs() >= tiny) & (w.abs() >= tiny))
    differ = (g != w) & normal
    assert int(differ.sum()) == 0, x[differ][:8].tolist()
    # the flushed region: the 254 subnormal inputs, the 256 normal ones below
    # 2.35e-38 in magnitude whose 0.5 * x is subnormal, and the 6 from -13.06
    # to -13.38 whose fp32 erfc is
    assert int((~normal).sum()) == 516, x[~normal & (a >= tiny)].tolist()
    old = torch.nn.functional.gelu(x).float()
    assert int(((old != w) & normal).sum()) == 1086


# The parent forms: torch.sigmoid rounds once, and a Python float stays
# fp32 inside a bf16 op, where JAX rounds it to bf16 first.
_UNROUNDED = {
    "sigmoid": torch.sigmoid,
    "silu": lambda x: x * torch.sigmoid(x),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu_tanh": lambda x: 0.5 * x * (1.0 + torch.tanh(
        0.7978845608 * x * (1.0 + 0.044715 * x * x))),
}


@pytest.mark.parametrize("name,flushed,unrounded", [
    ("sigmoid", 257, 1113), ("silu", 513, 999), ("swish", 513, 999),
    ("quick_gelu", 514, 1068), ("gelu_tanh", 510, 77)])
def test_sigmoid_family_bf16_equals_jax_jit_at_every_normal_value(name, flushed, unrounded):
    """jax.jit(jax.nn.sigmoid) is 1 / (1 + exp(-x)) with each op rounded to
    bf16, and every Python constant is rounded to bf16 before its op: the
    port must give the same bits at every value XLA does not flush
    (subnormal inputs, or a subnormal result on either side, counted, not
    compared). The forms with torch.sigmoid and fp32 constants differ at
    ``unrounded`` values."""
    x = every_finite_bf16()
    jax_fn = getattr(jops, name)
    got = getattr(tops, name)(x)
    assert got.dtype == torch.bfloat16
    differ, n_flushed = bf16_against_jax_jit(got, jax_fn, x)
    assert differ.numel() == 0, differ[:8].tolist()
    assert n_flushed == flushed
    old = _UNROUNDED["silu" if name == "swish" else name](x)
    assert bf16_against_jax_jit(old, jax_fn, x)[0].numel() == unrounded


def test_row_invariance_runs_a_position_dependent_conv_one_row_at_a_time(monkeypatch):
    """Under ops.conv.RowInvariance a conv call shape whose rows round by
    their position in the batch (cuDNN's split at some shapes on the card;
    here a stand-in that adds the row index) runs one row at a time, so each
    row equals that row convolved alone; a shape without it runs whole."""
    from tinyfusers_tpu_torch.ops import conv as conv_mod

    real = conv_mod._conv2d
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 6, 6, 8), generator=g)
    w = torch.randn((3, 3, 8, 5), generator=g)
    with conv_mod.RowInvariance() as plain:
        whole = tops.conv2d(x, w, padding=1)
    assert list(plain.apart.values()) == [False]
    torch.testing.assert_close(whole, real(x, w, None, stride=1, padding=1, compute_dtype=None),
                               rtol=0, atol=0)

    def by_position(x, *a, **k):
        return real(x, *a, **k) + 1e-3 * torch.arange(x.shape[0]).view(-1, 1, 1, 1)

    monkeypatch.setattr(conv_mod, "_conv2d", by_position)
    with conv_mod.RowInvariance() as policy:
        rows = tops.conv2d(x, w, padding=1)
        tops.conv2d(x[:1], w, padding=1)  # a batch of one is never probed
    assert list(policy.apart.values()) == [True]
    for i in range(4):
        assert torch.equal(rows[i], tops.conv2d(x[i:i + 1], w, padding=1)[0])
    assert not torch.equal(tops.conv2d(x, w, padding=1)[3], rows[3])  # outside: whole
