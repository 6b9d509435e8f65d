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

from torch_parity import few_torch_threads  # noqa: F401

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
