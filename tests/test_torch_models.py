"""Parity of the port's models with the JAX package's on the CPU at the
TINY configs: JAX params go through io/from_jax.py into the port's
modules, inputs come from a numpy seed, everything is fp32. Tolerance
1e-4 (rtol and atol): the same arithmetic through a few dozen layers,
summed in another order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.models import clip as jclip
from tinyfusers_tpu.models import unet as junet
from tinyfusers_tpu.models import vae as jvae
from tinyfusers_tpu_torch.io.from_jax import load_params
from tinyfusers_tpu_torch.models import clip as tclip
from tinyfusers_tpu_torch.models import unet as tunet
from tinyfusers_tpu_torch.models import vae as tvae

from torch_parity import few_torch_threads, random_tree  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


CLIP_CFG = dict(vocab_size=128, max_length=16, dim=32, num_layers=3,
                num_heads=4, mlp_dim=64)


@pytest.mark.parametrize("skip,final_norm,act", [
    (0, False, "quick_gelu"), (1, False, "quick_gelu"), (1, True, "gelu"),
])
def test_clip_matches_jax(skip, final_norm, act):
    jcfg = jclip.CLIPConfig(act=act, **CLIP_CFG)
    tcfg = tclip.CLIPConfig(act=act, **CLIP_CFG)
    params = random_tree(lambda k: jclip.init(k, jcfg), 0)
    model = tclip.CLIPTextModel(tcfg, device="cpu")
    load_params(model, params)
    ids = np.random.default_rng(1).integers(0, 128, (2, 16)).astype(np.int32)
    want = jax.jit(lambda p, i: jclip.apply(p, i, jcfg, skip_final_norm_layers=skip,
                                            final_norm_on_skip=final_norm))(
        params, jnp.asarray(ids))
    with torch.no_grad():
        got = tclip.apply(model, torch.from_numpy(ids), skip_final_norm_layers=skip,
                          final_norm_on_skip=final_norm)
    close(got, want)


def test_clip_is_causal():
    """Changing a later token leaves earlier positions' states unchanged."""
    model = tclip.CLIPTextModel(tclip.CLIPConfig(**CLIP_CFG), device="cpu")
    from tinyfusers_tpu_torch.models.layers import init_weights

    init_weights(model, 0)
    ids = torch.randint(0, 128, (1, 16), generator=torch.Generator().manual_seed(0))
    ids2 = ids.clone()
    ids2[0, 10] = (ids[0, 10] + 1) % 128
    with torch.no_grad():
        a, b = model(ids), model(ids2)
    assert torch.equal(a[:, :10], b[:, :10]) and not torch.equal(a[:, 10:], b[:, 10:])


def test_unet_plan_matches_jax():
    for jc, tc in ((junet.SD15_CONFIG, tunet.SD15_CONFIG),
                   (junet.TINY_CONFIG, tunet.TINY_CONFIG)):
        assert repr(junet.build_plan(jc)) == repr(tunet.build_plan(tc))


def test_timestep_embedding_matches_jax():
    t = np.array([1.0, 501.0, 981.0], np.float32)
    close(tunet.timestep_embedding(torch.from_numpy(t), 32),
          junet.timestep_embedding(jnp.asarray(t), 32), dict(rtol=1e-5, atol=1e-5))


def test_unet_matches_jax():
    jcfg, tcfg = junet.TINY_CONFIG, tunet.TINY_CONFIG
    params = random_tree(lambda k: junet.init(k, jcfg), 0)
    model = tunet.UNet(tcfg, device="cpu")
    load_params(model, params)
    x, ctx = rand(1, 2, 8, 8, 4), rand(2, 2, 7, 16)
    t = np.array([981.0, 1.0], np.float32)
    want = jax.jit(lambda *a: junet.apply(*a, jcfg))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = tunet.apply(model, torch.from_numpy(x), torch.from_numpy(t),
                          torch.from_numpy(ctx))
    assert got.shape == (2, 8, 8, 4)
    close(got, want)


def test_vae_decode_matches_jax():
    jcfg, tcfg = jvae.TINY_VAE_CONFIG, tvae.TINY_VAE_CONFIG
    params = random_tree(lambda k: jvae.init(k, jcfg), 0)
    model = tvae.AutoencoderKL(tcfg, device="cpu")
    load_params(model, params, ignore=("encoder", "quant_conv"))
    z = rand(1, 1, 4, 4, 4)
    want = jax.jit(lambda *a: jvae.decode(*a, jcfg))(params, jnp.asarray(z))
    with torch.no_grad():
        got = tvae.decode(model, torch.from_numpy(z))
    assert got.shape == want.shape == (1, 8, 8, 3)
    close(got, want)


def test_to_image_truncates_like_jax():
    x = np.linspace(-1.2, 1.2, 4001, dtype=np.float32).reshape(1, 1, -1, 1)
    np.testing.assert_array_equal(tvae.to_image(torch.from_numpy(x)).numpy(),
                                  np.asarray(jvae.to_image(jnp.asarray(x))))


def test_from_jax_rejects_bad_trees():
    params = random_tree(lambda k: junet.init(k, junet.TINY_CONFIG), 0)
    model = tunet.UNet(tunet.TINY_CONFIG, device="cpu")
    bad = dict(params, out_conv={"weight": params["out_conv"]["weight"][..., :2],
                                 "bias": params["out_conv"]["bias"]})
    with pytest.raises(ValueError, match="shape"):
        load_params(model, bad)
    partial = {k: v for k, v in params.items() if k != "out_norm"}
    with pytest.raises(ValueError, match="not in the tree"):
        load_params(model, partial)
    with pytest.raises(ValueError, match="no counterpart"):
        load_params(model, dict(params, extra={"weight": np.zeros(1)}))
