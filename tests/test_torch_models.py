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
from tinyfusers_tpu import ops as jops
from tinyfusers_tpu_torch.io.from_jax import load_params
from tinyfusers_tpu_torch.models import clip as tclip
from tinyfusers_tpu_torch.models import unet as tunet
from tinyfusers_tpu_torch.models import vae as tvae

from torch_parity import (bf16_against_jax_jit, every_finite_bf16, few_torch_threads,  # noqa: F401
                          random_tree)

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
    load_params(model, params)
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


def _jax_vae_configs():
    from tinyfusers_tpu.pipeline import sd3 as jsd3
    from tinyfusers_tpu.pipeline import sdxl as jsdxl

    return {"sd1": jvae.VAEConfig(), "sdxl": jsdxl.SDXL_BASE.vae, "sd3": jsd3.SD3Config().vae}


# (config, step) -> (values flushed, values where the unrounded constants differ)
_AFFINE = {("sd1", "decode"): (254, 30184), ("sd1", "encode"): (862, 30186),
           ("sdxl", "decode"): (254, 35146), ("sdxl", "encode"): (1004, 36154),
           ("sd3", "decode"): (254, 3177), ("sd3", "encode"): (254, 3362)}


@pytest.mark.parametrize("name,step", list(_AFFINE))
def test_vae_affine_bf16_equals_jax_jit_at_every_normal_value(name, step):
    """decode's z / scale_factor + shift_factor and encode's (means -
    shift_factor) * scale_factor, as the JAX package's vae.py writes them
    with the constants of SD1.x (0.18215), SDXL (0.13025) and SD3 (1.5305,
    shift 0.0609): JAX rounds both constants to bf16 before the op, and
    the port must give the same bits at every value XLA does not flush.
    The constants left in fp32 (the parent's form) differ at the counted
    values."""
    jcfg = _jax_vae_configs()[name]
    tcfg = tvae.VAEConfig(scale_factor=jcfg.scale_factor, shift_factor=jcfg.shift_factor)
    c, s = jcfg.scale_factor, jcfg.shift_factor
    x = every_finite_bf16()
    if step == "decode":
        got, old, jax_fn = tvae.unscale_latent(x, tcfg), x / c + s, lambda z: z / c + s
    else:
        got, old, jax_fn = tvae.scale_latent(x, tcfg), (x - s) * c, lambda m: (m - s) * c
    flushed, unrounded = _AFFINE[(name, step)]
    differ, n_flushed = bf16_against_jax_jit(got, jax_fn, x)
    assert differ.numel() == 0, differ[:8].tolist()
    assert n_flushed == flushed
    assert bf16_against_jax_jit(old, jax_fn, x)[0].numel() == unrounded


def test_vae_decode_bf16_matches_jax():
    """The TINY VAE at SDXL's scale factor, bf16 weights and latent, against
    jax.jit of the JAX decode: the convolutions and norms sum in another
    order, so outputs of magnitude ~2 agree within 2^-5 (two bf16 ulps
    there) and the uint8 images within 2 levels."""
    jcfg = jvae.VAEConfig(base_channels=16, channel_mult=(1, 1, 2), num_groups=8,
                          scale_factor=0.13025)
    tcfg = tvae.VAEConfig(base_channels=16, channel_mult=(1, 1, 2), num_groups=8,
                          scale_factor=0.13025)
    params = random_tree(lambda k: jvae.init(k, jcfg), 0)
    model = tvae.AutoencoderKL(tcfg, device="cpu", dtype=torch.bfloat16)
    load_params(model, params)
    z = rand(1, 1, 4, 4, 4)
    pb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = jax.jit(lambda p, z: jvae.decode(p, z, jcfg))(pb, jnp.asarray(z, jnp.bfloat16))
    with torch.no_grad():
        got = tvae.decode(model, torch.from_numpy(z).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 8, 8, 3)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=2 ** -5)
    img = tvae.to_image(got).numpy().astype(int)
    assert np.abs(img - np.asarray(jvae.to_image(want)).astype(int)).max() <= 2


def _bf16_diff(got: torch.Tensor, want) -> tuple:
    """(worst |got - want|, share of the values that differ)."""
    d = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    return float(d.max()), float(np.mean(d > 0))


def test_resblock_bf16_against_jax_jit():
    """One bf16 ResBlock (group norm eps 1e-5, silu, 3x3 convs, the
    timestep projection, a 1x1 skip) against jax.jit of the JAX block.
    Every op alone equals its jax.jit bit for bit, the convs up to their
    summation order; under one jit XLA on the CPU feeds a conv the fp32
    silu of its group norm where the port (and a bf16 matrix unit) takes it
    rounded to bf16, so the block moves by an ulp in many places. The worst
    difference is held at 2^-4 (two bf16 ulps at the output's ~5) and,
    with the share that differs, printed."""
    cfg_j, cfg_t = junet.UNetConfig(), tunet.UNetConfig()
    params = random_tree(lambda k: junet._res_init(k, junet.ResSpec(64, 128), 256, cfg_j,
                                                    jnp.float32), 3)
    block = tunet.ResBlock(tunet.ResSpec(64, 128), 256, device="cpu", dtype=torch.bfloat16)
    load_params(block, params)
    x, emb = rand(4, 2, 16, 16, 64), rand(5, 2, 256)
    pb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()  # noqa: E731
    want = jax.jit(lambda p, a, e: junet._res_apply(p, a, e, cfg_j))(pb, bf(x), bf(emb))
    with torch.no_grad():
        got = tunet._res_apply(block, tb(x), tb(emb), cfg_t)
        # the conv's input from the JAX side, rounded to bf16: the conv alone
        s = jax.jit(lambda p, a: jops.silu(jops.group_norm(a, 32, p["norm1"]["weight"],
                                                           p["norm1"]["bias"])))(pb, bf(x))
        conv_alone = _bf16_diff(block.conv1(tb(s), padding=1), jax.jit(
            lambda p, a: jops.conv2d(a, p["conv1"]["weight"], p["conv1"]["bias"], padding=1))(pb, s))
    worst, share = _bf16_diff(got, want)
    print(f"bf16 ResBlock vs jax.jit: worst |diff| {worst:.4g} at |out| max "
          f"{np.abs(np.asarray(want, np.float32)).max():.3g}; {share:.3f} of the outputs "
          f"differ; the first conv alone on the same bf16 input: {conv_alone[1]:.5f} differ")
    assert got.dtype == torch.bfloat16 and worst <= 2 ** -4
    assert conv_alone[1] < 1e-3
