"""The port's SDXL pipeline (pipeline/sdxl.py, the UNet's ADM conditioning)
against the JAX package's on the CPU at TINY_XL, with the same numpy-seeded
weights carried across by io/from_jax.load_sdxl.

Tolerances: the size embeddings in fp32 within two fp32 ulps of each
argument size * freq, plus two at 1 (XLA's exp and torch's put the
frequencies an ulp apart in places); text encoding and one UNet apply at rtol = atol =
1e-5 (summation order); final latents after 3 steps at 1e-4 (the models'
tolerance carried through the loop); uint8 images within 1 level. The
JAX latents come from a jit of a copy of ``sdxl.generate``'s own body with
the decode and uint8 steps as the identity, so each sampler variant is
traced once; its images are that latent through the JAX decode.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.models import unet as junet
from tinyfusers_tpu.models import vae as jvae
from tinyfusers_tpu.pipeline import sdxl as jsdxl
from tinyfusers_tpu_torch.io.from_jax import load_params, load_sdxl
from tinyfusers_tpu_torch.models import unet as tunet
from tinyfusers_tpu_torch.pipeline import sdxl as tsdxl

from torch_parity import few_torch_threads, jax_noises, random_tree, replay_noise  # noqa: F401

STEPS = 3
GUIDANCE = 7.5


@pytest.fixture(scope="module")
def tiny():
    """JAX params, the port's StableDiffusionXL loaded from them, both
    towers' prompt and negative ids, and the initial latent."""
    params = random_tree(lambda k: jsdxl.init(k, jsdxl.TINY_XL), 0)
    model = tsdxl.StableDiffusionXL(tsdxl.TINY_XL, device="cpu", seed=None)
    load_sdxl(model, params)
    rng = np.random.default_rng(1)
    n, eot = 16, 127
    ids = rng.integers(0, eot, (2, 1, n)).astype(np.int32)
    ids[:, 0, 9:] = eot
    uids = np.full((2, 1, n), eot, np.int32)
    uids[:, 0, 0] = 0
    lat = rng.standard_normal((1, *tsdxl.TINY_XL.latent_shape)).astype(np.float32)
    return params, model, ids, uids, lat


def t(x):
    return torch.from_numpy(np.asarray(x))


def _same_config(a, b):
    """Every field of the port's config equals the JAX one's, nested."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _same_config(x, y)
        else:
            assert x == y, f.name


def test_configs_equal_jax():
    for name in ("SDXL_BASE", "TINY_XL"):
        _same_config(getattr(tsdxl, name), getattr(jsdxl, name))
    _same_config(tunet.SDXL_CONFIG, junet.SDXL_CONFIG)
    assert repr(tunet.build_plan(tunet.SDXL_CONFIG)) == repr(junet.build_plan(junet.SDXL_CONFIG))
    assert tsdxl.SDXL_BASE.latent_shape == jsdxl.SDXL_BASE.latent_shape == (128, 128, 4)


def _size_tol(sizes, dim):
    """Two fp32 ulps of each embedding's argument size * freq, plus two at
    1: XLA's exp and torch's give the frequencies an ulp apart in places,
    which the size (up to 1152 here) scales, and |d cos|, |d sin| <= |d
    argument|."""
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half, dtype=np.float32) / half)
    args = np.abs(sizes.reshape(-1, 1).astype(np.float32) * freqs.astype(np.float32))
    tol = 2 * np.spacing(args) + 2 * np.spacing(np.float32(1))
    return np.concatenate([tol, tol], -1).reshape(sizes.shape[0], -1)


def test_size_embeddings_and_adm_cond_match_jax():
    cfg = tsdxl.TINY_XL
    sizes = tsdxl.default_sizes(2, cfg)
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsdxl.default_sizes(2, cfg)))
    full = np.array([[1024, 1024, 0, 0, 1024, 1024], [896, 1152, 64, 32, 1024, 768]],
                    np.float32)
    got = tsdxl.size_embeddings(t(full), 256)
    want = np.asarray(jsdxl.size_embeddings(jnp.asarray(full), 256))
    assert got.dtype == torch.float32 and got.shape == (2, 6 * 256)
    np.testing.assert_array_less(np.abs(got.numpy() - want), _size_tol(full, 256))
    pooled = np.random.default_rng(3).standard_normal((2, 32)).astype(np.float32)
    got = tsdxl.make_adm_cond(t(pooled), sizes, cfg)
    want = np.asarray(jsdxl.make_adm_cond(jnp.asarray(pooled), jnp.asarray(sizes.numpy()), cfg))
    assert got.shape == (2, cfg.unet.adm_in_channels)
    np.testing.assert_array_equal(got[:, :32].numpy(), pooled)
    np.testing.assert_array_less(np.abs(got[:, 32:].numpy() - want[:, 32:]),
                                 _size_tol(sizes.numpy(), 8))
    # the size embeddings take the pooled embedding's dtype
    assert tsdxl.make_adm_cond(t(pooled).bfloat16(), sizes, cfg).dtype == torch.bfloat16


def test_encode_text_matches_jax(tiny):
    """Both towers' penultimate states without the final norm, bigG's pooled
    embedding from its final-norm state: one pass of bigG gives what the
    JAX package's two passes give."""
    params, model, ids, _, _ = tiny
    ctx, pooled = jax.jit(lambda p, a, b: jsdxl.encode_text(p, a, b, jsdxl.TINY_XL))(
        params, jnp.asarray(ids[0]), jnp.asarray(ids[1]))
    with torch.no_grad():
        got_ctx, got_pooled = tsdxl.encode_text(model, t(ids[0]).long(), t(ids[1]).long())
    assert got_ctx.shape == (1, 16, 48) and got_pooled.shape == (1, 32)
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(ctx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), rtol=1e-5, atol=1e-5)


def test_unet_with_adm_matches_jax(tiny):
    params, model, _, _, _ = tiny
    cfg = tsdxl.TINY_XL.unet
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 48)).astype(np.float32)
    adm = rng.standard_normal((2, cfg.adm_in_channels)).astype(np.float32)
    ts = np.array([981.0, 1.0], np.float32)
    want = jax.jit(lambda p, a, b, c, d: junet.apply(p, a, b, c, jsdxl.TINY_XL.unet,
                                                     adm_cond=d))(
        params["unet"], jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jnp.asarray(adm))
    with torch.no_grad():
        got = tunet.apply(model.unet, t(x), t(ts), t(ctx), adm_cond=t(adm))
        other = tunet.apply(model.unet, t(x), t(ts), t(ctx), adm_cond=t(adm) * 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got, other)  # the ADM vector reaches the output
    with pytest.raises(ValueError, match="needs adm_cond"), torch.no_grad():
        tunet.apply(model.unet, t(x), t(ts), t(ctx))


@pytest.fixture(scope="module")
def jax_latents():
    """jit of a copy of sdxl.generate's body whose globals hold an identity
    in place of the vae module: the final latents, one trace per variant.
    The copy is a function object of its own, so jit's caches never mix it
    with sdxl.generate, and the JAX module is left as it is."""
    body = jsdxl.generate.__wrapped__
    ident = types.SimpleNamespace(decode=lambda p, z, c: z, to_image=lambda x: x)
    latents = types.FunctionType(body.__code__, dict(vars(jsdxl), vae=ident),
                                 "generate_latents", body.__defaults__, body.__closure__)
    latents.__kwdefaults__ = body.__kwdefaults__
    fn = jax.jit(latents, static_argnames=("num_steps", "cfg", "method", "schedule",
                                           "uncond_interval", "cfg_rescale", "freeu"))
    return lambda *a, **kw: np.asarray(fn(*a, **kw))


@pytest.mark.parametrize("kw", [
    dict(method="ddim"),
    dict(method="euler_ancestral"),
    dict(method="ddim", uncond_interval=2, cfg_rescale=0.7),
    dict(method="ddim", freeu=(1.3, 1.4, 0.9, 0.2)),
], ids=["ddim", "euler_ancestral", "cached_cfg_rescale", "freeu"])
def test_generate_matches_jax(tiny, jax_latents, monkeypatch, kw):
    params, model, ids, uids, lat = tiny
    key = jax.random.key(5) if kw["method"] == "euler_ancestral" else None
    want = jax_latents(params, *(jnp.asarray(a) for a in (*ids, *uids)), jnp.asarray(lat),
                       jnp.float32(GUIDANCE), num_steps=STEPS, cfg=jsdxl.TINY_XL, key=key,
                       **kw)
    want_img = np.asarray(jvae.to_image(jvae.decode(params["vae"], jnp.asarray(want),
                                                    jsdxl.TINY_XL.vae)))
    args = [t(a).long() for a in (*ids, *uids)]
    port_kw = dict(kw, generator=torch.Generator() if key is not None else None)
    for what in ("latents", "image"):
        left = None
        if key is not None:
            left = replay_noise(monkeypatch, jax_noises(key, 0, STEPS, lat.shape))
        if what == "latents":
            with torch.no_grad():
                cond = tsdxl.conditioning(model, args[0], args[1], torch.float32)
                uncond = tsdxl.conditioning(model, args[2], args[3], torch.float32)
                got = tsdxl.sample_latents(model.unet, t(lat), cond, uncond, GUIDANCE,
                                           num_steps=STEPS, **port_kw)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        else:
            img = tsdxl.generate(model, *args, t(lat), GUIDANCE, num_steps=STEPS,
                                 **port_kw).numpy()
            assert img.dtype == np.uint8 and img.shape == want_img.shape == (1, 64, 64, 3)
            assert img.std() > 0
            assert np.abs(img.astype(int) - want_img.astype(int)).max() <= 1
        assert not left  # every replayed normal drawn, in order


def test_transformer_block_bf16_against_jax_jit():
    """One SDXL transformer block (64-wide heads) in bf16 against jax.jit of
    the JAX block: the layer norms, attention and GEGLU sum in another
    order, so the two differ; the worst difference is held at 2^-4 (two
    bf16 ulps at the block output's magnitude of ~5) and printed."""
    ch, ctx_dim = 128, 96
    jcfg = junet.UNetConfig(context_dim=ctx_dim, num_heads=-1, head_dim=64)
    tcfg = tunet.UNetConfig(context_dim=ctx_dim, num_heads=-1, head_dim=64)
    params = random_tree(lambda k: junet._transformer_block_init(k, ch, jcfg, jnp.float32), 6)
    block = tunet.TransformerBlock(ch, tcfg, device="cpu", dtype=torch.bfloat16)
    load_params(block, params)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 256, ch)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, ctx_dim)).astype(np.float32)
    pb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = jax.jit(lambda p, a, c: junet._transformer_block_apply(p, a, c, 2))(
        pb, jnp.asarray(x, jnp.bfloat16), jnp.asarray(ctx, jnp.bfloat16))
    with torch.no_grad():
        got = tunet._transformer_block_apply(block, t(x).bfloat16(), t(ctx).bfloat16())
    w = np.asarray(want, np.float32)
    diff = np.abs(got.float().numpy() - w)
    print(f"bf16 SDXL transformer block vs jax.jit: worst |diff| {diff.max():.4g} at "
          f"|out| max {np.abs(w).max():.3g}; {np.mean(diff > 0):.3f} of the outputs differ")
    assert got.dtype == torch.bfloat16 and diff.max() <= 2 ** -4


def test_sdxl_model_runs_on_the_gpu_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tsdxl.StableDiffusionXL(tsdxl.TINY_XL)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tsdxl.initial_latent(0, 1, tsdxl.TINY_XL)
