"""The port's UNet extras and SD entry points against the JAX package's on
the CPU, at TINY: FreeU (_fourier_filter, _apply_freeu), DeepCache (the
UNet's "full" and "shallow" passes and both samplers), ControlNet
residuals in the sampling loop, generate with their combinations under
ddim and a 2-call sampler (heun), generate_hires, img2img and inpaint
(the 9-channel UNet), with the JAX normals replayed through the port's one
noise function (tests/torch_parity.py::replay_noise).

Tolerances: the FFT filter and FreeU's reweighting in fp32 at rtol = atol
= 1e-5; a UNet forward (and DeepCache's cached hidden state) against the
JAX package's at 1e-4, as tests/test_torch_models.py holds the UNet;
DeepCache's full pass equal to the plain forward bit for bit and its
shallow pass with a fresh cache within 1e-5 of it (as tests/test_models.py
holds the JAX one); whole images within 1 of the uint8 value, as
tests/test_torch_pipeline.py holds DDIM; the mask resize and inpaint's
pasted-back pixels bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.models import controlnet as jcn
from tinyfusers_tpu.models import unet as junet
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu_torch.io.from_jax import load_params
from tinyfusers_tpu_torch.models import controlnet as tcn
from tinyfusers_tpu_torch.models import unet as tunet
from tinyfusers_tpu_torch.pipeline import sd as tsd

from torch_parity import few_torch_threads, jax_noises, random_tree, replay_noise, tiny_sd  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 3
GUIDANCE = 5.0
FREEU = (1.5, 1.6, 0.9, 0.2)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close_images(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def tiny():
    return tiny_sd(jsd, tsd, jsd.TINY, tsd.TINY)


@pytest.fixture(scope="module")
def cn():
    params = random_tree(lambda k: jcn.init(k, jsd.TINY.unet), 11)
    model = tcn.ControlNet(tsd.TINY.unet, device="cpu", seed=None)
    load_params(model, params)
    return params, model


def _step(b=2, hw=16, seed=1):
    return (_rand(b, hw, hw, 4, seed=seed), np.full((b,), 401.0, np.float32),
            _rand(b, 16, jsd.TINY.unet.context_dim, seed=seed + 1))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# --- FreeU -----------------------------------------------------------------

@pytest.mark.parametrize("threshold,scale", [(1, 0.2), (2, 0.5), (1, 1.0)])
def test_fourier_filter_matches_jax(threshold, scale):
    x = _rand(2, 8, 12, 5, seed=threshold)
    want = junet._fourier_filter(jnp.asarray(x), threshold, scale)
    got = tunet._fourier_filter(torch.from_numpy(x), threshold, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fourier_filter_box_is_strict():
    """At threshold 1 the box is the DC bin alone (ADVICE.md): scale 0
    removes each channel's mean and nothing else."""
    x = torch.from_numpy(_rand(1, 8, 8, 3, seed=4))
    got = tunet._fourier_filter(x, 1, 0.0)
    np.testing.assert_allclose(got.numpy(), (x - x.mean(dim=(1, 2), keepdim=True)).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_apply_freeu_matches_jax(level):
    x, skip = _rand(2, 4, 4, 8, seed=5), _rand(2, 4, 4, 8, seed=6)
    wx, ws = junet._apply_freeu(jnp.asarray(x), jnp.asarray(skip), level, FREEU)
    gx, gs = tunet._apply_freeu(torch.from_numpy(x), torch.from_numpy(skip), level, FREEU)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


def test_unet_with_freeu_matches_jax(tiny):
    params, model = tiny[:2]
    x, t, ctx = _step()
    run = jax.jit(lambda p, *a: junet.apply(p, *a, jsd.TINY.unet, freeu=FREEU))
    want = run(params["unet"], *_j(x, t, ctx))
    got = tunet.apply(model.unet, *_t(x, t, ctx), freeu=FREEU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)


# --- DeepCache -------------------------------------------------------------

@pytest.mark.parametrize("split", [1, 3, 6])
def test_deepcache_passes_match_jax(tiny, split):
    """The full pass equals the plain forward bit for bit; the shallow pass
    with that cache reproduces it (1e-5); both, and the cache, match the
    JAX package's."""
    params, model = tiny[:2]
    x, t, ctx = _step()
    jfull, jcache = junet.apply(params["unet"], *_j(x, t, ctx), jsd.TINY.unet,
                                deepcache=("full", split))
    jsh, _ = junet.apply(params["unet"], *_j(x, t, ctx), jsd.TINY.unet,
                         deepcache=("shallow", split), cache=jcache)
    plain = tunet.apply(model.unet, *_t(x, t, ctx))
    full, cache = tunet.apply(model.unet, *_t(x, t, ctx), deepcache=("full", split))
    assert torch.equal(full, plain)
    sh, same = tunet.apply(model.unet, *_t(x, t, ctx), deepcache=("shallow", split),
                           cache=cache)
    assert same is cache
    np.testing.assert_allclose(sh.numpy(), full.numpy(), **TOL)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), **NET_TOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), **NET_TOL)
    np.testing.assert_allclose(sh.numpy(), np.asarray(jsh), **NET_TOL)


def test_deepcache_shallow_with_control_matches_jax(tiny, cn):
    """The shallow pass takes the first m skip residuals alone (the middle
    one is in the cache)."""
    params, model = tiny[:2]
    cparams, cmodel = cn
    x, t, ctx = _step()
    hint = np.random.default_rng(2).random((2, 128, 128, 3)).astype(np.float32)
    jctrl = jcn.apply(cparams, *_j(x, hint, t, ctx), jsd.TINY.unet)
    tctrl = tcn.apply(cmodel, *_t(x, hint, t, ctx))
    _, jcache = junet.apply(params["unet"], *_j(x, t, ctx), jsd.TINY.unet,
                            deepcache=("full", 3), control=jctrl)
    want, _ = junet.apply(params["unet"], *_j(x, t, ctx), jsd.TINY.unet,
                          deepcache=("shallow", 3), cache=jcache, control=tuple(jctrl[0][:3]),
                          freeu=FREEU)
    _, cache = tunet.apply(model.unet, *_t(x, t, ctx), deepcache=("full", 3), control=tctrl)
    got, _ = tunet.apply(model.unet, *_t(x, t, ctx), deepcache=("shallow", 3), cache=cache,
                         control=tuple(tctrl[0][:3]), freeu=FREEU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)


def test_two_cached_residuals_are_not_taken_for_a_pair(tiny):
    """Two skip residuals (split 2) are added to the two skips, as a
    (skips, middle) pair would add them; the JAX package's len == 2 test
    would read the first residual as the skip list."""
    model = tiny[1]
    x, t, ctx = _t(*_step())
    _, cache = tunet.apply(model.unet, x, t, ctx, deepcache=("full", 2))
    res = (torch.full_like(x[..., :1], 0.3).expand(2, 16, 16, 32).clone(),
           torch.full((2, 16, 16, 32), -0.2))
    kw = dict(deepcache=("shallow", 2), cache=cache)
    as_seq, _ = tunet.apply(model.unet, x, t, ctx, control=res, **kw)
    as_pair, _ = tunet.apply(model.unet, x, t, ctx, control=(list(res), None), **kw)
    assert torch.equal(as_seq, as_pair)
    alone, _ = tunet.apply(model.unet, x, t, ctx, **kw)
    assert not torch.allclose(as_seq, alone, atol=1e-3)


@pytest.mark.parametrize("m", [0, 7])
def test_deepcache_split_out_of_range_raises_as_jax(tiny, m):
    params, model = tiny[:2]
    x, t, ctx = _step()
    with pytest.raises(ValueError) as want:
        junet.apply(params["unet"], *_j(x, t, ctx), jsd.TINY.unet, deepcache=("full", m))
    with pytest.raises(ValueError) as got:
        tunet.apply(model.unet, *_t(x, t, ctx), deepcache=("full", m))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="needs cache="):
        tunet.apply(model.unet, *_t(x, t, ctx), deepcache=("shallow", 2))


def test_guidance_free_refuses_deepcache(tiny):
    _, model, ids, _, lat = tiny
    with torch.no_grad():
        c = tsd.encode_text(model, torch.from_numpy(ids))
        with pytest.raises(ValueError, match="no uncond branch"):
            tsd.sample_latents(model.unet, torch.from_numpy(lat), c, None, num_steps=STEPS,
                               guidance=GUIDANCE, deepcache_interval=2)


def test_inpaint_config_equals_jax():
    for f in dataclasses.fields(tunet.UNetConfig):
        assert getattr(tunet.SD15_INPAINT_CONFIG, f.name) == getattr(junet.SD15_INPAINT_CONFIG,
                                                                     f.name)
    assert tunet.SD15_INPAINT_CONFIG.in_channels == 9


# --- generate with the extras ----------------------------------------------

COMBOS = [
    ("ddim", dict(deepcache_interval=2, deepcache_split=2)),
    ("ddim", dict(deepcache_interval=2, deepcache_split=2, uncond_interval=2)),
    ("ddim", dict(freeu=FREEU)),
    ("ddim", dict(control=1.0, deepcache_interval=2, deepcache_split=3, uncond_interval=2,
                  freeu=FREEU)),
    ("heun", dict(control=0.6, deepcache_interval=2, deepcache_split=3, freeu=FREEU)),
    ("heun", dict(deepcache_interval=3, deepcache_split=1, uncond_interval=2)),
]


@pytest.mark.parametrize("method,kw", COMBOS)
def test_generate_with_extras_matches_jax(tiny, cn, method, kw):
    params, model, ids, uids, lat = tiny
    cparams, cmodel = cn
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if "control" in kw:
        hint = np.random.default_rng(9).random((1, 128, 128, 3)).astype(np.float32)
        jkw["control"] = (cparams, jnp.asarray(hint), kw["control"])
        tkw["control"] = (cmodel, torch.from_numpy(hint), kw["control"])
    want = np.asarray(jsd.generate(params, *_j(ids, uids, lat), jnp.float32(GUIDANCE),
                                   num_steps=STEPS, cfg=jsd.TINY, method=method, **jkw))
    got = tsd.generate(model, *_t(ids, uids, lat), GUIDANCE, num_steps=STEPS, method=method,
                       **tkw).numpy()
    _close_images(got, want)


# --- hires fix, img2img, inpaint -------------------------------------------

def test_noise_to_rung_matches_jax():
    z0, n = _rand(1, 4, 4, 4, seed=1), _rand(1, 4, 4, 4, seed=2)
    sigma = np.float32(3.25)
    want = jsd.noise_to_rung(jnp.asarray(z0), jnp.asarray(n), jnp.float32(sigma))
    got = tsd.noise_to_rung(torch.from_numpy(z0), torch.from_numpy(n), torch.tensor(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_hires_tail_start_rounds_as_jax():
    """hs - max(1, min(hs, int(round(hs * strength)))), Python's round (half
    to even), as jsd.generate_hires writes it inline."""
    for hs in range(1, 31):
        for strength in np.linspace(0.0, 1.0, 41):
            want = hs - max(1, min(hs, int(round(hs * float(strength)))))
            assert tsd.hires_tail_start(hs, float(strength)) == want
    assert tsd.hires_tail_start(20, 0.6) == 8  # the card's: 12 tail steps


@pytest.mark.parametrize("method", ["ddim", "euler_ancestral"])
def test_generate_hires_matches_jax(tiny, monkeypatch, method):
    """The JAX key splits three ways (base pass, re-noising, tail); the port
    draws the same normals in that order from its one generator."""
    params, model, ids, uids, lat = tiny
    key = jax.random.key(21)
    hs, strength = STEPS + 1, 0.6
    want = np.asarray(jsd.generate_hires(params, *_j(ids, uids, lat), key, jnp.float32(GUIDANCE),
                                         num_steps=STEPS, cfg=jsd.TINY, method=method,
                                         hires_steps=hs, hires_strength=strength))
    k_base, k_noise, k_hi = jax.random.split(key, 3)
    hi_shape = (1, 32, 32, 4)
    start = tsd.hires_tail_start(hs, strength)
    noises = [np.asarray(jax.random.normal(k_noise, hi_shape, jnp.float32))]
    if method == "euler_ancestral":
        noises = (jax_noises(k_base, 0, STEPS, lat.shape) + noises
                  + jax_noises(k_hi, start, hs, hi_shape))
    left = replay_noise(monkeypatch, noises)
    got = tsd.generate_hires(model, *_t(ids, uids, lat), torch.Generator(), GUIDANCE,
                             num_steps=STEPS, method=method, hires_steps=hs,
                             hires_strength=strength).numpy()
    assert not left and got.shape == (1, 64, 64, 3)
    _close_images(got, want)


def test_hires_upscale_is_jax_bilinear():
    lat = _rand(1, 6, 5, 4, seed=3)
    want = jax.image.resize(jnp.asarray(lat), (1, 12, 10, 4), method="bilinear")
    got = torch.nn.functional.interpolate(torch.from_numpy(lat).permute(0, 3, 1, 2),
                                          size=(12, 10), mode="bilinear",
                                          align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("uint8", [True, False])
def test_img2img_matches_jax(tiny, monkeypatch, uint8):
    params, model, ids, uids, _ = tiny
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    if not uint8:
        image = image.astype(np.float32) / 255.0
    key = jax.random.key(4)
    want = np.asarray(jsd.img2img(params, jnp.asarray(image), *_j(ids, uids), key,
                                  jnp.float32(GUIDANCE), num_steps=4, start_step=3,
                                  cfg=jsd.TINY))
    left = replay_noise(monkeypatch, [np.asarray(jax.random.normal(key, (1, 16, 16, 4),
                                                                   jnp.float32))])
    got = tsd.img2img(model, torch.from_numpy(image), *_t(ids, uids), torch.Generator(),
                      GUIDANCE, num_steps=4, start_step=3).numpy()
    assert not left
    _close_images(got, want)


@pytest.mark.parametrize("f", [2, 4, 8])
def test_latent_mask_picks_the_pixels_jax_picks(f):
    mask = (np.random.default_rng(f).random((2, 8 * f, 4 * f, 1)) > 0.5).astype(np.float32)
    want = jax.image.resize(jnp.asarray(mask), (2, 8, 4, 1), method="nearest")
    got = tsd.latent_mask(torch.from_numpy(mask), f)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = torch.nn.functional.interpolate(torch.from_numpy(mask).permute(0, 3, 1, 2),
                                            size=(8, 4), mode="nearest").permute(0, 2, 3, 1)
    assert not np.array_equal(plain.numpy(), np.asarray(want))


def test_inpaint_matches_jax():
    """A 9-channel TINY UNet, a seeded image and a half mask with a hole
    in the kept half: the image within 1 of the JAX package's and the kept
    pixels equal to the source, bit for bit."""
    jcfg = dataclasses.replace(jsd.TINY, unet=dataclasses.replace(jsd.TINY.unet, in_channels=9))
    tcfg = dataclasses.replace(tsd.TINY, unet=dataclasses.replace(tsd.TINY.unet, in_channels=9))
    params, model, ids, uids, lat = tiny_sd(jsd, tsd, jcfg, tcfg, seed=3)
    rng = np.random.default_rng(6)
    image = rng.integers(0, 256, (1, 32, 32, 3)).astype(np.uint8)
    mask = np.zeros((1, 32, 32, 1), np.float32)
    mask[:, :, 16:] = 1.0
    mask[:, 4:9, 3:7] = 1.0
    want = np.asarray(jsd.inpaint(params, jnp.asarray(image), jnp.asarray(mask), *_j(ids, uids, lat),
                                  jnp.float32(GUIDANCE), num_steps=STEPS, cfg=jcfg))
    got = tsd.inpaint(model, torch.from_numpy(image), torch.from_numpy(mask), *_t(ids, uids, lat),
                      GUIDANCE, num_steps=STEPS).numpy()
    _close_images(got, want)
    keep = np.broadcast_to(mask <= 0.5, got.shape)
    np.testing.assert_array_equal(got[keep], image[keep])
