"""The port's SD pipeline options against the JAX package's on the CPU:
guidance-free sampling, guidance rescale, prompt weights, v-prediction
(model_out_to_eps and a TINY v model end to end, as tests/test_sd2.py
runs the JAX one), and the SD2.x configs.

Tolerances: the elementwise pieces (cfg_rescale, apply_prompt_weights,
model_out_to_eps) fp32 rtol = atol = 1e-6; whole images through
sd.generate at TINY in fp32 within 1 of the uint8 value, as
tests/test_torch_pipeline.py holds DDIM.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.models import unet as junet
from tinyfusers_tpu.pipeline import ddim as jddim
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu_torch.models import unet as tunet
from tinyfusers_tpu_torch.pipeline import ddim as tddim
from tinyfusers_tpu_torch.pipeline import sd as tsd

from torch_parity import few_torch_threads, tiny_sd  # noqa: F401

STEPS = 3
GUIDANCE = 7.5
_V = dict(prediction_type="v", clip_skip_layers=1, clip_final_norm_on_skip=True)
J_TINY_V = dataclasses.replace(jsd.TINY, **_V)
T_TINY_V = dataclasses.replace(tsd.TINY, **_V)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close_images(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def tiny():
    return tiny_sd(jsd, tsd, jsd.TINY, tsd.TINY)


def _same_config(port, ref) -> None:
    """Every field of the port's config equals the JAX config's (which
    has fields for parts not ported yet, such as SDXL's ADM input)."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _same_config(a, b)
        else:
            assert a == b, f.name


def test_sd2_configs_equal_jax():
    _same_config(tunet.SD21_CONFIG, junet.SD21_CONFIG)
    assert junet.SD21_CONFIG.adm_in_channels is None
    assert tunet.SD21_CONFIG.heads_for(320) == junet.SD21_CONFIG.heads_for(320) == (5, 64)
    for name in ("SD15", "SD21_BASE", "SD21_V", "SD15_QUARTER", "TINY"):
        _same_config(getattr(tsd, name), getattr(jsd, name))


@pytest.mark.parametrize("phi", [0.0, 0.7, 1.0])
def test_cfg_rescale_matches_jax(phi):
    """Population std (jnp.std), fp32, the 1e-8 floor; a zero-std output
    takes the floor rather than dividing by 0."""
    e_cfg, e_cond = _rand(2, 4, 4, 4, seed=1) * 3.0, _rand(2, 4, 4, 4, seed=2)
    e_cfg[1] = 0.25  # a constant sample: its std is 0
    want = jddim.cfg_rescale(jnp.asarray(e_cfg), jnp.asarray(e_cond), phi)
    got = tddim.cfg_rescale(torch.from_numpy(e_cfg), torch.from_numpy(e_cond), phi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if phi == 0.0:
        np.testing.assert_array_equal(got.numpy(), e_cfg)
    bf = tddim.cfg_rescale(torch.from_numpy(e_cfg).bfloat16(), torch.from_numpy(e_cond), phi)
    assert bf.dtype == torch.bfloat16


def test_apply_prompt_weights_matches_jax():
    ctx, w = _rand(2, 16, 32, seed=3), 1.0 + 0.3 * _rand(2, 16, seed=4)
    want = jsd.apply_prompt_weights(jnp.asarray(ctx), jnp.asarray(w))
    got = tsd.apply_prompt_weights(torch.from_numpy(ctx), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t", [[11.0], [501.0], [981.0], [11.4, 980.6], [2.5, 3.5]])
def test_model_out_to_eps_matches_jax(t):
    """v -> eps at integer and continuous timesteps (rounded half to even,
    as jnp.round), per-batch timesteps broadcast over HWC."""
    out, lat = _rand(len(t), 4, 4, 4, seed=5), _rand(len(t), 4, 4, 4, seed=6)
    ts = np.asarray(t if len(t) > 1 else t[0], np.float32)
    want = jsd.model_out_to_eps(jnp.asarray(out), jnp.asarray(lat), jnp.asarray(ts), J_TINY_V)
    got = tsd.model_out_to_eps(torch.from_numpy(out), torch.from_numpy(lat),
                               torch.from_numpy(ts), T_TINY_V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    same = tsd.model_out_to_eps(torch.from_numpy(out), torch.from_numpy(lat),
                                torch.from_numpy(ts), tsd.TINY)
    assert torch.equal(same, torch.from_numpy(out))


def test_model_out_to_eps_inverts_the_v_parameterization():
    x0, eps = torch.from_numpy(_rand(2, 8, 8, 4, seed=7)), torch.from_numpy(_rand(2, 8, 8, 4, seed=8))
    acp = tddim.alphas_cumprod()
    for t in (11, 501, 981):
        a = acp[t]
        x_t = torch.sqrt(a) * x0 + torch.sqrt(1 - a) * eps
        v = torch.sqrt(a) * eps - torch.sqrt(1 - a) * x0
        got = tsd.model_out_to_eps(v, x_t, torch.tensor(float(t)), T_TINY_V)
        np.testing.assert_allclose(got.numpy(), eps.numpy(), rtol=1e-5, atol=1e-5)


def test_guidance_free_generate_matches_jax(tiny):
    params, model, ids, _, lat = tiny
    want = np.asarray(jsd.generate(params, jnp.asarray(ids), None, jnp.asarray(lat),
                                   jnp.float32(GUIDANCE), num_steps=STEPS, cfg=jsd.TINY,
                                   method="euler", schedule="karras"))
    got = tsd.generate(model, torch.from_numpy(ids), None, torch.from_numpy(lat), GUIDANCE,
                       num_steps=STEPS, method="euler", schedule="karras").numpy()
    _close_images(got, want)


def test_guidance_free_refuses_cached_cfg(tiny):
    _, model, ids, _, lat = tiny
    with torch.no_grad():
        c = tsd.encode_text(model, torch.from_numpy(ids))
        with pytest.raises(ValueError, match="no uncond branch"):
            tsd.sample_latents(model.unet, torch.from_numpy(lat), c, None, num_steps=STEPS,
                               guidance=GUIDANCE, uncond_interval=2)


def test_prompt_weights_generate_matches_jax(tiny):
    params, model, ids, uids, lat = tiny
    w = np.ones((1, ids.shape[1]), np.float32)
    w[0, 2:5] = [1.3, 1.21, 0.9]
    want = np.asarray(jsd.generate(params, jnp.asarray(ids), jnp.asarray(uids),
                                   jnp.asarray(lat), jnp.float32(GUIDANCE), num_steps=STEPS,
                                   cfg=jsd.TINY, prompt_weights=jnp.asarray(w)))
    got = tsd.generate(model, torch.from_numpy(ids), torch.from_numpy(uids),
                       torch.from_numpy(lat), GUIDANCE, num_steps=STEPS,
                       prompt_weights=torch.from_numpy(w)).numpy()
    _close_images(got, want)


def test_tiny_v_model_end_to_end_matches_jax():
    """The card's setting in miniature: a v model, penultimate CLIP with
    the final norm, dpmpp_2m on the Karras ladder, guidance rescale 0.7."""
    params, model, ids, uids, lat = tiny_sd(jsd, tsd, J_TINY_V, T_TINY_V, seed=2)
    kw = dict(num_steps=STEPS, method="dpmpp_2m", schedule="karras", cfg_rescale=0.7)
    want = np.asarray(jsd.generate(params, jnp.asarray(ids), jnp.asarray(uids),
                                   jnp.asarray(lat), jnp.float32(GUIDANCE), cfg=J_TINY_V, **kw))
    got = tsd.generate(model, torch.from_numpy(ids), torch.from_numpy(uids),
                       torch.from_numpy(lat), GUIDANCE, **kw).numpy()
    _close_images(got, want)
