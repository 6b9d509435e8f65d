"""The port's samplers of two network calls a step (heun,
dpmpp_2s_ancestral) and cached CFG against the JAX package's on the CPU,
through sd.generate at sd.TINY in fp32, 3 steps, CFG 7.5 (the one-call
samplers are in test_torch_samplers.py).

Tolerances as there: uint8 images may differ by 1 (a value on a
truncation boundary), after latents held to rtol = atol = 1e-4 by the
same runs' arithmetic. The ancestral sampler's noise is the JAX keys'
normals, replayed through samplers._normal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu_torch.pipeline import sd as tsd

from torch_parity import few_torch_threads, jax_noises, replay_noise, tiny_sd  # noqa: F401

STEPS = 3
GUIDANCE = 7.5


@pytest.fixture(scope="module")
def tiny():
    return tiny_sd(jsd, tsd, jsd.TINY, tsd.TINY)


def _both(tiny, monkeypatch, **kw):
    """(port image, JAX image) of one setting."""
    params, model, ids, uids, lat = tiny
    key = jax.random.key(11) if "ancestral" in kw.get("method", "") else None
    want = np.asarray(jsd.generate(
        params, jnp.asarray(ids), jnp.asarray(uids), jnp.asarray(lat), jnp.float32(GUIDANCE),
        num_steps=STEPS, cfg=jsd.TINY, key=key, **kw))
    gen = None
    if key is not None:
        left = replay_noise(monkeypatch, jax_noises(key, 0, STEPS, lat.shape))
        gen = torch.Generator()
    got = tsd.generate(model, torch.from_numpy(ids), torch.from_numpy(uids),
                       torch.from_numpy(lat), GUIDANCE, num_steps=STEPS, generator=gen,
                       **kw).numpy()
    if key is not None:
        assert not left
    return got, want


def _close(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("method", ["heun", "dpmpp_2s_ancestral"])
@pytest.mark.parametrize("schedule", ["ladder", "karras"])
def test_generate_matches_jax(tiny, monkeypatch, method, schedule):
    _close(*_both(tiny, monkeypatch, method=method, schedule=schedule))


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_cached_cfg_interval_2_matches_jax(tiny, monkeypatch, method):
    """The uncond branch every second network call: under heun, k counts
    calls, not steps."""
    _close(*_both(tiny, monkeypatch, method=method, schedule="karras", uncond_interval=2))


def test_cached_cfg_interval_1_is_the_batched_path(tiny):
    """k = 1 is the batched path itself: the same latents bit for bit."""
    _, model, ids, uids, lat = tiny
    with torch.no_grad():
        c = tsd.encode_text(model, torch.from_numpy(ids))
        uc = tsd.encode_text(model, torch.from_numpy(uids))
        base = tsd.sample_latents(model.unet, torch.from_numpy(lat), c, uc, num_steps=STEPS,
                                  guidance=GUIDANCE, method="heun")
        one = tsd.sample_latents(model.unet, torch.from_numpy(lat), c, uc, num_steps=STEPS,
                                 guidance=GUIDANCE, method="heun", uncond_interval=1)
    assert torch.equal(base, one)
