"""The port's sampler family (pipeline/samplers.py) against the JAX
package's on the CPU: the sigma ladders bit for bit, the samplers of one
network call a step on both schedules through sd.generate at sd.TINY in
fp32, and every sampler from a start_index.

Tolerances: the ladders (timesteps and sigmas) are exact, 0 fp32 ulps,
both schedules, 1 to 50 steps. Latents after the sampler rtol = atol =
1e-4 (the models' 1e-4, carried through the loop, as
tests/test_torch_pipeline.py holds DDIM); uint8 images may differ by 1
where a value sits on a truncation boundary. The analytic model of the
start_index test is elementwise fp32: rtol = atol = 1e-5.

The ancestral samplers draw their noise from a torch.Generator where the
JAX package splits a jax.random key per step, so the parity runs replace
the port's one draw function (samplers._normal) with the normals the JAX
keys give.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.pipeline import samplers as jsamplers
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu_torch.pipeline import samplers as tsamplers
from tinyfusers_tpu_torch.pipeline import sd as tsd

from torch_parity import few_torch_threads, jax_noises, replay_noise, tiny_sd  # noqa: F401

STEPS = 3
GUIDANCE = 7.5
# ddim is defined on the discrete ladder only; the rest on both schedules.
# The samplers of two network calls a step are in test_torch_samplers_2nfe.py.
CASES = [("ddim", "ladder")] + [(m, s) for m in ("euler", "euler_ancestral", "dpmpp_2m")
                                for s in tsamplers.SCHEDULES]


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("schedule", tsamplers.SCHEDULES)
@pytest.mark.parametrize("steps", [1, 3, 20, 50])
def test_sigma_ladder_is_jax_bit_for_bit(schedule, steps):
    jt, js = jsamplers.sigma_ladder(steps, schedule)
    tt, ts = tsamplers.sigma_ladder(steps, schedule)
    assert tt.dtype == ts.dtype == torch.float32
    assert tt.shape == (steps,) and ts.shape == (steps + 1,)
    assert _ulps(tt.numpy(), jt) == 0 and _ulps(ts.numpy(), js) == 0


def test_t_of_sigma_is_jnp_interp_bit_for_bit():
    """The continuous-timestep inversion, inside the table and clamped at
    both ends, as dpmpp_2s_ancestral's midpoints use it."""
    table = tsamplers._sigma_table()
    sig = np.concatenate([np.geomspace(1e-3, 20.0, 997), [0.0, 1e3, float(table[5])]])
    sig = sig.astype(np.float32)
    want = jnp.interp(jnp.asarray(sig), jnp.asarray(table.numpy()),
                      jnp.arange(1000, dtype=jnp.float32))
    got = tsamplers.t_of_sigma(torch.from_numpy(sig), table)
    assert _ulps(got.numpy(), want) == 0
    assert got[-3] == 0 and got[-2] == 999


@pytest.fixture(scope="module")
def tiny():
    return tiny_sd(jsd, tsd, jsd.TINY, tsd.TINY)


@pytest.mark.parametrize("method,schedule", CASES)
def test_generate_matches_jax(tiny, monkeypatch, method, schedule):
    params, model, ids, uids, lat = tiny
    key = jax.random.key(5) if "ancestral" in method else None
    want = np.asarray(jsd.generate(
        params, jnp.asarray(ids), jnp.asarray(uids), jnp.asarray(lat), jnp.float32(GUIDANCE),
        num_steps=STEPS, cfg=jsd.TINY, method=method, schedule=schedule, key=key))
    gen = None
    if key is not None:
        left = replay_noise(monkeypatch, jax_noises(key, 0, STEPS, lat.shape))
        gen = torch.Generator()
    got = tsd.generate(model, torch.from_numpy(ids), torch.from_numpy(uids),
                       torch.from_numpy(lat), GUIDANCE, num_steps=STEPS, method=method,
                       schedule=schedule, generator=gen).numpy()
    if key is not None:
        assert not left  # one draw a step, as the JAX scan splits its key
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _analytic(xp):
    """A stand-in network, elementwise in x and t: the sampler arithmetic
    alone, without a UNet to compile."""
    def model_fn(x, t):
        return 0.3 * x + 1e-3 * t * xp.tanh(x)
    return model_fn


@pytest.mark.parametrize("method", tsamplers.SAMPLERS)
@pytest.mark.parametrize("start_index", [0, 2])
def test_start_index_matches_jax(monkeypatch, method, start_index):
    steps = 5
    schedule = "ladder" if method == "ddim" else "karras"
    lat = np.random.default_rng(2).standard_normal((1, 4, 4, 4)).astype(np.float32)
    key = jax.random.key(7) if "ancestral" in method else None
    want = jsamplers.sample(_analytic(jnp), jnp.asarray(lat), steps, method=method, key=key,
                            schedule=schedule, start_index=start_index)
    gen = None
    if key is not None:
        replay_noise(monkeypatch, jax_noises(key, start_index, steps, lat.shape))
        gen = torch.Generator()
    got = tsamplers.sample(_analytic(torch), torch.from_numpy(lat), steps, method=method,
                           generator=gen, schedule=schedule, start_index=start_index)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_heun_skips_only_the_discarded_last_call():
    """The JAX scan makes 2 calls every step and throws the last step's
    second away; the port makes 2 * steps - 1 and gives the same latents
    (test_generate_matches_jax)."""
    calls = []

    def model_fn(x, t):
        calls.append(float(t))
        return 0.1 * x

    tsamplers.sample(model_fn, torch.zeros(1, 2, 2, 4), 4, method="heun")
    ts, _ = tsamplers.sigma_ladder(4)
    assert calls == [float(ts[0]), float(ts[1]), float(ts[1]), float(ts[2]), float(ts[2]),
                     float(ts[3]), float(ts[3])]


def test_bad_arguments_raise():
    x = torch.zeros(1, 2, 2, 4)
    with pytest.raises(ValueError, match="discrete timestep ladder"):
        tsamplers.sample(lambda x, t: x, x, 3, method="ddim", schedule="karras")
    with pytest.raises(ValueError, match="unknown sampler"):
        tsamplers.sample(lambda x, t: x, x, 3, method="lms")
    with pytest.raises(ValueError, match="unknown schedule"):
        tsamplers.sample(lambda x, t: x, x, 3, method="euler", schedule="cosine")
    with pytest.raises(ValueError, match="start_index"):
        tsamplers.sample(lambda x, t: x, x, 3, start_index=3)
    with pytest.raises(ValueError, match="Generator"):
        tsamplers.sample(lambda x, t: x, x, 3, method="euler_ancestral")
