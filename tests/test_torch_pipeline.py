"""The port's SD pipeline against the JAX package's on the CPU (sd.TINY,
fp32, 3 DDIM steps, CFG 7.5), the DDIM pieces, the device rules of the
entry points, and that neither the port nor chip_smoke.py imports jax or
tinyfusers_tpu.

Tolerances: DDIM schedule and update 1e-6 (fp32 elementwise); latents
after 3 steps rtol/atol 1e-4 (the models' 1e-4, carried through the
loop); uint8 images may differ by 1 where a value sits on a truncation
boundary.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.pipeline import ddim as jddim
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu_torch.io.from_jax import load_sd
from tinyfusers_tpu_torch.pipeline import ddim as tddim
from tinyfusers_tpu_torch.pipeline import sd as tsd

from torch_parity import few_torch_threads, random_tree  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
STEPS = 3


@pytest.fixture(scope="module")
def tiny():
    """JAX-layout params, the port's model loaded from them, and inputs."""
    params = random_tree(lambda k: jsd.init(k, jsd.TINY), 0)
    model = tsd.StableDiffusion(tsd.TINY, device="cpu", seed=None)
    load_sd(model, params)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 127, (1, 16)).astype(np.int32)
    uids = np.full((1, 16), 127, np.int32)
    uids[0, 0] = 0
    lat = rng.standard_normal((1, *tsd.TINY.latent_shape)).astype(np.float32)
    return params, model, ids, uids, lat


def test_generate_matches_jax(tiny):
    params, model, ids, uids, lat = tiny
    want = np.asarray(jsd.generate(params, jnp.asarray(ids), jnp.asarray(uids),
                                   jnp.asarray(lat), jnp.float32(7.5),
                                   num_steps=STEPS, cfg=jsd.TINY))
    got = tsd.generate(model, torch.from_numpy(ids), torch.from_numpy(uids),
                       torch.from_numpy(lat), 7.5, num_steps=STEPS).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sample_latents_match_jax(tiny):
    params, model, ids, uids, lat = tiny

    def jax_latents(p, i, u, x):
        c, uc = jsd.encode_text(p, i, jsd.TINY), jsd.encode_text(p, u, jsd.TINY)
        return jsd.sample_latents(p["unet"], x, c, uc, num_steps=STEPS,
                                  guidance=7.5, cfg=jsd.TINY)

    want = jax.jit(jax_latents)(params, jnp.asarray(ids), jnp.asarray(uids),
                                jnp.asarray(lat))
    with torch.no_grad():
        c = tsd.encode_text(model, torch.from_numpy(ids))
        uc = tsd.encode_text(model, torch.from_numpy(uids))
        got = tsd.sample_latents(model.unet, torch.from_numpy(lat), c, uc,
                                 num_steps=STEPS, guidance=7.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_denoise_step_matches_jax(tiny):
    params, model, _, _, lat = tiny
    ctx2 = np.random.default_rng(2).standard_normal((2, 16, 32)).astype(np.float32)
    alphas, alphas_prev = jddim.ddim_alphas(20)
    want = jax.jit(lambda p, x, c: jsd.denoise_step(
        p, x, jnp.int32(951), c, jnp.float32(7.5), alphas[-1], alphas_prev[-1],
        jsd.TINY))(params["unet"], jnp.asarray(lat), jnp.asarray(ctx2))
    ta, tap = tddim.ddim_alphas(20)
    with torch.no_grad():
        got = tsd.denoise_step(model.unet, torch.from_numpy(lat), 951.0,
                               torch.from_numpy(ctx2), 7.5, ta[-1], tap[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_ddim_schedule_and_update_match_jax():
    np.testing.assert_allclose(tddim.alphas_cumprod().numpy(),
                               np.asarray(jddim.alphas_cumprod()), rtol=1e-6, atol=1e-7)
    for steps in (3, 20, 50):
        np.testing.assert_array_equal(tddim.ddim_timesteps_np(steps),
                                      jddim.ddim_timesteps_np(steps))
        for a, b in zip(tddim.ddim_alphas(steps), jddim.ddim_alphas(steps)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(0)
    x, e, e2 = (rng.standard_normal((1, 4, 4, 4)).astype(np.float32) for _ in range(3))
    got = tddim.ddim_step(torch.from_numpy(x), torch.from_numpy(e), 0.3, 0.6)
    want = jddim.ddim_step(jnp.asarray(x), jnp.asarray(e), jnp.float32(0.3), jnp.float32(0.6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    got = tddim.cfg_combine(torch.from_numpy(e), torch.from_numpy(e2), 7.5)
    want = jddim.cfg_combine(jnp.asarray(e), jnp.asarray(e2), jnp.float32(7.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_entry_points_default_to_the_gpu_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tsd.StableDiffusion(tsd.TINY)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tsd.initial_latent(0, 1, tsd.TINY)


def _run(args, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, timeout=timeout,
                          capture_output=True, text=True)


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tinyfusers_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('txt2img_torch', "
        "'examples/txt2img_torch.py')\n"
        "cli = importlib.util.module_from_spec(spec)\n"
        "sys.modules[spec.name] = cli\n"
        "spec.loader.exec_module(cli)\n"
        "cli.parse_args([])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'tinyfusers_tpu' or m.startswith('tinyfusers_tpu.')]\n"
        "assert not bad, bad\n"
        "print('modules', sum(m.startswith('tinyfusers_tpu_torch') for m in sys.modules))\n"
    )
    out = _run(["-c", code], ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = _run(["chip_smoke.py"], ROOT)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
