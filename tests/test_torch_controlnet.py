"""The port's ControlNet (models/controlnet.py, its checkpoint map and
loader) against the JAX package's on the CPU, at TINY.

Weights come from tests/torch_parity.py::random_tree, which fills every
leaf, the zero convs and the hint encoder's last conv included, with
seeded non-zero values: under the JAX init those are zeros, and the branch
would add nothing to compare. The neutral (freshly initialized) branch is
checked on its own to be an exact no-op.

Tolerances: the hint encoder and one ControlNet forward in fp32 at rtol =
atol = 1e-5, the UNet fed its residuals at 1e-4 as
tests/test_torch_models.py holds the UNet (the two sides differ in
summation order only); whole images through
sd.generate within 1 of the uint8 value, as tests/test_torch_pipeline.py
holds DDIM; state maps and checkpoint round trips bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.io import checkpoints as jck
from tinyfusers_tpu.io import state_map as jsm
from tinyfusers_tpu.models import controlnet as jcn
from tinyfusers_tpu.models import unet as junet
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu_torch.io import checkpoints as tck
from tinyfusers_tpu_torch.io import state_map as tsm
from tinyfusers_tpu_torch.io.from_jax import load_params
from tinyfusers_tpu_torch.models import controlnet as tcn
from tinyfusers_tpu_torch.models import unet as tunet
from tinyfusers_tpu_torch.pipeline import sd as tsd

from torch_parity import (bf16_against_jax_jit, every_finite_bf16, few_torch_threads,  # noqa: F401
                          random_tree, tiny_sd)

TOL = dict(rtol=1e-5, atol=1e-5)
UCFG = jsd.TINY.unet


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def cn():
    """(JAX ControlNet tree, the port's ControlNet loaded from it)."""
    params = random_tree(lambda k: jcn.init(k, UCFG), 7)
    model = tcn.ControlNet(tsd.TINY.unet, device="cpu", seed=None)
    load_params(model, params)
    return params, model


@pytest.fixture(scope="module")
def tiny():
    return tiny_sd(jsd, tsd, jsd.TINY, tsd.TINY)


def _hint(lat_hw, seed=3):
    h, w = lat_hw
    return np.random.default_rng(seed).random((1, 8 * h, 8 * w, 3)).astype(np.float32)


def _step_inputs(b=2):
    x = _rand(b, 8, 8, 4, seed=1)
    t = np.full((b,), 501.0, np.float32)
    ctx = _rand(b, 16, UCFG.context_dim, seed=2)
    return x, t, ctx


def test_ladder_and_skip_channels_equal_jax():
    assert tcn._HINT_LADDER == jcn._HINT_LADDER
    for cfg in (junet.TINY_CONFIG, junet.SD15_CONFIG, junet.SD21_CONFIG):
        assert tcn._skip_channels(cfg) == jcn._skip_channels(cfg)


def test_encode_hint_matches_jax(cn):
    params, model = cn
    hint = _hint((8, 8))
    want = jcn.encode_hint(params, jnp.asarray(hint))
    got = tcn.encode_hint(model, torch.from_numpy(hint))
    assert tuple(got.shape) == (1, 8, 8, UCFG.model_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scale", [1.0, 0.45])
@pytest.mark.parametrize("features", [False, True])
def test_controlnet_apply_matches_jax(cn, scale, features):
    """Every residual and the middle one, from the hint or from its encoded
    features, at two scales."""
    params, model = cn
    x, t, ctx = _step_inputs()
    hint = np.concatenate([_hint((8, 8), 3), _hint((8, 8), 4)])
    feats = jcn.encode_hint(params, jnp.asarray(hint)) if features else None
    want_skips, want_mid = jcn.apply(params, jnp.asarray(x), None if features else jnp.asarray(hint),
                                     jnp.asarray(t), jnp.asarray(ctx), UCFG, scale=scale,
                                     hint_features=feats)
    tfeats = torch.from_numpy(np.array(feats)) if features else None
    got_skips, got_mid = tcn.apply(model, torch.from_numpy(x),
                                   None if features else torch.from_numpy(hint),
                                   torch.from_numpy(t), torch.from_numpy(ctx), scale=scale,
                                   hint_features=tfeats)
    assert len(got_skips) == len(want_skips) == len(tcn._skip_channels(UCFG))
    for g, w in zip(got_skips, want_skips):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(got_mid.numpy(), np.asarray(want_mid), **TOL)


def test_unet_with_control_residuals_matches_jax(cn, tiny):
    params, model = cn
    jparams, sd_model = tiny[:2]
    x, t, ctx = _step_inputs()
    hint = _hint((8, 8))
    ctrl = jcn.apply(params, jnp.asarray(x), jnp.asarray(np.repeat(hint, 2, 0)), jnp.asarray(t),
                     jnp.asarray(ctx), UCFG)
    want = junet.apply(jparams["unet"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), UCFG,
                       control=ctrl)
    tctrl = tcn.apply(model, torch.from_numpy(x), torch.from_numpy(np.repeat(hint, 2, 0)),
                      torch.from_numpy(t), torch.from_numpy(ctx))
    got = tunet.apply(sd_model.unet, torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(ctx), control=tctrl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    plain = tunet.apply(sd_model.unet, torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(ctx))
    assert not torch.allclose(got, plain, atol=1e-3)  # the residuals steer


def test_unet_refuses_control_of_the_wrong_length(tiny):
    sd_model = tiny[1]
    x, t, ctx = (torch.from_numpy(a) for a in _step_inputs())
    skips = [torch.zeros(1)] * 3
    with pytest.raises(ValueError, match="control has 3 skip residuals"):
        tunet.apply(sd_model.unet, x, t, ctx, control=(skips, torch.zeros(1)))


def test_neutral_controlnet_is_an_exact_noop(tiny):
    """The JAX init's zero convs gate every residual to exactly 0: the
    controlled image equals the plain one bit for bit, as in the JAX
    package (tests/test_controlnet.py)."""
    _, sd_model, ids, uids, lat = tiny
    neutral = tcn.ControlNet(tsd.TINY.unet, device="cpu", seed=5)
    assert all(float(z.weight.abs().max()) == 0.0
               for z in [*neutral.zero_convs, neutral.middle_out, neutral.input_hint[-1]])
    hint = torch.from_numpy(_hint(lat.shape[1:3]))
    args = (sd_model, torch.from_numpy(ids), torch.from_numpy(uids), torch.from_numpy(lat), 5.0)
    base = tsd.generate(*args, num_steps=2)
    ctrl = tsd.generate(*args, num_steps=2, control=(neutral, hint, 1.0))
    assert torch.equal(base, ctrl)


def test_generate_with_control_matches_jax(cn, tiny):
    params, model = cn
    jparams, sd_model, ids, uids, lat = tiny
    hint = _hint(lat.shape[1:3])
    want = np.asarray(jsd.generate(jparams, jnp.asarray(ids), jnp.asarray(uids), jnp.asarray(lat),
                                   jnp.float32(5.0), num_steps=3, cfg=jsd.TINY,
                                   control=(params, jnp.asarray(hint), 0.8)))
    got = tsd.generate(sd_model, torch.from_numpy(ids), torch.from_numpy(uids),
                       torch.from_numpy(lat), 5.0, num_steps=3,
                       control=(model, torch.from_numpy(hint), 0.8)).numpy()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    base = tsd.generate(sd_model, torch.from_numpy(ids), torch.from_numpy(uids),
                        torch.from_numpy(lat), 5.0, num_steps=3).numpy()
    assert not np.array_equal(base, got)


def test_state_map_matches_jax_both_ways(cn):
    """controlnet_to_state gives the JAX package's keys and tensors bit for
    bit; controlnet_from_state of the JAX package's state gives the same
    module back."""
    params, model = cn
    # random_tree's weights are float64 (numpy's division); the module holds fp32
    want = {k: np.asarray(v, np.float32) for k, v in jsm.controlnet_to_state(params, UCFG).items()}
    got = tsm.controlnet_to_state(model)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    back = tcn.ControlNet(tsd.TINY.unet, device="cpu", seed=None)
    tsm.controlnet_from_state({k: np.asarray(v) for k, v in want.items()}, back)
    for (n, a), (_, b) in zip(model.state_dict().items(), back.state_dict().items()):
        assert torch.equal(a, b), n


def test_state_map_key_scheme():
    keys = set(tsm.controlnet_to_state(tcn.ControlNet(tsd.TINY.unet, device="cpu")))
    for k in ("input_hint_block.0.weight", "input_hint_block.14.weight",
              "zero_convs.0.0.weight", "middle_block_out.0.weight", "time_embed.0.weight",
              "input_blocks.1.0.in_layers.2.weight"):
        assert f"control_model.{k}" in keys
    assert all(k.startswith("control_model.") for k in keys)


def test_state_map_names_a_missing_key(cn):
    state = tsm.controlnet_to_state(cn[1])
    del state["control_model.zero_convs.2.0.bias"]
    with pytest.raises(KeyError, match="zero_convs.2.0.bias"):
        tsm.controlnet_from_state(state, tcn.ControlNet(tsd.TINY.unet, device="cpu", seed=None))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_checkpoint_round_trip_and_the_jax_loader(cn, tmp_path, dtype):
    """save_controlnet_checkpoint then load_controlnet_params gives the
    weights back (after the file's rounding); the JAX package's loader
    reads the same file into the same numbers."""
    params, model = cn
    path = tmp_path / "cn.safetensors"
    tck.save_controlnet_checkpoint(model, path, dtype=dtype)
    back = tck.load_controlnet_params(path, tsd.TINY.unet, device="cpu", dtype=torch.float32)
    for (n, a), (_, b) in zip(model.state_dict().items(), back.state_dict().items()):
        assert torch.equal(a.to(dtype).float(), b), n
    jparams = jck.load_controlnet_params(path, UCFG, dtype=jnp.float32)
    jback = jax.tree.map(np.asarray, jparams)
    ref = tcn.ControlNet(tsd.TINY.unet, device="cpu", seed=None)
    load_params(ref, jback)
    for (n, a), (_, b) in zip(ref.state_dict().items(), back.state_dict().items()):
        assert torch.equal(a, b), n


def test_load_controlnet_params_reads_the_hint_channels(tmp_path):
    one = tcn.ControlNet(tsd.TINY.unet, hint_channels=1, device="cpu", seed=2)
    path = tmp_path / "depth.safetensors"
    tck.save_controlnet_checkpoint(one, path)
    back = tck.load_controlnet_params(path, tsd.TINY.unet, device="cpu", dtype=torch.float32)
    assert back.input_hint[0].weight.shape[1] == 1


def test_controlnet_runs_on_the_gpu_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcn.ControlNet(tsd.TINY.unet)


@pytest.mark.parametrize("scale,unrounded", [(0.9, 21832), (1.0, 0)])
def test_controlnet_scale_bf16_equals_jax_jit_at_every_normal_value(scale, unrounded):
    """The JAX ControlNet's ``scale * residual`` rounds the scale to bf16
    first; the port's ``scaled`` must give the same bits at every value XLA
    does not flush, at chip_smoke.py's 0.9 and the CLI's default 1.0. The
    scale left in fp32 (the parent's form) differs at 0.9, not at 1.0."""
    x = every_finite_bf16()
    jax_fn = lambda r: scale * r  # noqa: E731  (models/controlnet.py's residual scaling)
    differ, flushed = bf16_against_jax_jit(tcn.scaled(x, scale), jax_fn, x)
    assert differ.numel() == 0, differ[:8].tolist()
    assert flushed == (284 if scale == 0.9 else 254)
    assert bf16_against_jax_jit(scale * x, jax_fn, x)[0].numel() == unrounded
    assert torch.equal(tcn.scaled(x, torch.tensor(scale)), tcn.scaled(x, scale))
