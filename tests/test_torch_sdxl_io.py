"""The port's SDXL checkpoint maps and loader (io/state_map.py's SDXL part,
io/checkpoints.load_sdxl_params / save_sdxl_checkpoint) against the JAX
package's at TINY_XL on the CPU: the same keys and arrays, files of either
package read by the other bit for bit, and the refusals naming the key.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.io import checkpoints as jck
from tinyfusers_tpu.io import safetensors_io as jst
from tinyfusers_tpu.io import state_map as jsm
from tinyfusers_tpu.pipeline import sdxl as jsdxl
from tinyfusers_tpu_torch.io import checkpoints as tck
from tinyfusers_tpu_torch.io import safetensors_io as tst
from tinyfusers_tpu_torch.io import state_map as tsm
from tinyfusers_tpu_torch.io.from_jax import load_sdxl
from tinyfusers_tpu_torch.pipeline import sdxl as tsdxl

from torch_parity import few_torch_threads, random_tree  # noqa: F401

JCFG, TCFG = jsdxl.TINY_XL, tsdxl.TINY_XL


@pytest.fixture(scope="module")
def tiny():
    """The JAX tree (fp32 leaves), the port's model of it, and the JAX
    map's state of it."""
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          random_tree(lambda k: jsdxl.init(k, JCFG), 11))
    model = tsdxl.StableDiffusionXL(TCFG, device="cpu", seed=None)
    load_sdxl(model, params)
    state = {k: np.asarray(v) for k, v in jsm.sdxl_state_from_params(params, JCFG).items()}
    return params, model, state


def _same_module(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def test_state_from_params_equals_the_jax_map(tiny):
    """The same key set and the same arrays as the JAX sdxl_state_from_params,
    the prefixes of both towers and the label_emb MLP included."""
    _, model, want = tiny
    got = tsm.sdxl_state_from_params(model)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for key in ("model.diffusion_model.label_emb.0.0.weight",
                "model.diffusion_model.label_emb.0.2.bias",
                "conditioner.embedders.0.transformer.text_model.final_layer_norm.weight",
                "conditioner.embedders.1.model.text_projection",
                "conditioner.embedders.1.model.transformer.resblocks.1.attn.in_proj_weight"):
        assert key in got, key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_jax_file_loads_into_the_port_bit_for_bit(tiny, tmp_path, dtype):
    """A file the JAX map wrote gives, through load_sdxl_params, the module
    the JAX-tree bridge gives; in bf16 each value rounds as the JAX
    loader's jnp.asarray(x, bfloat16) does."""
    params, want, state = tiny
    path = tmp_path / "jax_xl.safetensors"
    jst.save_state_dict(state, path)
    got = tck.load_sdxl_params(path, TCFG, device="cpu", dtype=dtype)
    if dtype == torch.bfloat16:
        jtree = jck.load_sdxl_params(path, JCFG, dtype=jnp.bfloat16)
        want = tsdxl.StableDiffusionXL(TCFG, device="cpu", dtype=dtype, seed=None)
        load_sdxl(want, jax.tree.map(np.asarray, jtree))
    _same_module(got, want)


def test_save_sdxl_checkpoint_round_trips_and_the_jax_loader_reads_it(tiny, tmp_path):
    params, model, _ = tiny
    path = tmp_path / "port_xl.safetensors"
    tck.save_sdxl_checkpoint(model, path)
    _same_module(tck.load_sdxl_params(path, TCFG, device="cpu", dtype=torch.float32), model)
    back = jck.load_sdxl_params(path, JCFG, dtype=jnp.float32)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # cast on the way out, as chip_smoke.py writes SDXL-base (bf16)
    out = tmp_path / "port_xl_bf16.safetensors"
    tck.save_sdxl_checkpoint(model, out, dtype=torch.bfloat16)
    half = tst.load_state_dict(out)
    want = tsm.sdxl_state_from_params(model)
    assert half.keys() == want.keys()
    for k, v in half.items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, want[k].to(torch.bfloat16)), k
    got = tck.load_sdxl_params(out, TCFG, device="cpu", dtype=torch.bfloat16)
    _same_module(got, copy.deepcopy(model).to(torch.bfloat16))


def test_a_missing_label_emb_key_raises_naming_it(tiny):
    _, _, state = tiny
    model = tsdxl.StableDiffusionXL(TCFG, device="cpu", seed=None)
    key = "model.diffusion_model.label_emb.0.2.weight"
    with pytest.raises(KeyError, match=key):
        tsm.sdxl_params_from_state({k: v for k, v in state.items() if k != key}, model)
    with pytest.raises(KeyError):
        jsm.sdxl_params_from_state({k: v for k, v in state.items() if k != key}, JCFG)


def test_a_2d_proj_in_raises_naming_the_key(tiny):
    """SDXL files as published store 2-D proj_in / proj_out, which the JAX
    map's OIHW transpose cannot read: both packages raise, the port naming
    the key."""
    _, _, state = tiny
    key = "model.diffusion_model.input_blocks.4.1.proj_in.weight"
    bad = dict(state, **{key: state[key][:, :, 0, 0]})
    with pytest.raises(ValueError):
        jsm.sdxl_params_from_state(bad, JCFG)
    model = tsdxl.StableDiffusionXL(TCFG, device="cpu", seed=None)
    with pytest.raises(ValueError, match=key):
        tsm.sdxl_params_from_state(bad, model)
