"""The port's SD3 / T5 single-file checkpoint maps (io/state_map.py's SD3
part, io/checkpoints.load_sd3_params / save_sd3_checkpoint) against the
JAX package's on the CPU at TINY_SD3, TINY_SD3_T5 and TINY_MMDIT_QKN: the
same numpy state in gives the same parameters out, ``*_to_state`` equals
the JAX map key for key, the pre-only last block, the pos_embed crop and
its refusals, the T5 ``embed_tokens`` fallback, and an MMDiT loaded from
a state whose fp32 output equals the JAX MMDiT's on the same state.

Tolerances: the maps are exact (indexing and copies); the MMDiT output
rtol / atol 1e-4, as tests/test_torch_sd3.py holds the MMDiT.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.io import state_map as jsm
from tinyfusers_tpu.models import mmdit as jmmdit
from tinyfusers_tpu.models import t5 as jt5
from tinyfusers_tpu.pipeline import sd3 as jsd3
from tinyfusers_tpu_torch.io import checkpoints as tck
from tinyfusers_tpu_torch.io import state_map as tsm
from tinyfusers_tpu_torch.io.from_jax import load_params, load_sd3
from tinyfusers_tpu_torch.models import mmdit as tmmdit
from tinyfusers_tpu_torch.models import t5 as tt5
from tinyfusers_tpu_torch.pipeline import sd3 as tsd3

from torch_parity import few_torch_threads, random_tree  # noqa: F401

PFX = "model.diffusion_model"
MMDIT_CFGS = {"TINY_MMDIT": (jmmdit.TINY_MMDIT, tmmdit.TINY_MMDIT),
              "TINY_MMDIT_QKN": (jmmdit.TINY_MMDIT_QKN, tmmdit.TINY_MMDIT_QKN)}


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def np_state(state):
    return {k: np.asarray(v, np.float32) for k, v in state.items()}


def same_params(got, want):
    """Every parameter of two modules equal, bit for bit."""
    a, b = dict(got.named_parameters()), dict(want.named_parameters())
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def same_state(got, want):
    """A port state equal to a JAX map's, key for key and bit for bit."""
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# -- the fused qkv and the pos-embed crop ------------------------------------

@pytest.mark.parametrize("heads,hd,din", [(4, 16, 64), (3, 8, 40)])
def test_fused_qkv_permutation_matches_jax(heads, hd, din):
    """The rows of a (3d, in) torch weight and its bias go where the JAX
    map's columns go; the inverse gives torch's rows back."""
    w, b = rand(0, 3 * heads * hd, din), rand(1, 3 * heads * hd)
    want = jsm._fused_qkv_from_torch(w, b, heads)
    take = tsm._fused_qkv_from_torch(heads)
    got_w, got_b = take(torch.from_numpy(w)), take(torch.from_numpy(b))
    np.testing.assert_array_equal(got_w.numpy(), want["weight"].T)  # (out, in) rows
    np.testing.assert_array_equal(got_b.numpy(), want["bias"])
    give = tsm._fused_qkv_to_torch(heads)
    back_w, back_b = jsm._fused_qkv_to_torch(want, heads)
    np.testing.assert_array_equal(give(got_w).numpy(), back_w)
    np.testing.assert_array_equal(give(got_b).numpy(), back_b)
    np.testing.assert_array_equal(back_w, w)


@pytest.mark.parametrize("stored,grid", [(12, 4), (12, 12), (9, 4), (192, 64)])
def test_crop_pos_embed_matches_jax(stored, grid):
    pe = rand(2, 1, stored * stored, 8)
    got = tsm._crop_pos_embed(torch.from_numpy(pe), grid)
    want = jsm._crop_pos_embed(pe, grid)
    np.testing.assert_array_equal(got.numpy(), want)
    top = (stored - grid) // 2
    np.testing.assert_array_equal(
        got.numpy().reshape(grid, grid, 8),
        pe.reshape(stored, stored, 8)[top:top + grid, top:top + grid])


@pytest.mark.parametrize("tokens,grid,match", [(50, 4, "not square"), (16, 8, "exceeds")])
def test_crop_pos_embed_raises_as_jax_does(tokens, grid, match):
    pe = rand(3, 1, tokens, 8)
    with pytest.raises(ValueError, match=match):
        jsm._crop_pos_embed(pe, grid)
    with pytest.raises(ValueError, match=match):
        tsm._crop_pos_embed(torch.from_numpy(pe), grid)


# -- the MMDiT map -------------------------------------------------------------

def _mmdit_state(jcfg, seed, stored_grid=None):
    """(JAX tree, the JAX map's numpy state of it): with a learned
    pos_embed of ``stored_grid``² tokens when given."""
    params = random_tree(lambda k: jmmdit.init(k, jcfg), seed)
    state = np_state(jsm.mmdit_to_state(params, jcfg))
    if stored_grid:
        state[f"{PFX}.pos_embed"] = rand(seed + 1, 1, stored_grid ** 2, jcfg.dim)
    return params, state


@pytest.mark.parametrize("name", list(MMDIT_CFGS))
@pytest.mark.parametrize("stored_grid", [None, 12])
def test_mmdit_from_state_matches_jax(name, stored_grid):
    """The same state in: the port's module equals the JAX tree the JAX
    map gives (the crop included), and its state equals the JAX map's of
    that tree key for key."""
    jcfg, tcfg = MMDIT_CFGS[name]
    _, state = _mmdit_state(jcfg, 0, stored_grid)
    learned = stored_grid is not None
    got = tmmdit.MMDiT(tcfg, learned_pos_embed=learned, device="cpu")
    tsm.mmdit_from_state(state, got)
    jtree = jsm.mmdit_from_state(state, jcfg)
    assert ("pos_embed" in jtree) == learned
    want = tmmdit.MMDiT(tcfg, learned_pos_embed=learned, device="cpu")
    load_params(want, jtree)
    same_params(got, want)
    same_state(tsm.mmdit_to_state(got), jsm.mmdit_to_state(jtree, jcfg))


def test_pre_only_last_block():
    """The last context_block's 2-chunk adaLN fills the first 2d rows of
    its 6d mod, the rest zero, its proj and mlp zero; to_state writes
    neither them nor the upper rows back."""
    jcfg, tcfg = MMDIT_CFGS["TINY_MMDIT"]
    _, state = _mmdit_state(jcfg, 4)
    last = f"{PFX}.joint_blocks.{jcfg.depth - 1}.context_block"
    assert state[f"{last}.adaLN_modulation.1.weight"].shape == (2 * jcfg.dim, jcfg.dim)
    assert f"{last}.attn.proj.weight" not in state and f"{last}.mlp.fc1.bias" not in state
    model = tmmdit.MMDiT(tcfg, device="cpu")
    tsm.mmdit_from_state(state, model)
    txt = model.blocks[-1].txt
    d = tcfg.dim
    np.testing.assert_array_equal(txt.mod.weight[:2 * d].numpy(),
                                  state[f"{last}.adaLN_modulation.1.weight"])
    np.testing.assert_array_equal(txt.mod.bias[:2 * d].numpy(),
                                  state[f"{last}.adaLN_modulation.1.bias"])
    assert not txt.mod.weight[2 * d:].any() and not txt.mod.bias[2 * d:].any()
    for leaf in (txt.proj, txt.mlp.fc1, txt.mlp.fc2):
        assert not leaf.weight.any() and not leaf.bias.any()
    assert model.blocks[0].txt.proj.weight.any()  # the other blocks are whole
    out = tsm.mmdit_to_state(model)
    assert out.keys() == state.keys()
    assert tuple(out[f"{last}.adaLN_modulation.1.weight"].shape) == (2 * d, d)


def test_a_stored_grid_round_trips_cropped_as_in_jax():
    """A 12² grid read into a 4² model is written back as the 4² crop, as
    the JAX map writes it."""
    jcfg, tcfg = MMDIT_CFGS["TINY_MMDIT"]
    _, state = _mmdit_state(jcfg, 5, stored_grid=12)
    model = tmmdit.MMDiT(tcfg, learned_pos_embed=True, device="cpu")
    tsm.mmdit_from_state(state, model)
    got = tsm.mmdit_to_state(model)[f"{PFX}.pos_embed"]
    want = jsm.mmdit_to_state(jsm.mmdit_from_state(state, jcfg), jcfg)[f"{PFX}.pos_embed"]
    assert tuple(got.shape) == (1, 16, jcfg.dim)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mmdit_map_refusals_name_what_is_wrong():
    jcfg, tcfg = MMDIT_CFGS["TINY_MMDIT"]
    _, state = _mmdit_state(jcfg, 6, stored_grid=12)
    with pytest.raises(ValueError, match="learned_pos_embed=True"):
        tsm.mmdit_from_state(state, tmmdit.MMDiT(tcfg, device="cpu"))
    del state[f"{PFX}.pos_embed"]
    with pytest.raises(KeyError, match="pos_embed"):
        tsm.mmdit_from_state(state, tmmdit.MMDiT(tcfg, learned_pos_embed=True, device="cpu"))
    key = f"{PFX}.joint_blocks.0.x_block.attn.qkv.bias"
    del state[key]
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        tsm.mmdit_from_state(state, tmmdit.MMDiT(tcfg, device="cpu"))


@pytest.mark.parametrize("name", list(MMDIT_CFGS))
def test_mmdit_loaded_from_state_matches_jax_output(name):
    """fp32, the txt pad and kv_len off (16 + 8 tokens): the port's MMDiT
    read from a state against the JAX MMDiT the JAX map reads from it."""
    jcfg, tcfg = MMDIT_CFGS[name]
    _, state = _mmdit_state(jcfg, 7, stored_grid=6)
    model = tmmdit.MMDiT(tcfg, learned_pos_embed=True, device="cpu")
    tsm.mmdit_from_state(state, model)
    x, t = rand(8, 2, 8, 8, 4), np.array([0.9, 0.2], np.float32)
    ctx, pooled = rand(9, 2, jcfg.context_len, jcfg.context_dim), rand(10, 2, jcfg.pooled_dim)
    want = jmmdit.apply(jsm.mmdit_from_state(state, jcfg), jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(ctx), jnp.asarray(pooled), jcfg)
    with torch.no_grad():
        got = tmmdit.apply(model, *map(torch.from_numpy, (x, t, ctx, pooled)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# -- T5 ------------------------------------------------------------------------

T5_CFGS = {"TINY_T5": (jt5.TINY_T5, tt5.TINY_T5),
           "TINY_SD3_T5": (jsd3.TINY_SD3_T5.t5, tsd3.TINY_SD3_T5.t5)}


@pytest.mark.parametrize("name", list(T5_CFGS))
@pytest.mark.parametrize("embedding", ["shared", "embed_tokens"])
def test_t5_maps_match_jax(name, embedding):
    """The same state in, the same parameters out; a state whose embedding
    is only encoder.embed_tokens reads the same; to_state equals the JAX
    map key for key (shared.weight, no bias, the relative bias of block 0)."""
    jcfg, tcfg = T5_CFGS[name]
    params = random_tree(lambda k: jt5.init(k, jcfg), 12)
    state = np_state(jsm.t5_to_state(params, jcfg))
    if embedding == "embed_tokens":
        emb = state.pop(f"{jsm.T5_PREFIX}.shared.weight")
        state[f"{jsm.T5_PREFIX}.encoder.embed_tokens.weight"] = emb
    got = tt5.T5Encoder(tcfg, device="cpu")
    tsm.t5_from_state(state, got)
    want = tt5.T5Encoder(tcfg, device="cpu")
    jtree = jsm.t5_from_state(state, jcfg)
    load_params(want, jtree)
    same_params(got, want)
    same_state(tsm.t5_to_state(got), jsm.t5_to_state(jtree, jcfg))
    assert not any(".bias" in k for k in state)
    assert not any("relative_attention_bias" in k and ".block.0." not in k for k in state)


# -- the whole SD3 file ----------------------------------------------------------

SD3_CFGS = {"TINY_SD3": (jsd3.TINY_SD3, tsd3.TINY_SD3),
            "TINY_SD3_T5": (jsd3.TINY_SD3_T5, tsd3.TINY_SD3_T5)}


def _sd3_state(jcfg, seed, stored_grid=12):
    params = random_tree(lambda k: jsd3.init(k, jcfg), seed)
    state = np_state(jsm.sd3_state_from_params(params, jcfg))
    state[f"{PFX}.pos_embed"] = rand(seed + 1, 1, stored_grid ** 2, jcfg.mmdit.dim)
    return state


@pytest.mark.parametrize("name", list(SD3_CFGS))
def test_sd3_maps_match_jax(name):
    """Both towers (HF layout, text_projection a sibling of text_model),
    the MMDiT with its cropped grid, the VAE and T5 where the config has
    it: the port's model equals load_sd3 of the JAX map's tree, and its
    state equals the JAX map's key for key."""
    jcfg, tcfg = SD3_CFGS[name]
    state = _sd3_state(jcfg, 20)
    assert "text_encoders.clip_g.transformer.text_projection.weight" in state
    assert any(k.startswith(jsm.T5_PREFIX) for k in state) == (jcfg.t5 is not None)
    got = tsd3.StableDiffusion3(tcfg, device="cpu", seed=None, learned_pos_embed=True)
    tsm.sd3_params_from_state(state, got)
    jtree = jsm.sd3_params_from_state(state, jcfg)
    want = tsd3.StableDiffusion3(tcfg, device="cpu", seed=None, learned_pos_embed=True)
    load_sd3(want, jax.tree.map(np.asarray, jtree))
    same_params(got, want)
    same_state(tsm.sd3_state_from_params(got), jsm.sd3_state_from_params(jtree, jcfg))


def test_t5_is_read_only_where_the_config_and_the_file_have_it():
    """A T5 config reading a file without T5 leaves its tower unwritten
    (load_sd3_params drops it); a config without T5 ignores a file's."""
    state = _sd3_state(jsd3.TINY_SD3, 21)
    model = tsd3.StableDiffusion3(tsd3.TINY_SD3_T5, device="cpu", seed=3, learned_pos_embed=True)
    before = model.t5.final_norm.weight.clone()
    tsm.sd3_params_from_state(state, model)
    assert torch.equal(model.t5.final_norm.weight, before)
    with_t5 = _sd3_state(jsd3.TINY_SD3_T5, 22)
    plain = tsd3.StableDiffusion3(tsd3.TINY_SD3, device="cpu", seed=None, learned_pos_embed=True)
    tsm.sd3_params_from_state(with_t5, plain)
    assert not hasattr(plain, "t5")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sd3_file_round_trips_bit_for_bit(tmp_path, dtype):
    """save_sd3_checkpoint then load_sd3_params: every tensor of the file
    back, a learned grid exactly when the file has one (without one the
    MMDiT keeps the fixed sin-cos table and no pos_embed is written); every
    parameter back but the pre-only block's unreachable ones, which the
    file cannot hold and the loader zeroes."""
    tcfg = tsd3.TINY_SD3_T5
    for learned in (True, False):
        model = tsd3.StableDiffusion3(tcfg, device="cpu", dtype=dtype, seed=30,
                                      learned_pos_embed=learned)
        path = tmp_path / f"sd3_{learned}.safetensors"
        tck.save_sd3_checkpoint(model, path)
        back = tck.load_sd3_params(path, tcfg, device="cpu", dtype=dtype)
        assert (back.mmdit.pos_embed is not None) == learned
        file_state = tsm.sd3_state_from_params(back)
        assert file_state.keys() == tsm.sd3_state_from_params(model).keys()
        for k, v in tsm.sd3_state_from_params(model).items():
            assert torch.equal(file_state[k], v), k
        last = f"mmdit.blocks.{tcfg.mmdit.depth - 1}.txt."
        unreachable = {n for n in dict(model.named_parameters())
                       if n.startswith(last + "proj.") or n.startswith(last + "mlp.")}
        assert len(unreachable) == 6
        mine, theirs = dict(model.named_parameters()), dict(back.named_parameters())
        for n, v in theirs.items():
            if n in unreachable:
                assert not v.any(), n
            elif n == last + "mod.weight" or n == last + "mod.bias":
                d = tcfg.mmdit.dim
                assert torch.equal(v[:2 * d], mine[n][:2 * d]) and not v[2 * d:].any(), n
            else:
                assert torch.equal(v, mine[n]), n
    no_t5 = tmp_path / "no_t5.safetensors"
    tck.save_sd3_checkpoint(tsd3.StableDiffusion3(tsd3.TINY_SD3, device="cpu", seed=31), no_t5)
    back = tck.load_sd3_params(no_t5, tcfg, device="cpu")
    assert back.cfg.t5 is None and not hasattr(back, "t5")  # no T5 tower built


def test_sd3_map_of_published_key_names():
    """A few keys as SD3-medium's single file names them."""
    model = tsd3.StableDiffusion3(tsd3.TINY_SD3, device="cpu", seed=32, learned_pos_embed=True)
    keys = tsm.sd3_state_from_params(model).keys()
    for key in (f"{PFX}.x_embedder.proj.weight", f"{PFX}.pos_embed",
                f"{PFX}.t_embedder.mlp.2.bias", f"{PFX}.y_embedder.mlp.0.weight",
                f"{PFX}.context_embedder.weight", f"{PFX}.joint_blocks.0.x_block.attn.qkv.weight",
                f"{PFX}.joint_blocks.1.context_block.adaLN_modulation.1.weight",
                f"{PFX}.final_layer.linear.weight",
                "text_encoders.clip_l.transformer.text_model.encoder.layers.1.mlp.fc2.bias",
                "text_encoders.clip_l.transformer.text_projection.weight",
                "first_stage_model.decoder.conv_out.weight"):
        assert key in keys, key
