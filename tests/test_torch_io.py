"""The port's checkpoint I/O against the JAX package's on the CPU:
safetensors both ways (every dtype), torch-zip checkpoints, the SD1.x (HF
CLIP) and SD2.x (OpenCLIP) state maps, load_sd_params / save_sd_checkpoint
both ways, and the VAE encoder the round trip needs.

Tolerances: the file formats and the state maps move bytes, so every
comparison is exact (bit for bit), dtype included. The VAE encoder is the
models' fp32 1e-4 (rtol / atol), as tests/test_torch_models.py holds the
decoder.
"""
import dataclasses
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from tinyfusers_tpu.io import checkpoints as jck
from tinyfusers_tpu.io import safetensors_io as jst
from tinyfusers_tpu.io import state_map as jsm
from tinyfusers_tpu.io import torch_pickle as jpk
from tinyfusers_tpu.models import clip as jclip
from tinyfusers_tpu.models import vae as jvae
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu_torch.io import checkpoints as tck
from tinyfusers_tpu_torch.io import safetensors_io as tst
from tinyfusers_tpu_torch.io import state_map as tsm
from tinyfusers_tpu_torch.io import torch_pickle as tpk
from tinyfusers_tpu_torch.io.from_jax import load_sd
from tinyfusers_tpu_torch.models import clip as tclip
from tinyfusers_tpu_torch.models import vae as tvae
from tinyfusers_tpu_torch.pipeline import sd as tsd

from torch_parity import few_torch_threads, random_tree  # noqa: F401

# A TINY SD2.x: OpenCLIP's GELU tower, penultimate layer with the final
# norm, 16-wide UNet heads, v-prediction.
_V = dict(prediction_type="v", clip_skip_layers=1, clip_final_norm_on_skip=True)
J_TINY_SD2 = dataclasses.replace(
    jsd.TINY, clip=dataclasses.replace(jsd.TINY.clip, act="gelu"),
    unet=dataclasses.replace(jsd.TINY.unet, num_heads=-1, head_dim=16), **_V)
T_TINY_SD2 = dataclasses.replace(
    tsd.TINY, clip=dataclasses.replace(tsd.TINY.clip, act="gelu"),
    unet=dataclasses.replace(tsd.TINY.unet, num_heads=-1, head_dim=16), **_V)


def _tree(init_fn, seed):
    """random_tree with every leaf fp32 (its weights come out fp64)."""
    return jax.tree.map(lambda x: np.asarray(x, np.float32), random_tree(init_fn, seed))


def _bits(x) -> np.ndarray:
    """The raw bytes of a torch tensor or numpy array, for exact compares."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        return x.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _jax_dtype_name(t: torch.Tensor) -> str:
    return {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
            torch.float8_e5m2: "float8_e5m2"}.get(t.dtype, str(t.dtype)[6:])


def _assert_same_module(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and sa[k].shape == sb[k].shape, k
        assert torch.equal(sa[k], sb[k]), k


def _numpy_values():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "f32": f, "f16": f.astype(np.float16), "bf16": f.astype(ml_dtypes.bfloat16),
        "f8_e4m3": f.astype(ml_dtypes.float8_e4m3fn), "f8_e5m2": f.astype(ml_dtypes.float8_e5m2),
        "f64": f[:1].astype(np.float64), "i64": np.arange(7, dtype=np.int64),
        "i32": np.arange(-3, 3, dtype=np.int32), "i16": np.arange(5, dtype=np.int16),
        "i8": np.arange(-4, 4, dtype=np.int8), "u8": np.arange(9, dtype=np.uint8),
        "bool": np.array([True, False, True]), "scalar": np.array(2.5, np.float32),
        "odd": np.arange(3, dtype=np.float16),  # leaves the next tensor unaligned
        "after_odd": f[0],
    }


# -- safetensors -----------------------------------------------------------

def test_safetensors_port_reads_the_jax_writer_bit_for_bit(tmp_path):
    state = _numpy_values()
    path = tmp_path / "jax.safetensors"
    jst.save_state_dict(state, path)
    got = tst.load_state_dict(path)
    assert got.keys() == state.keys()
    for k, want in state.items():
        assert _jax_dtype_name(got[k]) == want.dtype.name, k
        assert tuple(got[k].shape) == want.shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want), err_msg=k)


@pytest.mark.parametrize("source", ["torch", "numpy"])
def test_safetensors_jax_reads_the_port_writer_bit_for_bit(tmp_path, source):
    state = _numpy_values()
    if source == "torch":  # torch tensors, as the port's models hold them
        state = {k: tst._as_tensor(v) for k, v in state.items()}
    path = tmp_path / "port.safetensors"
    tst.save_state_dict(state, path)
    assert int.from_bytes(path.read_bytes()[:8], "little") % 8 == 0  # aligned payload
    got = jst.load_state_dict(path)
    for k, want in state.items():
        if isinstance(want, torch.Tensor):
            assert got[k].dtype.name == _jax_dtype_name(want), k
        else:
            assert got[k].dtype == want.dtype, k
        assert got[k].shape == tuple(want.shape), k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want), err_msg=k)


def test_safetensors_library_reads_the_port_writer(tmp_path):
    from safetensors.numpy import load_file

    state = {"w": np.random.default_rng(1).standard_normal((2, 3)).astype(np.float32)}
    path = tmp_path / "port.safetensors"
    tst.save_state_dict(state, path)
    np.testing.assert_array_equal(load_file(str(path))["w"], state["w"])


# -- torch-zip checkpoints --------------------------------------------------

def test_torch_zip_keeps_dtypes_strides_and_unwraps_state_dict(tmp_path):
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    inner = {"t": base.t(), "h": torch.randn(5).half(), "b": torch.randn(4, 4).bfloat16(),
             "i": torch.arange(6), "note": "not a tensor"}
    path = tmp_path / "wrapped.ckpt"
    torch.save({"state_dict": inner, "epoch": 3, "global_step": 10}, path)
    got = tpk.load_state_dict(path)
    want = jpk.load_state_dict(path)
    assert got.keys() == want.keys() == {"t", "h", "b", "i"}
    for k in got:
        assert _jax_dtype_name(got[k]) == want[k].dtype.name, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


def test_torch_zip_refuses_a_foreign_global(tmp_path):
    class Evil:
        def __reduce__(self):
            return (print, ("pwned",))

    path = tmp_path / "evil.pt"
    torch.save({"e": Evil(), "w": torch.ones(2)}, path)
    with pytest.raises(pickle.UnpicklingError):
        tpk.load(path)


class ModelCheckpoint:
    """A training-callback object, as SD .ckpt files carry them."""

    def __init__(self):
        self.best = 0.5


def test_torch_zip_tolerates_lightning_objects_as_the_jax_reader_does(tmp_path, monkeypatch):
    mod = types.ModuleType("fake_lightning_callbacks")
    monkeypatch.setattr(ModelCheckpoint, "__module__", mod.__name__)
    mod.ModelCheckpoint = ModelCheckpoint
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    path = tmp_path / "lightning.ckpt"
    torch.save({"state_dict": {"w": torch.ones(3)}, "callbacks": {"cb": ModelCheckpoint()}},
               path)
    assert set(tpk.load_state_dict(path)) == {"w"}


# -- the SD state maps ------------------------------------------------------

def _jax_sd2_state(params, cfg):
    """An SD2.x checkpoint as published: CLIP in the OpenCLIP layout."""
    state = jsm.unet_to_state(params["unet"], cfg.unet)
    state.update(jsm.vae_to_state(params["vae"], cfg.vae))
    state.update(jsm.openclip_to_state(params["clip"], cfg.clip, "cond_stage_model.model"))
    return state


@pytest.fixture(scope="module", params=["sd1", "sd2"])
def layout(request):
    """(name, JAX config, port config, JAX tree, the port's model of it)."""
    jcfg, tcfg = (jsd.TINY, tsd.TINY) if request.param == "sd1" else (J_TINY_SD2, T_TINY_SD2)
    params = _tree(lambda k: jsd.init(k, jcfg), 3)
    model = tsd.StableDiffusion(tcfg, device="cpu", seed=None)
    load_sd(model, params)
    return request.param, jcfg, tcfg, params, model


@pytest.mark.parametrize("fmt", ["safetensors", "ckpt"])
def test_load_sd_params_equals_the_bridge_bit_for_bit(layout, tmp_path, fmt):
    """A checkpoint the JAX package wrote gives the module the JAX-tree
    bridge (io/from_jax.py) gives, bit for bit."""
    name, jcfg, tcfg, params, want = layout
    if name == "sd1":
        state = jsm.sd_state_from_params(params, jcfg)
    else:
        state = _jax_sd2_state(params, jcfg)
    path = tmp_path / f"tiny.{fmt}"
    if fmt == "safetensors":
        jck.save_sd_checkpoint(params, path, jcfg) if name == "sd1" else \
            jst.save_state_dict(state, path)
    else:
        torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
                    "epoch": 1}, path)
    got = tck.load_sd_params(path, tcfg, device="cpu", dtype=torch.float32)
    _assert_same_module(got, want)


def test_save_sd_checkpoint_writes_the_jax_state(layout, tmp_path):
    """The port's checkpoint holds JAX sd_state_from_params's keys and
    arrays, and the JAX package loads it back into the same tree."""
    name, jcfg, tcfg, params, model = layout
    path = tmp_path / "port.safetensors"
    tck.save_sd_checkpoint(model, path, tcfg)
    got = jst.load_state_dict(path)
    want = jsm.sd_state_from_params(params, jcfg)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    back = jck.load_sd_params(path, jcfg, dtype=jnp.float32)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_openclip_layout_round_trips_through_the_jax_loader(tmp_path):
    """The port's OpenCLIP writer against the JAX package's OpenCLIP map,
    both ways, with a text projection (x @ W) as bigG has."""
    jcfg = dataclasses.replace(jsd.TINY.clip, act="gelu", projection_dim=24)
    tcfg = dataclasses.replace(tsd.TINY.clip, act="gelu", projection_dim=24)
    params = _tree(lambda k: jclip.init(k, jcfg), 4)
    state = {k: np.asarray(v) for k, v in
             jsm.openclip_to_state(params, jcfg, "cond_stage_model.model").items()}
    model = tclip.CLIPTextModel(tcfg, device="cpu")
    tsm.openclip_from_state(state, model)
    want = tclip.CLIPTextModel(tcfg, device="cpu")
    from tinyfusers_tpu_torch.io.from_jax import load_params
    load_params(want, params)
    _assert_same_module(model, want)
    back = tsm.openclip_to_state(model)
    assert back.keys() == state.keys()
    for k in state:
        np.testing.assert_array_equal(back[k].numpy(), state[k], err_msg=k)


def test_bf16_save_and_fp16_checkpoint_load_round_like_jax(tmp_path):
    """fp16 on disk, bf16 in the model: the port rounds each value as
    jnp.asarray(x, bfloat16) does."""
    jcfg, tcfg = jsd.TINY, tsd.TINY
    params = _tree(lambda k: jsd.init(k, jcfg), 5)
    state = {k: np.asarray(v).astype(np.float16) for k, v in
             jsm.sd_state_from_params(params, jcfg).items()}
    path = tmp_path / "fp16.safetensors"
    jst.save_state_dict(state, path)
    got = tck.load_sd_params(path, tcfg, device="cpu", dtype=torch.bfloat16)
    jtree = jck.load_sd_params(path, jcfg, dtype=jnp.bfloat16)
    want = tsd.StableDiffusion(tcfg, device="cpu", dtype=torch.bfloat16, seed=None)
    load_sd(want, jax.tree.map(lambda x: np.asarray(x), jtree))
    _assert_same_module(got, want)
    out = tmp_path / "port16.safetensors"
    tck.save_sd_checkpoint(got, out, dtype=torch.float16)
    back = tst.load_state_dict(out)
    want16 = tsm.sd_state_from_params(got)
    assert back.keys() == want16.keys()
    for k, v in back.items():
        assert v.dtype == torch.float16, k
        assert torch.equal(v, want16[k].to(torch.float16)), k


def test_missing_key_extra_parameter_and_bad_shape_raise(tmp_path):
    params = _tree(lambda k: jsd.init(k, jsd.TINY), 6)
    state = {k: torch.from_numpy(np.asarray(v))
             for k, v in jsm.sd_state_from_params(params, jsd.TINY).items()}
    model = tsd.StableDiffusion(tsd.TINY, device="cpu", seed=None)
    key = "model.diffusion_model.out.2.bias"
    with pytest.raises(KeyError, match=key):
        tsm.sd_from_state({k: v for k, v in state.items() if k != key}, model)
    extra = tsd.StableDiffusion(tsd.TINY, device="cpu", seed=None)
    extra.unet.out_conv.register_parameter("gain", torch.nn.Parameter(torch.ones(4)))
    with pytest.raises(ValueError, match="not in the checkpoint map.*out_conv.gain"):
        tsm.sd_from_state(state, extra)
    key = "first_stage_model.decoder.conv_in.weight"
    with pytest.raises(ValueError, match=key):
        tsm.sd_from_state(dict(state, **{key: state[key][:, :2]}), model)


def test_linear_proj_in_of_published_sd2_checkpoints_raises_naming_the_key():
    """SD2.x / SDXL checkpoints store proj_in / proj_out as 2-D linear
    weights (use_linear_in_transformer); the JAX loader's OIHW transpose
    cannot read them, and the port raises too, naming the key."""
    params = _tree(lambda k: jsd.init(k, jsd.TINY), 7)
    state = {k: np.asarray(v) for k, v in jsm.sd_state_from_params(params, jsd.TINY).items()}
    key = "model.diffusion_model.input_blocks.1.1.proj_in.weight"
    state[key] = state[key][:, :, 0, 0]
    with pytest.raises(ValueError):
        jsm.unet_from_state(state, jsd.TINY.unet)
    model = tsd.StableDiffusion(tsd.TINY, device="cpu", seed=None)
    with pytest.raises(ValueError, match=key):
        tsm.sd_from_state(state, model)


# -- the VAE encoder (its weights travel with every SD checkpoint) ----------

def test_vae_encode_matches_jax():
    jcfg, tcfg = jvae.TINY_VAE_CONFIG, tvae.TINY_VAE_CONFIG
    params = _tree(lambda k: jvae.init(k, jcfg), 8)
    model = tvae.AutoencoderKL(tcfg, device="cpu")
    from tinyfusers_tpu_torch.io.from_jax import load_params
    load_params(model, params)
    x = np.random.default_rng(9).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jvae.encode(p, x, jcfg))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tvae.encode(model, torch.from_numpy(x))
    assert got.shape == want.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
