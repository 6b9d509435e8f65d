"""tools/ckpt_drill_torch.py (the port's counterpart of
benchmarks/ckpt_drill.py) on the CPU at SD15_QUARTER: its state equals the
JAX tool's ``build_state`` bit for bit (the port's fill and state map
against the JAX package's); both containers, read back through the port's
loader, hold exactly the parameters that ``io/from_jax`` loads from the
same JAX params (fp16 values, then fp32 and bf16); the tool's own check
passes, and one run of the port's CLI on the torch-zip file at ``--cpu
--steps 2`` reports its load seconds and the child's peak RSS.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu_torch.io import checkpoints
from tinyfusers_tpu_torch.io.from_jax import load_sd
from tinyfusers_tpu_torch.pipeline import sd as tsd

from torch_parity import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


drill = load_file(ROOT / "tools" / "ckpt_drill_torch.py", "ckpt_drill_torch")


def jax_drill():
    """benchmarks/ckpt_drill.py (its import sets no jax config)."""
    return load_file(ROOT / "benchmarks" / "ckpt_drill.py", "jax_ckpt_drill")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(the port tool's fp16 model, its state, the two files)."""
    model, state = drill.build_state(tsd.SD15_QUARTER)
    paths = drill.write_ckpts(state, tmp_path_factory.mktemp("drill"))
    return model, state, paths


def test_state_is_the_jax_tools(written):
    want = jax_drill().build_state(jsd.SD15_QUARTER)
    _, state, _ = written
    assert state.keys() == want.keys()
    for k, v in want.items():
        assert state[k].dtype == torch.float16, k
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)


@pytest.fixture(scope="module")
def from_jax():
    """{name: fp32 parameter} of the quarter model that io/from_jax loads
    from the JAX drill's fill of the JAX tree (fp16 values)."""
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda: jsd.init(jax.random.key(0), jsd.SD15_QUARTER,
                                             dtype=jnp.float16))
    pool = (np.random.default_rng(0).standard_normal(1 << 20) * 0.02).astype(np.float16)

    def fill(leaf):
        n = int(np.prod(leaf.shape)) if leaf.shape else 1
        return np.tile(pool, -(-n // pool.size))[:n].reshape(leaf.shape)

    params = jax.tree.map(lambda x: fill(x).astype(np.float32), shapes)
    model = tsd.StableDiffusion(tsd.SD15_QUARTER, device="cpu", dtype=torch.float32, seed=None)
    load_sd(model, params)
    return dict(model.named_parameters())


@pytest.mark.parametrize("suffix", [".safetensors", ".ckpt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_containers_load_the_jax_params(written, from_jax, suffix, dtype):
    """Each file through load_sd_params equals from_jax of the same JAX
    params, bit for bit, in fp32 and in bf16."""
    _, _, paths = written
    path = next(p for p in paths if p.suffix == suffix)
    got = dict(checkpoints.load_sd_params(path, tsd.SD15_QUARTER, device="cpu",
                                          dtype=dtype).named_parameters())
    assert got.keys() == from_jax.keys()
    for k, v in got.items():
        assert torch.equal(v, from_jax[k].to(dtype)), k


def test_the_tools_check_passes(written):
    model, _, paths = written
    for path in paths:
        res = drill.check_loaded(path, model, tsd.SD15_QUARTER, "cpu")
        assert res["equal"] and not res["differ"] and res["tensors"] == len(
            list(model.parameters()))


def test_cli_run_on_the_torch_zip_file(written, tmp_path, capsys):
    _, _, paths = written
    ckpt = next(p for p in paths if p.suffix == ".ckpt")
    res = drill.drive_cli(ckpt, 2, "sd15-quarter", True, tmp_path)
    assert res["ok"], capsys.readouterr().out
    assert res["load_s"] is not None and res["load_s"] >= 0
    assert res["peak_rss_gb"] is not None and res["peak_rss_gb"] > 0
    assert list(tmp_path.glob("drill_ckpt*"))
