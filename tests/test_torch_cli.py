"""The port's CLI (examples/txt2img_torch.py) on the CPU at the tiny
preset, from a checkpoint the JAX package wrote, and the embedding lookup's
out-of-vocabulary rule it meets there.

The byte-level tokenizer's ids (SOT 49406, EOT 49407, bytes up to 511)
lie outside the tiny preset's 128-word vocabulary. ``jnp.take`` fills
such rows with NaN, so both packages give NaN conditioning and a black
image there: this file checks shapes, files, the refusals and the device
rule, and holds the lookup to jnp.take exactly (NaN where it gives NaN,
the same rows elsewhere).
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.io import checkpoints as jck
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu.tokenizer import bpe as jbpe
from tinyfusers_tpu.tokenizer import prompt_weights as jpw
from tinyfusers_tpu_torch.ops.embedding import embedding
from tinyfusers_tpu_torch.pipeline import sd as tsd

from torch_parity import few_torch_threads, random_tree  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _cli():
    spec = importlib.util.spec_from_file_location("txt2img_torch",
                                                  ROOT / "examples" / "txt2img_torch.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cli():
    return _cli()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    params = random_tree(lambda k: jsd.init(k, jsd.TINY), 0)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.safetensors"
    jck.save_sd_checkpoint(jax.tree.map(lambda x: np.asarray(x, np.float32), params), path,
                           jsd.TINY)
    return path


def _argv(ckpt, out, *more):
    return ["--preset", "tiny", "--cpu", "--dtype", "float32", "--ckpt", str(ckpt),
            "--fallback-tokenizer", "--sampler", "dpmpp_2m", "--schedule", "karras",
            "--steps", "3", "--out", str(out), *more]


def test_cli_writes_an_image_from_a_checkpoint(cli, ckpt, tmp_path):
    out = tmp_path / "t.png"
    img = cli.main(_argv(ckpt, out))
    assert img.dtype == np.uint8 and img.shape == (32, 32, 3)
    from PIL import Image

    assert np.array_equal(np.asarray(Image.open(out)), img)


def test_cli_writes_npy_without_pil(cli, ckpt, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    out = tmp_path / "t.png"
    img = cli.main(_argv(ckpt, out, "--sampler", "euler_ancestral", "--batch", "2"))
    assert np.array_equal(np.load(str(out) + ".npy"), img)


def test_cli_tokenizes_as_the_jax_cli(cli, ckpt, tmp_path):
    """Weighted prompt ids and weights, the negative prompt padded with EOT
    (SD1.x), the batch, and the ancestral samplers' seed + 1."""
    prompt = "a (red:1.3) cat, [blurry]"
    args = cli.parse_args(_argv(ckpt, tmp_path / "t.png", "--prompt", prompt,
                                "--negative-prompt", "ugly", "--batch", "2",
                                "--sampler", "euler_ancestral", "--seed", "9"))
    job = cli.build(args)
    tok = jbpe.ClipTokenizer(None)
    wid, w = jpw.encode_weighted(tok, prompt, 16, pad_token=jbpe.EOT)
    assert job.ids.tolist() == [wid, wid]
    np.testing.assert_array_equal(job.weights.numpy(), np.asarray([w, w], np.float32))
    assert job.uids.tolist() == [tok.encode("ugly", 16)] * 2
    assert torch.equal(job.latent, tsd.initial_latent(9, 2, tsd.TINY, device="cpu"))
    gen = job._generator()
    assert torch.equal(torch.randn(3, generator=gen),
                       torch.randn(3, generator=torch.Generator().manual_seed(10)))
    no_cfg = cli.build(cli.parse_args(_argv(ckpt, tmp_path / "t.png", "--no-cfg")))
    assert no_cfg.uids is None and no_cfg.weights is None


def test_cli_refuses_the_byte_level_tokenizer_with_a_checkpoint(cli, ckpt, tmp_path,
                                                                monkeypatch):
    monkeypatch.delenv("TINYFUSERS_BPE_PATH", raising=False)
    argv = [a for a in _argv(ckpt, tmp_path / "t.png") if a != "--fallback-tokenizer"]
    with pytest.raises(FileNotFoundError, match="refusing the byte-level"):
        cli.main(argv)


def test_cli_runs_on_the_gpu_or_raises(cli, ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    argv = [a for a in _argv(ckpt, tmp_path / "t.png") if a != "--cpu"]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(argv)
    assert not (tmp_path / "t.png").exists()


def test_embedding_fills_ids_outside_the_vocabulary_as_jnp_take():
    w = np.random.default_rng(0).standard_normal((10, 3)).astype(np.float32)
    ids = np.array([[0, 9, -1, -10, 10, -11, 49406, 5]], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(w), jnp.asarray(ids), axis=0))
    got = embedding(torch.from_numpy(ids), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)  # NaN where jnp.take gives NaN
    assert np.isnan(got[0, 4:7]).all() and not np.isnan(got[0, [0, 1, 2, 3, 7]]).any()
