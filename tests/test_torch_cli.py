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

from torch_parity import few_torch_threads, random_tree, replay_noise  # noqa: F401

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


# --- the flags of the UNet extras, ControlNet, textual inversion, hires ------

def _jax_cli():
    spec = importlib.util.spec_from_file_location("txt2img_jax", ROOT / "examples" / "txt2img.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_vocab(ids, rows):
    """Ids a table of ``rows`` holds (the byte-level SOT / EOT ids lie
    outside the tiny vocabulary and give NaN conditioning in both packages;
    textual-inversion ids past it are kept)."""
    ids = np.asarray(ids)
    return np.where(ids < rows, ids, ids % 97)


@pytest.fixture(scope="module")
def ti_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ti") / "cat.pt"
    vec = np.random.default_rng(8).standard_normal((2, jsd.TINY.clip.dim)).astype(np.float32)
    torch.save({"string_to_param": {"*": torch.from_numpy(vec)}, "name": "cat"}, path)
    return path


@pytest.mark.parametrize("extra,hires", [
    (["--freeu", "1.5,1.6,0.9,0.2", "--deepcache-interval", "2", "--deepcache-split", "2",
      "--ti", "<cat>=TI"], False),
    (["--hires-scale", "2", "--hires-strength", "0.5", "--freeu", "1.3,1.4,0.9,0.2",
      "--sampler", "ddim", "--schedule", "ladder"], True)])
def test_cli_options_run_as_the_jax_cli(cli, ckpt, ti_file, tmp_path, monkeypatch, extra,
                                        hires):
    """examples/txt2img.py and the port's CLI with the same arguments: the
    JAX CLI's call of sd.generate (or generate_hires) is recorded, and the
    port's job must hold the same ids, the same textual-inversion table
    and the same options, and give the same image (within 1) from the same
    latent with in-vocabulary ids (and, for hires, the JAX re-noising)."""
    extra = [a.replace("=TI", f"={ti_file}") for a in extra]
    argv = _argv(ckpt, tmp_path / "j.png", "--prompt", "a <cat> on a mat", *extra)
    name = "generate_hires" if hires else "generate"
    calls = []
    real = getattr(jsd, name)

    def record(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(jsd, name, record)
    monkeypatch.setattr(sys, "argv", ["txt2img.py", *argv])
    _jax_cli().main()
    (a, kw), = calls
    params, ids, uids, lat = a[:4]
    job = cli.build(cli.parse_args(argv))
    assert job.ids.tolist() == np.asarray(ids).tolist()
    assert job.uids.tolist() == np.asarray(uids).tolist()
    np.testing.assert_array_equal(job.model.clip.token_embedding.weight.numpy(),
                                  np.asarray(params["clip"]["token_embedding"]["weight"]))
    assert job.args.freeu == kw["freeu"]
    rows = job.model.clip.token_embedding.weight.shape[0]
    ids2, uids2 = _in_vocab(ids, rows), _in_vocab(uids, rows)
    job.ids, job.uids = torch.from_numpy(ids2).long(), torch.from_numpy(uids2).long()
    job.latent = torch.from_numpy(np.array(lat))
    if hires:
        assert (kw["hires_scale"], kw["hires_strength"]) == (job.args.hires_scale,
                                                             job.args.hires_strength)
        key = a[4]
        hi = (1, 2 * lat.shape[1], 2 * lat.shape[2], lat.shape[3])
        replay_noise(monkeypatch, [np.asarray(jax.random.normal(jax.random.split(key, 3)[1],
                                                                hi, jnp.float32))])
        want = real(params, jnp.asarray(ids2), jnp.asarray(uids2), lat, key, a[5], **kw)
    else:
        assert (kw["deepcache_interval"], kw["deepcache_split"]) == (
            job.args.deepcache_interval, job.args.deepcache_split)
        want = real(params, jnp.asarray(ids2), jnp.asarray(uids2), lat, a[4], **kw)
    got = job.image().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == ((1, 64, 64, 3) if hires else (1, 32, 32, 3))
    assert got.std() > 0  # finite conditioning, not a black NaN image
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("extra,message", [
    (["--freeu", "1.5,1.6"], "--freeu needs exactly 4"),
    (["--hires-scale", "2", "--deepcache-interval", "2"], "not wired into the hires path"),
    (["--hires-scale", "2", "--control-ckpt", "cn.safetensors"], "not wired into the hires"),
    (["--hires-scale", "2", "--prompt", "a (red:1.3) cat"], "not wired into the hires path"),
])
def test_cli_refuses_what_the_jax_cli_refuses(cli, ckpt, tmp_path, capsys, extra, message):
    argv = _argv(ckpt, tmp_path / "t.png", *extra)
    with pytest.raises(SystemExit) as e:
        cli.build(cli.parse_args(argv))
    assert e.value.code == 2 and message in capsys.readouterr().err


def test_cli_control_flags_load_the_controlnet(cli, ckpt, tmp_path, capsys):
    """--control-ckpt reads a control_model.* file onto the job's device
    and dtype; without --control-image the hint is zeros at 8x the latent
    grid (the JAX CLI's smoke-run rule); --control-image is resized with
    LANCZOS to that size."""
    from PIL import Image

    from tinyfusers_tpu_torch.io import checkpoints as tck
    from tinyfusers_tpu_torch.models import controlnet as tcn

    path = tmp_path / "cn.safetensors"
    tck.save_controlnet_checkpoint(tcn.ControlNet(tsd.TINY.unet, device="cpu", seed=3), path)
    argv = _argv(ckpt, tmp_path / "t.png", "--control-ckpt", str(path), "--control-scale",
                 "0.7")
    job = cli.build(cli.parse_args(argv))
    cn, hint, scale = job.control
    assert isinstance(cn, tcn.ControlNet) and scale == 0.7
    assert tuple(hint.shape) == (1, 128, 128, 3) and not hint.any()
    assert "zero hint" in capsys.readouterr().out
    img = np.random.default_rng(1).integers(0, 256, (40, 50, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "hint.png")
    job = cli.build(cli.parse_args(argv + ["--control-image", str(tmp_path / "hint.png")]))
    want = np.asarray(Image.fromarray(img).resize((128, 128), Image.LANCZOS), np.float32) / 255
    np.testing.assert_array_equal(job.control[1][0].numpy(), want)
    assert job.image().shape == (1, 32, 32, 3)


# --- the SDXL presets ----------------------------------------------------------

@pytest.fixture(scope="module")
def xl_ckpt(tmp_path_factory):
    """A TINY_XL checkpoint in the JAX map's SDXL layout."""
    from tinyfusers_tpu.io import safetensors_io as jst
    from tinyfusers_tpu.io import state_map as jsm
    from tinyfusers_tpu.pipeline import sdxl as jsdxl

    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          random_tree(lambda k: jsdxl.init(k, jsdxl.TINY_XL), 2))
    path = tmp_path_factory.mktemp("xl") / "tinyxl.safetensors"
    jst.save_state_dict(jsm.sdxl_state_from_params(params, jsdxl.TINY_XL), path)
    return path


def _xl_argv(out, *more):
    return ["--preset", "tinyxl", "--cpu", "--dtype", "float32", "--steps", "2",
            "--out", str(out), *more]


def test_cli_tinyxl_writes_an_image(cli, tmp_path):
    out = tmp_path / "xl.png"
    img = cli.main(_xl_argv(out, "--sampler", "euler_ancestral", "--quant", "int8"))
    assert img.dtype == np.uint8 and img.shape == (64, 64, 3)
    from PIL import Image

    assert np.array_equal(np.asarray(Image.open(out)), img)


def test_cli_tinyxl_builds_the_jax_clis_job(cli, xl_ckpt, tmp_path, monkeypatch):
    """examples/txt2img.py and the port's CLI with the same SDXL arguments
    (the hires and DeepCache flags accepted and unused by both): the JAX
    CLI's call of sdxl.generate is recorded, and the port's job holds the
    checkpoint's weights, the same ids (both towers padded with EOT), the
    same options and the ancestral samplers' seed + 1."""
    from tinyfusers_tpu.pipeline import sdxl as jsdxl
    from tinyfusers_tpu_torch.io import state_map as tsm
    from tinyfusers_tpu_torch.pipeline import sdxl as tsdxl

    argv = _xl_argv(tmp_path / "j.png", "--ckpt", str(xl_ckpt), "--fallback-tokenizer",
                    "--prompt", "a red cat", "--negative-prompt", "ugly", "--batch", "2",
                    "--sampler", "euler_ancestral", "--seed", "9", "--uncond-interval", "2",
                    "--cfg-rescale", "0.7", "--freeu", "1.3,1.4,0.9,0.2", "--hires-scale",
                    "2", "--deepcache-interval", "2")
    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        return jnp.zeros((2, 64, 64, 3), jnp.uint8)

    monkeypatch.setattr(jsdxl, "generate", record)
    monkeypatch.setattr(sys, "argv", ["txt2img.py", *argv])
    _jax_cli().main()
    (a, kw), = calls
    job = cli.build(cli.parse_args(argv))
    assert isinstance(job, cli.XLJob) and isinstance(job.model, tsdxl.StableDiffusionXL)
    state = tsm.sdxl_state_from_params(job.model)
    from tinyfusers_tpu_torch.io import safetensors_io as tst

    for k, v in tst.load_state_dict(xl_ckpt).items():
        assert torch.equal(state[k], v), k
    for got, want in zip((job.ids_l, job.ids_g, job.uids_l, job.uids_g), a[1:5]):
        assert got.tolist() == np.asarray(want).tolist()
    assert job.ids_l[0, -1] == jbpe.EOT and job.uids_g[0, -1] == jbpe.EOT
    assert job.args.freeu == kw["freeu"] and (kw["uncond_interval"], kw["cfg_rescale"]) == (
        job.args.uncond_interval, job.args.cfg_rescale)
    assert (kw["method"], kw["schedule"], kw["num_steps"]) == ("euler_ancestral", "ladder", 2)
    assert torch.equal(job.latent, tsdxl.initial_latent(9, 2, tsdxl.TINY_XL, device="cpu"))
    assert torch.equal(torch.randn(3, generator=job._generator()),
                       torch.randn(3, generator=torch.Generator().manual_seed(10)))


@pytest.mark.parametrize("extra", [["--ti", "<cat>=x.pt"], ["--control-ckpt", "cn.safetensors"],
                                   ["--no-cfg"]])
def test_cli_tinyxl_refuses_what_the_jax_cli_refuses(cli, tmp_path, monkeypatch, extra):
    argv = _xl_argv(tmp_path / "t.png", *extra)
    monkeypatch.setattr(sys, "argv", ["txt2img.py", *argv])
    with pytest.raises(SystemExit) as jax_exit:
        _jax_cli().main()
    with pytest.raises(SystemExit) as port_exit:
        cli.build(cli.parse_args(argv))
    assert port_exit.value.code == jax_exit.value.code == cli.XL_REFUSED


def test_cli_tinyxl_quantizes_the_unet(cli, tmp_path):
    from tinyfusers_tpu_torch.models.layers import Linear
    from tinyfusers_tpu_torch.ops.quant import is_quantized

    job = cli.build(cli.parse_args(_xl_argv(tmp_path / "t.png", "--quant", "int8")))
    leaves = [m for m in job.model.unet.modules() if isinstance(m, Linear)]
    assert leaves and any(is_quantized(m.w) for m in leaves)
    assert not any(is_quantized(m.w) for m in job.model.clip_g.modules()
                   if isinstance(m, Linear))
    assert job.image().shape == (1, 64, 64, 3)


# -- the training CLIs (examples/train_full_torch.py, train_lora_torch.py) ------

def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def _losses(out: str):
    import re

    return [float(m) for m in re.findall(r"loss ([0-9.]+)", out)]


def test_train_full_cli_loss_falls_and_saves_the_unet(tmp_path, capsys):
    """At the tiny preset on the CPU with the defaults (bf16, AdamW, remat):
    the loss falls (tests/test_train.py's criterion for the JAX CLI, over
    30 steps at a higher learning rate), the memory line prints, and the
    saved fp16 file holds the keys the JAX CLI's state_map.unet_to_state
    writes."""
    from tinyfusers_tpu.io import state_map as jstate_map
    from tinyfusers_tpu.models import unet as junet
    from tinyfusers_tpu_torch.io import safetensors_io

    cli = _example("train_full_torch")
    out = tmp_path / "unet_ft.safetensors"
    state = cli.main(["--preset", "tiny", "--cpu", "--steps", "30", "--lr", "1e-3",
                      "--log-every", "5", "--out", str(out)])
    text = capsys.readouterr().out
    losses = _losses(text)
    assert len(losses) == 6 and state.step == 30
    assert np.mean(losses[-2:]) < losses[0] * 0.92, losses
    assert "device memory: not measured on the CPU" in text and "optimizer state" in text
    saved = safetensors_io.load_state_dict(out)
    shapes = jax.eval_shape(lambda k: junet.init(k, jsd.TINY.unet), jax.random.key(0))
    want = jstate_map.unet_to_state(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), jsd.TINY.unet)
    assert set(saved) == set(want)
    assert all(v.dtype == torch.float16 and tuple(v.shape) == want[k].shape
               for k, v in saved.items())


def test_train_lora_cli_loss_falls_and_writes_the_jax_clis_files(tmp_path, capsys):
    """The adapter file has the JAX CLI's dotted keys and shapes (its
    init_lora tree over the tiny UNet, flattened); the train state resumes
    in the port's CLI and loads in the JAX package."""
    from tinyfusers_tpu import train as jtrain
    from tinyfusers_tpu.models import unet as junet
    from tinyfusers_tpu.train.checkpoint import _flatten
    from tinyfusers_tpu_torch.io import safetensors_io

    cli = _example("train_lora_torch")
    out, st = tmp_path / "lora.safetensors", tmp_path / "state.safetensors"
    first = cli.main(["--preset", "tiny", "--cpu", "--steps", "40", "--rank", "4",
                      "--lr", "1e-2", "--log-every", "5", "--out", str(out),
                      "--save-state", str(st)])
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 8
    assert np.mean(losses[-3:]) < losses[0] * 0.9, losses
    base = jax.eval_shape(lambda k: junet.init(k, jsd.TINY.unet, jnp.bfloat16),
                          jax.random.key(0))
    jlora = jax.eval_shape(lambda p: jtrain.init_lora(jax.random.key(1), p, rank=4), base)
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(jlora)[0]}
    saved = safetensors_io.load_state_dict(out)
    assert {k: tuple(v.shape) for k, v in saved.items()} == want
    assert all(v.dtype == torch.float32 for v in saved.values())
    # the train state: resumed by the port's CLI, read by the JAX package
    state = cli.main(["--preset", "tiny", "--cpu", "--steps", "42", "--rank", "4",
                      "--lr", "1e-2", "--out", str(out), "--resume", str(st)])
    assert "resumed at step 40" in capsys.readouterr().out and state.step == 42
    jopt = jtrain.default_optimizer(1e-2, warmup_steps=4)
    zeros = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jlora)
    got = jtrain.load_train_state(jtrain.TrainState.create(zeros, jopt), st)
    assert int(got.step) == 40
    for k, v in _flatten(got.params, "").items():
        np.testing.assert_array_equal(v, first.params[k[1:]].numpy(), err_msg=k)
