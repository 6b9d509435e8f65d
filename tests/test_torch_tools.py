"""The port's tools against the JAX package's on the CPU:
tools/sd3_bench_torch.py (benchmarks/sd3_bench.py's counterpart) and
tools/quant_eval_torch.py (benchmarks/quant_eval.py's), at TINY_SD3 /
sd.TINY with ``--cpu``.

- sd3_bench: the port's fill gives every parameter the JAX tool's
  ``tree_random`` value bit for bit (its stacked blocks included); the
  tool runs dense, int8 and int4 and prints the JAX tool's final line.
- quant_eval: on the same weights, latent, context and ids (loaded from
  one JAX tree and numpy arrays), the harness's eps errors equal the JAX
  tool's computation within rtol 1e-3 (each side's eps differ by ~1e-5
  relative; the metric is a ratio of their means), its dense and quantized
  images are the JAX pipeline's within 1 (a value on a truncation
  boundary), and its PSNR is the JAX tool's function's; the tool runs for
  every format and prints the JAX tool's report.
- serve_quant_bench (benchmarks/serve_quant_bench.py's): the engine over
  an int8 or int4 UNet gives the JAX engine's images over the same
  quantized tree within 1, and a request that joins it mid-flight its own
  image bit for bit; the tool runs every variant at ``--preset tiny``.
- controlnet_compose_bench (benchmarks/controlnet_compose_bench.py's): at
  ``--preset tiny --cpu --steps 3`` a row per mode of the JAX tool, the
  exact mode's image sd.generate's with the same control bit for bit, each
  PSNR the JAX tool's function's, the gates and the hint the JAX tool's.
- memory_footprint (benchmarks/memory_footprint.py's): its argument bytes
  are the JAX step's argument shapes' bytes (the quantized UNet tree, the
  slot latents and contexts) but for the control vectors, fp16 > int8 >
  int4 > 0; temp and total are null on the CPU.
(tools/accuracy_eval_torch.py is held to the JAX harness in
tests/test_torch_eval.py.)

The JAX tools are loaded from their files, the persistent-cache settings
their imports make restored at once.
"""
import contextlib
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.io.quantize_tree import quantize_params as jquantize_params
from tinyfusers_tpu.models import unet as junet
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu.pipeline import sd3 as jsd3
from tinyfusers_tpu.serve import engine as jengine
from tinyfusers_tpu_torch.io.from_jax import load_sd, load_sd3
from tinyfusers_tpu_torch.pipeline import sd as tsd
from tinyfusers_tpu_torch.pipeline import sd3 as tsd3
from tinyfusers_tpu_torch.serve import Engine

from torch_parity import few_torch_threads, random_tree  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # a dataclass's annotations resolve through it
    spec.loader.exec_module(module)
    return module


def jax_tool(name: str):
    """benchmarks/<name>.py, with the jax config its import sets put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    try:
        return load_file(ROOT / "benchmarks" / f"{name}.py", f"jax_{name}")
    finally:
        for k, v in before.items():
            jax.config.update(k, v)


sd3_bench = load_file(ROOT / "tools" / "sd3_bench_torch.py", "sd3_bench_torch")
quant_eval = load_file(ROOT / "tools" / "quant_eval_torch.py", "quant_eval_torch")
serve_quant = load_file(ROOT / "tools" / "serve_quant_bench_torch.py", "serve_quant_bench_torch")
footprint = load_file(ROOT / "tools" / "memory_footprint_torch.py", "memory_footprint_torch")
compose = load_file(ROOT / "tools" / "controlnet_compose_bench_torch.py",
                    "controlnet_compose_bench_torch")


# -- sd3_bench -----------------------------------------------------------------

def test_sd3_bench_fill_is_the_jax_tools_fill():
    jtool = jax_tool("sd3_bench")
    shapes = jax.eval_shape(lambda: jsd3.init(jax.random.key(0), jsd3.TINY_SD3,
                                              dtype=jnp.bfloat16))
    want = tsd3.StableDiffusion3(tsd3.TINY_SD3, device="cpu", dtype=torch.bfloat16, seed=None)
    load_sd3(want, jax.tree.map(lambda a: np.asarray(a, np.float32), jtool.tree_random(shapes)))
    job = sd3_bench.build("tiny", device="cpu")
    got, ref = dict(job.model.named_parameters()), dict(want.named_parameters())
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], ref[k]), k
    # the stacked blocks read successive slices of the tiled pool
    assert not torch.equal(job.model.mmdit.blocks[0].img.qkv.weight,
                           job.model.mmdit.blocks[1].img.qkv.weight)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_sd3_bench_runs_on_the_cpu(quant, capsys):
    best = sd3_bench.main(["--preset", "tiny", "--cpu", "--steps", "2", "--quant", quant])
    out = capsys.readouterr().out.strip().splitlines()
    assert best > 0
    assert (f"mmdit weights quantized: {quant}" in out) == (quant != "none")
    assert re.fullmatch(rf"TINY_SD3 32x32 2-step flow-CFG b=1 quant={quant}: [0-9.]+s "
                        r"\([0-9.]+ img/s/chip, [0-9.]+ ms/step\)", out[-1]), out[-1]


def test_sd3_bench_quantizes_only_the_mmdit_leaves_outside_its_blocks():
    job = sd3_bench.build("tiny", "int8", device="cpu")
    dense = sd3_bench.build("tiny", device="cpu")
    assert job.n_params == dense.n_params == sum(p.numel() for p in dense.model.parameters())
    quantized = {n for n, m in job.model.named_modules()
                 if "weight_values" in dict(m.named_buffers(recurse=False))}
    assert quantized and all(n.startswith("mmdit.") and not n.startswith("mmdit.blocks.")
                             for n in quantized)


# -- quant_eval ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_sd():
    params = random_tree(lambda k: jsd.init(k, jsd.TINY), 50)
    model = tsd.StableDiffusion(tsd.TINY, device="cpu", seed=None)
    load_sd(model, params)
    rng = np.random.default_rng(51)
    lat = rng.standard_normal((1, *tsd.TINY.latent_shape)).astype(np.float32)
    ctx = rng.standard_normal((1, tsd.TINY.clip.max_length, tsd.TINY.unet.context_dim)
                              ).astype(np.float32)
    ids = np.full((1, tsd.TINY.clip.max_length), 49407 % tsd.TINY.clip.vocab_size, np.int32)
    return params, model, lat, ctx, ids


@pytest.mark.parametrize("quant,jq", [("int8", jnp.int8), ("int4", "int4")])
def test_quant_eval_matches_the_jax_tool(tiny_sd, quant, jq):
    params, model, lat, ctx, ids = tiny_sd
    steps = 3
    got = quant_eval.evaluate(model, quant_eval.quantized_copy(model, quant),
                              torch.from_numpy(lat), torch.from_numpy(ctx),
                              torch.from_numpy(ids).long(), steps)
    qparams = {**params, "unet": jquantize_params(params["unet"], jq)}
    apply = jax.jit(lambda p, x, t, c: junet.apply(p, x, t, c, jsd.TINY.unet))
    for t in quant_eval.TIMESTEPS:
        tt = jnp.full((1,), float(t))
        e_d = np.asarray(apply(params["unet"], lat, tt, ctx), np.float32)
        e_q = np.asarray(apply(qparams["unet"], lat, tt, ctx), np.float32)
        want = np.abs(e_q - e_d).mean() / max(np.abs(e_d).mean(), 1e-9)
        np.testing.assert_allclose(got["eps_rel"][t], want, rtol=1e-3)
    g = jnp.float32(quant_eval.GUIDANCE)
    images = [np.asarray(jsd.generate(p, jnp.asarray(ids), jnp.asarray(ids), jnp.asarray(lat), g,
                                      num_steps=steps, cfg=jsd.TINY)) for p in (params, qparams)]
    for mine, theirs in zip(got["images"], images):
        assert mine.dtype == np.uint8 and mine.shape == theirs.shape
        assert np.abs(mine.astype(int) - theirs.astype(int)).max() <= 1
    jtool = jax_tool("quant_eval")
    assert got["psnr"] == jtool.psnr(*got["images"], 255.0)
    assert got["max_pixel_delta"] == int(np.abs(got["images"][0].astype(int)
                                                - got["images"][1].astype(int)).max())


def test_quant_eval_copy_shares_all_but_the_unet(tiny_sd):
    """quantized_copy quantizes a copy of the UNet and shares the CLIP and
    VAE modules; the model it was given keeps its dense UNet."""
    model = tiny_sd[1]
    dense = {n: p.clone() for n, p in model.unet.named_parameters()}
    q = quant_eval.quantized_copy(model, "int8")
    assert q.clip is model.clip and q.vae is model.vae and q.unet is not model.unet
    assert dict(model.unet.named_parameters()).keys() == dense.keys()
    for n, p in model.unet.named_parameters():
        assert torch.equal(p, dense[n]), n
    assert any("weight_values" in dict(m.named_buffers(recurse=False)) for m in q.unet.modules())


@pytest.mark.parametrize("quant", ["int8", "fp8", "int4"])
def test_quant_eval_runs_on_the_cpu(quant, capsys):
    out = quant_eval.main(["--preset", "tiny", "--cpu", "--steps", "2", "--quant", quant])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"== eps-prediction error ({quant}, per-channel weight-only)"
    assert [ln.split(":")[0].strip() for ln in lines[1:4]] == ["t= 981", "t= 501", "t=  21"]
    assert lines[4] == "== end-to-end (2 steps)"
    assert lines[5].startswith("  image PSNR: ") and lines[7].startswith("  changed pixels: ")
    assert all(0 < v < 1 for v in out["eps_rel"].values())
    assert out["images"][0].shape == (1, 32, 32, 3)


# -- serve_quant_bench -----------------------------------------------------------

JQ = {"int8": jnp.int8, "int4": "int4"}


def _engine_images(eng, ids, uids):
    """Request 0 alone for two ticks, then request 1 joins mid-flight:
    {request id: image}."""
    reqs = [eng.make_request(ids[i], uids[0], num_steps=(4, 3)[i], seed=20 + i)
            for i in range(2)]
    eng.submit(reqs[0])
    out = list(eng.step()) + list(eng.step())
    eng.submit(reqs[1])
    out += eng.run_until_idle()
    return {r.request_id: r.image for r in out}


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_engine_matches_the_jax_engine(tiny_sd, quant, monkeypatch):
    params, model, *_ = tiny_sd
    rng = np.random.default_rng(52)
    ids = rng.integers(0, tsd.TINY.clip.vocab_size - 1, (2, tsd.TINY.clip.max_length)
                       ).astype(np.int32)
    uids = np.full((1, tsd.TINY.clip.max_length), tsd.TINY.clip.vocab_size - 1, np.int32)
    qparams = {**params, "unet": jquantize_params(params["unet"], JQ[quant])}
    want = _engine_images(jengine.Engine(qparams, jsd.TINY, num_slots=2), ids, uids)
    qmodel = quant_eval.quantized_copy(model, quant)
    monkeypatch.setattr(tsd, "initial_latent", lambda seed, batch, cfg, device, dtype:
                        torch.from_numpy(np.array(jax.random.normal(
                            jax.random.key(seed), cfg.latent_shape, jnp.float32)))[None]
                        .to(device, dtype))
    got = _engine_images(Engine(qmodel, num_slots=2), ids, uids)
    assert got.keys() == want.keys() == {0, 1}
    for rid in want:
        assert got[rid].shape == (32, 32, 3) and got[rid].dtype == np.uint8
        assert np.abs(got[rid].astype(int) - want[rid].astype(int)).max() <= 1, rid
    # request 1 joined a busy engine in slot 1: alone in slot 0, the same bits
    solo = Engine(qmodel, num_slots=2)
    solo.submit(solo.make_request(ids[1], uids[0], num_steps=3, seed=21))
    np.testing.assert_array_equal(solo.run_until_idle()[0].image, got[1])


def test_serve_quant_bench_runs_on_the_cpu(capsys):
    rows = serve_quant.main(["--preset", "tiny", "--cpu", "--requests", "3", "--slots", "2",
                             "--steps", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in lines] == rows
    assert [r["variant"] for r in rows] == ["fp16", "int8", "int4", "int4_kernel"]
    for r in rows:
        assert r["images_per_s"] > 0 and r["p50_s"] <= r["p95_s"] <= r["wall_s"] + 0.01
        assert r["hbm_gb"] is None and (r["slots"], r["steps"]) == (2, 2)


def test_serve_quant_bench_quantizes_the_unet_alone():
    dense = serve_quant.quantized_model("tiny", "fp16", "cpu")
    for variant, buffer in (("int8", "weight_values"), ("int4", "weight_packed"),
                            ("int4_kernel", "weight_packed")):
        model = serve_quant.quantized_model("tiny", variant, "cpu")
        held = {n for n, m in model.named_modules() if buffer in dict(m.named_buffers(
            recurse=False))}
        assert held and all(n.startswith("unet.") for n in held), variant
        for n, p in dense.named_parameters():  # the same seeded weights elsewhere
            if not n.startswith("unet."):
                assert torch.equal(p, dict(model.named_parameters())[n]), n


# -- memory_footprint ---------------------------------------------------------------

def test_memory_footprint_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "mem.json"
    rows = footprint.main(["--preset", "tiny", "--cpu", "--json", str(out)])
    assert json.loads(out.read_text()) == rows
    assert "== engine-step device memory (tiny, 4 slots" in capsys.readouterr().out
    got = {r["variant"]: r for r in rows}
    assert got["fp16"]["argument_mb"] > got["int8"]["argument_mb"] > \
        got["int4"]["argument_mb"] > 0
    for r in rows:
        assert r["output_mb"] > 0 and r["temp_mb"] is None and r["total_mb"] is None


@pytest.mark.parametrize("variant", ["fp16", "int8", "fp8", "int4"])
def test_memory_footprint_arguments_are_the_jax_steps(variant):
    """The port's argument bytes against the shapes the JAX tool lowers the
    engine step with: the UNet tree quantized by the JAX rule, latents
    (S, h, w, c) and contexts (2S, T, D) in bf16, then the port's control
    block (5 x S fp32) where JAX passes four fp32 vectors and a bool one."""
    slots = 3
    eng = Engine(serve_quant.quantized_model("tiny", variant, "cpu"), num_slots=slots)
    got = footprint.footprint(eng)
    shapes = jax.eval_shape(lambda: jsd.init(jax.random.key(0), jsd.TINY, dtype=jnp.bfloat16))
    unet = shapes["unet"]
    if variant != "fp16":
        q = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn, "int4": "int4"}[variant]
        unet = jax.eval_shape(lambda t: jquantize_params(t, q), unet)
    h, w, c = jsd.TINY.latent_shape
    want = (sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(unet))
            + 2 * slots * h * w * c + 2 * 2 * slots * jsd.TINY.clip.max_length
            * jsd.TINY.clip.dim)
    assert got["argument_mb"] * 2 ** 20 == want + 5 * slots * 4
    assert got["output_mb"] * 2 ** 20 == 2 * slots * h * w * c


def test_the_tools_import_no_jax():
    """The tools, imported and their arguments parsed in a fresh process
    without jax or the JAX package loaded by them."""
    import subprocess

    code = (
        "import importlib.util, sys\n"
        "for name in ('sd3_bench_torch', 'quant_eval_torch', 'accuracy_eval_torch',\n"
        "             'serve_quant_bench_torch', 'memory_footprint_torch',\n"
        "             'controlnet_compose_bench_torch', 'ckpt_drill_torch'):\n"
        "    spec = importlib.util.spec_from_file_location(name, f'tools/{name}.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    sys.modules[name] = mod\n"
        "    spec.loader.exec_module(mod)\n"
        "    mod.parse_args([])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'tinyfusers_tpu' or m.startswith('tinyfusers_tpu.')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_compose_bench_runs_on_the_cpu(capsys):
    rows = compose.main(["--preset", "tiny", "--cpu", "--steps", "3"])
    assert [r["mode"] for r in rows] == [m for m, _ in compose.MODES]
    assert [m for m, _ in compose.MODES] == ["exact+control", "cached_cfg u=2",
                                             "deepcache k=2", "dc k=2 + u=2"]
    job = compose.build("tiny", "cpu")
    with torch.inference_mode():
        want = tsd.generate(job["model"], job["ids"], job["uids"], job["latent"],
                            compose.GUIDANCE, num_steps=3, control=job["control"]).numpy()
    np.testing.assert_array_equal(rows[0]["image"], want)
    jtool = jax_tool("controlnet_compose_bench")
    assert rows[0]["psnr"] is None
    for r in rows[1:]:
        assert r["psnr"] == jtool.psnr(r["image"], rows[0]["image"])
        assert r["images_per_s"] == 1.0 / min(r["seconds"]) and len(r["seconds"]) == 3
    out = capsys.readouterr().out
    assert out.count("img/s") == 4 and out.count("PSNR vs exact") == 3


def test_compose_bench_counts_the_first_timed_image_of_each_mode():
    """run_modes(repeats=1, counted=, report=): one untimed and one timed
    image a mode, the timed one inside counted(mode), each mode's line to
    report; the timed image is the untimed one's again."""
    job = compose.build("tiny", "cpu")
    entered, lines, images = [], [], []
    generate = tsd.generate

    def kept(*args, **kw):
        images.append(generate(*args, **kw))
        return images[-1]

    @contextlib.contextmanager
    def counted(mode):
        entered.append((mode, len(images)))
        yield
        entered.append((mode, len(images)))

    tsd.generate = kept
    try:
        with torch.inference_mode():
            rows = compose.run_modes(job["model"], job["control"], job["ids"], job["uids"],
                                     job["latent"], 2, repeats=1, counted=counted,
                                     report=lines.append)
    finally:
        tsd.generate = generate
    modes = [m for m, _ in compose.MODES]
    assert entered == [(m, n) for i, m in enumerate(modes) for n in (2 * i + 1, 2 * i + 2)]
    assert [len(r["seconds"]) for r in rows] == [1] * 4
    assert len(lines) == 4 and all(line.startswith(m) for line, m in zip(lines, modes))
    for i in range(4):
        assert torch.equal(images[2 * i], images[2 * i + 1])


def test_compose_bench_gates_and_hint_are_the_jax_tools():
    """Zero convs and the middle output at 0.02, the hint conv as the init
    leaves it (zero), the checkerboard of 32-pixel squares at 8x the latent
    grid."""
    cn, hint, scale = compose.build("tiny", "cpu")["control"]
    for conv in [*cn.zero_convs, cn.middle_out]:
        assert torch.all(conv.weight == compose.GATE)
    assert not cn.input_hint[-1].weight.any()
    hh, ww = jsd.TINY.latent_shape[0] * 8, jsd.TINY.latent_shape[1] * 8
    yy, xx = np.mgrid[0:hh, 0:ww]
    want = np.stack([(yy // 32 + xx // 32) % 2] * 3, -1)[None]
    np.testing.assert_array_equal(hint.numpy(), want.astype(np.float32))
    assert scale == 1.0
