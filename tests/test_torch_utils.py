"""The port's host utilities against the JAX package's on the CPU:
utils/flops.py (the same integers), utils/profiling.py, utils/numerics.py,
utils/logging.py and tokenizer/native.py (the port's libtfnative, built
from native/*.cpp with g++)."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu.pipeline import sd3 as jsd3
from tinyfusers_tpu.pipeline import sdxl as jsdxl
from tinyfusers_tpu.tokenizer import native as jnative
from tinyfusers_tpu.utils import flops as jflops
from tinyfusers_tpu.utils import logging as jlogging
from tinyfusers_tpu.utils import numerics as jnumerics
from tinyfusers_tpu.utils import profiling as jprofiling
from tinyfusers_tpu_torch.pipeline import sd as tsd
from tinyfusers_tpu_torch.pipeline import sd3 as tsd3
from tinyfusers_tpu_torch.pipeline import sdxl as tsdxl
from tinyfusers_tpu_torch.tokenizer import bpe as tbpe
from tinyfusers_tpu_torch.tokenizer.native import NativeClipTokenizer
from tinyfusers_tpu_torch.utils import flops as tflops
from tinyfusers_tpu_torch.utils import numerics as tnumerics
from tinyfusers_tpu_torch.utils import profiling as tprofiling
from tinyfusers_tpu_torch.utils.logging import kv

from torch_parity import few_torch_threads, random_tree  # noqa: F401

# (name, JAX config, port config, latent side at the config's resolution)
SD_CONFIGS = [("SD15", jsd.SD15, tsd.SD15, 64), ("SD21_V", jsd.SD21_V, tsd.SD21_V, 96),
              ("SDXL_BASE", jsdxl.SDXL_BASE, tsdxl.SDXL_BASE, 128)]


@pytest.mark.parametrize("name, jcfg, tcfg, side", SD_CONFIGS, ids=[c[0] for c in SD_CONFIGS])
@pytest.mark.parametrize("batch", [1, 2, 8])
def test_flops_equal_jax(name, jcfg, tcfg, side, batch):
    assert tflops.unet_fwd_flops(tcfg.unet, side, side, batch) == \
        jflops.unet_fwd_flops(jcfg.unet, side, side, batch)
    assert tflops.vae_decode_flops(tcfg.vae, side, side, batch) == \
        jflops.vae_decode_flops(jcfg.vae, side, side, batch)
    towers = [("clip", "clip")] if name != "SDXL_BASE" else [("clip_l", "clip_l"),
                                                            ("clip_g", "clip_g")]
    for ja, ta in towers:
        assert tflops.clip_fwd_flops(getattr(tcfg, ta), 2 * batch) == \
            jflops.clip_fwd_flops(getattr(jcfg, ja), 2 * batch)


@pytest.mark.parametrize("batch, ctx", [(1, 77), (2, 154)])
def test_mmdit_flops_equal_jax(batch, ctx):
    jcfg, tcfg = jsd3.SD3_MEDIUM_CFG, tsd3.SD3_MEDIUM_CFG
    assert tflops.mmdit_fwd_flops(tcfg.mmdit, 128, 128, batch, ctx) == \
        jflops.mmdit_fwd_flops(jcfg.mmdit, 128, 128, batch, ctx)
    assert tflops.vae_decode_flops(tcfg.vae, 128, 128, batch) == \
        jflops.vae_decode_flops(jcfg.vae, 128, 128, batch)
    assert tflops.unet_fwd_flops(tsd.SD15.unet, 64, 64, 2) / 1e9 == pytest.approx(1606.5, abs=1.0)


def test_step_metrics_summary_equal_jax():
    lat = [0.31, 0.12, 0.5, 0.07, 0.2, 0.2, 0.9, 0.33]
    mj, mt = jprofiling.StepMetrics(window=6), tprofiling.StepMetrics(window=6)
    for i, v in enumerate(lat):
        mj.record(v, items=i % 3)
        mt.record(v, items=i % 3)
    sj, st = mj.summary(), mt.summary()
    assert sj.keys() == st.keys()
    for k in ("p50_s", "p95_s", "mean_s"):
        assert st[k] == sj[k], k
    assert st["throughput_items_per_s"] > 0
    assert tprofiling.StepMetrics().summary() == {}


def test_timer_hard_sync_and_memory_stats_on_the_cpu():
    x = torch.ones((8, 8)) * 2
    with tprofiling.Timer("t", sync_on={"x": [x]}, quiet=True) as t:
        y = x @ x
    tprofiling.hard_sync(y)
    assert t.seconds is not None and t.seconds >= 0
    assert tprofiling.device_memory_stats("cpu") == {}


def test_device_time_is_the_union_of_kernel_intervals(tmp_path):
    """Overlapping kernels count once; CPU ops and events without a
    duration are not device time; the newest trace is read."""
    events = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 10},
              {"ph": "X", "cat": "kernel", "ts": 5, "dur": 10},   # overlaps: +5
              {"ph": "X", "cat": "kernel", "ts": 6, "dur": 2},    # inside
              {"ph": "X", "cat": "kernel", "ts": 20, "dur": 5},
              {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 100},
              {"ph": "i", "cat": "kernel", "ts": 30}]
    (tmp_path / "trace_1.json").write_text(json.dumps({"traceEvents": events[:1]}))
    (tmp_path / "trace_2.json").write_text(json.dumps({"traceEvents": events}))
    assert tprofiling.device_time_from_trace(str(tmp_path)) == pytest.approx(20e-6)
    assert tprofiling.device_time_from_trace(str(tmp_path / "none")) is None


def test_trace_writes_a_chrome_trace_without_device_time_on_the_cpu(tmp_path):
    with tprofiling.trace(str(tmp_path)) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert list(tmp_path.glob("trace_*.json")) and logdir == str(tmp_path)
    if not torch.cuda.is_available():
        assert tprofiling.device_time_from_trace(str(tmp_path)) is None


def _jax_path(keystr: str) -> str:
    return keystr.replace("']['", ".").strip("[']")


def test_tree_finite_report_counts_equal_jax():
    params = random_tree(lambda k: jsd.init(k, jsd.TINY), 0)
    params["unet"]["out_conv"]["weight"][0, 0, 0, :3] = np.nan
    params["vae"]["decoder"]["conv_out"]["bias"][1] = np.inf
    params["clip"]["token_embedding"]["weight"][5, :7] = -np.inf
    ok_j, bad_j = jnumerics.tree_finite_report(jax.tree.map(jnp.asarray, params))
    tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    ok_t, bad_t = tnumerics.tree_finite_report(tree)
    assert not ok_j and not ok_t
    assert bad_t == {_jax_path(k): n for k, n in bad_j.items()} and sum(bad_t.values()) == 11
    model = tsd.StableDiffusion(tsd.TINY, device="cpu", seed=None)
    from tinyfusers_tpu_torch.io.from_jax import load_sd
    load_sd(model, params)
    ok_m, bad_m = tnumerics.tree_finite_report(model)
    assert not ok_m and sorted(bad_m.values()) == sorted(bad_j.values())
    assert tnumerics.tree_finite_report({"a": torch.ones(3), "i": torch.arange(3)}) == (True, {})


def test_debug_nans_names_the_op_that_made_a_nan():
    x = torch.tensor([1.0, -1.0])
    with pytest.raises(FloatingPointError, match="torch.log"):
        with tnumerics.debug_nans():
            y = torch.exp(x)
            torch.log(x - 0.5 * y)
    with pytest.raises(FloatingPointError, match=r"Tensor.sqrt"):
        with tnumerics.debug_nans():
            x.sqrt()
    with tnumerics.debug_nans(enabled=False):
        assert torch.isnan(torch.log(x)).any()
    with tnumerics.debug_nans():  # finite work passes
        torch.exp(x).sum()


def test_checked_returns_the_error_beside_the_output():
    err, out = tnumerics.checked(lambda a: torch.log(a) * 2)(torch.tensor([-1.0, 2.0]))
    assert "torch.log" in err.get() and torch.isnan(out[0]) and out[1] > 0
    with pytest.raises(FloatingPointError, match="torch.log"):
        err.throw()
    err, _ = tnumerics.checked(torch.exp)(torch.tensor([1.0]))
    assert err.get() is None
    err.throw()
    jerr, _ = jnumerics.checked(lambda a: jnp.log(a))(jnp.array([-1.0]))
    with pytest.raises(Exception):
        jerr.throw()


def test_kv_format_equals_jax():
    for fields in ({"a": 1, "b": "x"}, {"event": "done", "rid": 3, "shape": (32, 32, 3)}, {}):
        assert kv(**fields) == jlogging.kv(**fields)


# -- the native tokenizer ------------------------------------------------------

_CORPUS = """a photo of a cat a photo of a dog a photograph of an astronaut riding
a horse in the style of monet highly detailed masterpiece best quality the quick
brown fox jumps over the lazy dog an oil painting of a futuristic city at night
don't stop believing it's a beautiful day we've been here before""".split()

PROMPTS = ["a photo of a cat", "A   Photo\tOf \n a CAT.", "don't stop, we've only just begun!",
           "8k ultra-realistic, 4x upscale, 100%", "café naïve über",
           "<|endoftext|> literal inside", "word " * 100, ""]


def _train_merges(words, n_merges):
    """CLIP-style BPE merges by pair counts over </w>-terminated words
    (the trainer of tests/test_tokenizer_oracle.py: count, then
    lexicographic tie-break)."""
    b2u = tbpe.byte_to_unicode()
    seqs = {}
    for w in words:
        mapped = "".join(b2u[b] for b in w.encode("utf-8"))
        sym = tuple(mapped[:-1]) + (mapped[-1] + "</w>",)
        seqs[sym] = seqs.get(sym, 0) + 1
    merges = []
    for _ in range(n_merges):
        counts = {}
        for sym, c in seqs.items():
            for p in zip(sym[:-1], sym[1:]):
                counts[p] = counts.get(p, 0) + c
        best = max(sorted(counts), key=lambda p: counts[p]) if counts else None
        if best is None or counts[best] < 2:
            break
        merges.append(best)
        new = {}
        for sym, c in seqs.items():
            out, i = [], 0
            while i < len(sym):
                if i + 1 < len(sym) and (sym[i], sym[i + 1]) == best:
                    out.append(sym[i] + sym[i + 1])
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            new[tuple(out)] = new.get(tuple(out), 0) + c
        seqs = new
    return merges


def test_native_tokenizer_equals_python_and_jax(tmp_path):
    merges = _train_merges(_CORPUS, 200)
    blob = "\n".join(f"{a} {b}" for a, b in merges).encode()
    native = NativeClipTokenizer(blob)
    assert native.is_native
    python = tbpe.ClipTokenizer(merges)
    jax_native = jnative.NativeClipTokenizer(blob)
    assert (native.sot_id, native.eot_id) == (python.sot_id, python.eot_id) == \
        (jax_native.sot_id, jax_native.eot_id)
    for prompt in PROMPTS:
        want = python.encode(prompt)
        assert native.encode(prompt) == want == jax_native.encode(prompt), prompt
        assert native.encode_text(prompt) == python.encode_text(prompt), prompt
    path = tmp_path / "merges.txt"
    path.write_text("#version: 0.2\n" + blob.decode() + "\n")
    from_file = NativeClipTokenizer.from_merges_file(path)
    assert from_file.is_native and from_file.encode(PROMPTS[2]) == python.encode(PROMPTS[2])


def test_native_tokenizer_byte_level_fallback(monkeypatch, tmp_path):
    monkeypatch.delenv("TINYFUSERS_BPE_PATH", raising=False)
    fallback = NativeClipTokenizer(None)
    assert not fallback.is_native
    python, jax_fb = tbpe.ClipTokenizer(None), jnative.NativeClipTokenizer(None)
    assert (fallback.sot_id, fallback.eot_id) == (49406, 49407)
    for prompt in PROMPTS:
        assert fallback.encode(prompt) == python.encode(prompt) == jax_fb.encode(prompt)
    monkeypatch.setattr(tbpe, "_ASSET_CANDIDATES", [tmp_path / "missing.txt"])
    assert not NativeClipTokenizer.load_default().is_native
