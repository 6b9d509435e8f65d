"""The port's eval slice against the JAX package on the CPU:
models/clip_vision.py, the CLIP-vision state map, eval/clip_score.py,
eval/fid.py and tools/accuracy_eval_torch.py (benchmarks/accuracy_eval.py's
counterpart).

Tolerances: the ViT tower in fp32 within 3e-5 of JAX's and of HF's
CLIPVisionModelWithProjection (the JAX package's HF-oracle bound);
``resize_bilinear`` within 1e-6 of ``jax.image.resize`` on [0, 1] images,
so ``preprocess``, which then divides by std (>= 0.2613), within
1e-6 / 0.2613; CLIP scores (100 x cosine) within 1e-4; the FID math equal
to JAX's float64 result bit for bit.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.eval import clip_score as jcs
from tinyfusers_tpu.eval import fid as jfid
from tinyfusers_tpu.io import state_map as jstate_map
from tinyfusers_tpu.models import clip as jclip
from tinyfusers_tpu.models import clip_vision as jcv
from tinyfusers_tpu_torch.eval import clip_score as tcs
from tinyfusers_tpu_torch.eval import fid as tfid
from tinyfusers_tpu_torch.io import safetensors_io
from tinyfusers_tpu_torch.io import state_map as tstate_map
from tinyfusers_tpu_torch.io.from_jax import load_clip_vision
from tinyfusers_tpu_torch.models import clip as tclip
from tinyfusers_tpu_torch.models import clip_vision as tcv

from torch_parity import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
VIT_ATOL = 3e-5
RESIZE_ATOL = 1e-6
PRE_ATOL = RESIZE_ATOL / min(tcv.IMAGE_STD)
SCORE_ATOL = 1e-4

# TINY_VISION, and ViT-L/14's patch geometry at a small width: 56², 14-px
# patches (16 patches + the class token), 2 heads of 64
VISION_CFGS = {"tiny": (jcv.TINY_VISION, tcv.TINY_VISION),
               "p14": (jcv.CLIPVisionConfig(image_size=56, patch_size=14, dim=128, num_layers=2,
                                            num_heads=2, mlp_dim=256, projection_dim=64),
                       tcv.CLIPVisionConfig(image_size=56, patch_size=14, dim=128, num_layers=2,
                                            num_heads=2, mlp_dim=256, projection_dim=64))}
# the scorer's text tower at TINY widths (the accuracy harness's tiny preset)
TEXT_CFG = dict(vocab_size=128, max_length=16, dim=64, num_layers=2, num_heads=4, mlp_dim=128,
                projection_dim=48)


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


acc = load_file(ROOT / "tools" / "accuracy_eval_torch.py", "accuracy_eval_torch")


def vision_tree(cfg, seed: int):
    """A JAX clip_vision tree of seeded numpy values: weights normal /
    sqrt(fan_in), norm scales 1 + 0.1 N, biases 0.1 N, the class and
    position embeddings 0.02 N."""
    shapes = jax.eval_shape(lambda: jcv.init(jax.random.key(0), cfg))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if "bias" in name:
            return 0.1 * x
        if "norm" in name:
            return 1.0 + 0.1 * x
        if "class_embedding" in name or "position_embedding" in name:
            return 0.02 * x
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) == 4 else s.shape[-2]
        return x / np.sqrt(fan_in)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def text_ids(cfg, batch: int, seed: int) -> np.ndarray:
    """SOT, tokens, EOT, then EOT padding: argmax(ids) is the first EOT."""
    rng = np.random.default_rng(seed)
    sot, eot = cfg.vocab_size - 2, cfg.vocab_size - 1
    out = np.full((batch, cfg.max_length), eot, np.int64)
    for b in range(batch):
        n = int(rng.integers(3, cfg.max_length - 2))
        out[b, 0] = sot
        out[b, 1:1 + n] = rng.integers(1, sot - 1, size=n)
    return out


def as_jax_scorer(scorer: tcs.CLIPScorer) -> dict:
    """The port's scorer as the JAX package's scorer dict, through the HF
    layout: the port's maps out, the JAX package's maps in."""
    text = {k: v.numpy() for k, v in tstate_map.clip_to_state(scorer.text).items()}
    vision = {k: v.numpy() for k, v in tstate_map.clip_vision_to_state(scorer.vision).items()}
    tc, vc = scorer.text_cfg, scorer.vision_cfg
    jtc = jclip.CLIPConfig(vocab_size=tc.vocab_size, max_length=tc.max_length, dim=tc.dim,
                           num_layers=tc.num_layers, num_heads=tc.num_heads, mlp_dim=tc.mlp_dim,
                           act=tc.act, projection_dim=tc.projection_dim)
    jvc = jcv.CLIPVisionConfig(**{f: getattr(vc, f) for f in vc.__dataclass_fields__})
    return {"text": jstate_map.clip_from_state(text, jtc), "text_cfg": jtc,
            "vision": jstate_map.clip_vision_from_state(vision, jvc), "vision_cfg": jvc}


def tiny_scorer(seed: int = 10) -> tcs.CLIPScorer:
    return tcs.CLIPScorer(tclip.CLIPConfig(**TEXT_CFG), tcv.TINY_VISION, device="cpu", seed=seed)


# -- models/clip_vision.py -----------------------------------------------------

@pytest.mark.parametrize("name", list(VISION_CFGS))
def test_clip_vision_apply_matches_jax(name):
    jcfg, tcfg = VISION_CFGS[name]
    params = vision_tree(jcfg, 1)
    model = tcv.CLIPVisionModel(tcfg, device="cpu", seed=None)
    load_clip_vision(model, params)
    px = np.random.default_rng(2).standard_normal((3, jcfg.image_size, jcfg.image_size, 3)
                                                  ).astype(np.float32)
    want = np.asarray(jcv.apply(params, jnp.asarray(px), jcfg))
    got = tcv.apply(model, torch.from_numpy(px)).numpy()
    assert got.shape == (3, jcfg.projection_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=VIT_ATOL, rtol=0)


def test_clip_vision_seeded_init_is_the_jax_init_tree():
    """The module tree takes the JAX init's tree (load_clip_vision writes
    every parameter once), and a seed draws its distributions: norms ones
    and zeros, the class and position embeddings normal * 0.02, no patch
    bias."""
    model = tcv.CLIPVisionModel(tcv.TINY_VISION, device="cpu", seed=None)
    load_clip_vision(model, jax.tree.map(np.asarray, jcv.init(jax.random.key(0),
                                                              jcv.TINY_VISION)))
    seeded = tcv.CLIPVisionModel(tcv.TINY_VISION, device="cpu", seed=3)
    assert seeded.patch_embedding.bias is None
    assert torch.equal(seeded.pre_layernorm.weight, torch.ones(64))
    assert torch.equal(seeded.layers[1].layer_norm2.bias, torch.zeros(64))
    for t in (seeded.class_embedding, seeded.position_embedding.weight):
        assert 0.01 < t.std().item() < 0.03
    again = tcv.CLIPVisionModel(tcv.TINY_VISION, device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(seeded.parameters(), again.parameters()))


def test_clip_vision_runs_on_the_gpu_or_raises():
    if torch.cuda.is_available():
        assert tcv.CLIPVisionModel(tcv.TINY_VISION).class_embedding.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tcv.CLIPVisionModel(tcv.TINY_VISION)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tcs.CLIPScorer(tclip.CLIPConfig(**TEXT_CFG), tcv.TINY_VISION)


# -- preprocess: jax.image.resize antialiases when it downscales ---------------

@pytest.mark.parametrize("side,size", [(512, 224), (768, 224), (1024, 224), (64, 32), (32, 32)])
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_preprocess_matches_jax(side, size, kind):
    rng = np.random.default_rng(side + size)
    if kind == "uint8":
        images = rng.integers(0, 256, (2, side, side, 3), dtype=np.uint8)
        unit = images.astype(np.float32) / np.float32(255.0)
    else:
        images = unit = rng.random((2, side, side, 3), dtype=np.float32)
    jcfg, tcfg = jcv.CLIPVisionConfig(image_size=size), tcv.CLIPVisionConfig(image_size=size)
    want = np.asarray(jcv.preprocess(jnp.asarray(images), jcfg))
    got = tcv.preprocess(torch.from_numpy(images), tcfg).numpy()
    assert got.shape == (2, size, size, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=PRE_ATOL, rtol=0)
    if side != size:
        want_r = np.asarray(jax.image.resize(jnp.asarray(unit), (2, size, size, 3), "bilinear"))
        got_r = tcv.resize_bilinear(torch.from_numpy(unit), size).numpy()
        np.testing.assert_allclose(got_r, want_r, atol=RESIZE_ATOL, rtol=0)


# -- the CLIP-vision state map --------------------------------------------------

def _hf_vision(cfg, seed):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPVisionConfig(
        hidden_size=cfg.dim, intermediate_size=cfg.mlp_dim, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, image_size=cfg.image_size, patch_size=cfg.patch_size,
        projection_dim=cfg.projection_dim, hidden_act=cfg.act)
    torch.manual_seed(seed)
    model = transformers.CLIPVisionModelWithProjection(hf_cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    return model


@pytest.mark.parametrize("name", list(VISION_CFGS))
def test_clip_vision_map_matches_jax_and_hf(name):
    """An HF CLIPVisionModelWithProjection state through the port's map and
    through the JAX package's: the same parameters; the port's embeddings
    within 3e-5 of HF's image_embeds."""
    jcfg, tcfg = VISION_CFGS[name]
    hf = _hf_vision(tcfg, seed=11)
    state = {k: v.detach() for k, v in hf.state_dict().items() if "position_ids" not in k}
    model = tcv.CLIPVisionModel(tcfg, device="cpu", seed=None)
    tstate_map.clip_vision_from_state(state, model)
    via_jax = tcv.CLIPVisionModel(tcfg, device="cpu", seed=None)
    load_clip_vision(via_jax, jstate_map.clip_vision_from_state(
        {k: v.numpy() for k, v in state.items()}, jcfg))
    for (n, a), (_, b) in zip(model.named_parameters(), via_jax.named_parameters()):
        assert torch.equal(a, b), n
    px = np.random.default_rng(5).standard_normal((2, tcfg.image_size, tcfg.image_size, 3)
                                                  ).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(px.transpose(0, 3, 1, 2))).image_embeds.numpy()
    np.testing.assert_allclose(tcv.apply(model, torch.from_numpy(px)).numpy(), ref,
                               atol=VIT_ATOL, rtol=0)


def test_clip_vision_map_round_trips():
    """to_state gives every key of the HF layout (HF's "pre_layrnorm",
    visual_projection beside the tower, the patch weight (dim, 3, P, P)),
    and from_state of it gives the model back bit for bit, also under a
    CLIPModel's nested prefix."""
    model = tcv.CLIPVisionModel(tcv.TINY_VISION, device="cpu", seed=7)
    state = tstate_map.clip_vision_to_state(model)
    assert state["vision_model.embeddings.patch_embedding.weight"].shape == (64, 3, 8, 8)
    assert state["visual_projection.weight"].shape == (48, 64)
    assert "vision_model.pre_layrnorm.weight" in state
    hf = _hf_vision(tcv.TINY_VISION, seed=1)
    assert set(state) == {k for k in hf.state_dict() if "position_ids" not in k}
    for prefix in ("vision_model", "clip.vision_model"):
        nested = tstate_map.clip_vision_to_state(model, prefix)
        if prefix != "vision_model":
            assert "clip.visual_projection.weight" in nested
        back = tcv.CLIPVisionModel(tcv.TINY_VISION, device="cpu", seed=None)
        tstate_map.clip_vision_from_state(nested, back, prefix)
        for (n, a), (_, b) in zip(model.named_parameters(), back.named_parameters()):
            assert torch.equal(a, b), n


# -- eval/clip_score.py -----------------------------------------------------------

def test_clip_score_and_features_match_jax():
    scorer = tiny_scorer()
    jscorer = as_jax_scorer(scorer)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    ids = text_ids(scorer.text_cfg, 3, seed=2)
    want = jcs.clip_score(jscorer, jnp.asarray(images), jnp.asarray(ids))
    got = tcs.clip_score(scorer, images, ids)
    assert got.shape == (3,) and np.all(np.abs(got) <= 100.0)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(got, tcs.clip_score(scorer, torch.from_numpy(images), ids))
    feats = tfid.clip_features(scorer, images, batch_size=2)
    assert feats.dtype == np.float64 and feats.shape == (3, 48)
    np.testing.assert_allclose(feats, jfid.clip_features(jscorer, images, batch_size=2),
                               atol=VIT_ATOL, rtol=0)
    flipped = images[:, ::-1].copy()
    assert tfid.clip_fid(scorer, images, flipped) == tfid.fid_from_features(
        tfid.clip_features(scorer, images), tfid.clip_features(scorer, flipped))


def test_load_scorer_params_matches_the_jax_loader(tmp_path):
    """A CLIPModel-layout safetensors file (text_model.*, vision_model.*,
    both projections) through both loaders: the same embeddings within
    3e-5; both towers within 3e-5 of HF's normalized features."""
    transformers = pytest.importorskip("transformers")
    tcfg, vcfg = tclip.CLIPConfig(**{**TEXT_CFG, "dim": 48, "mlp_dim": 96}), tcv.TINY_VISION
    jtcfg = jclip.CLIPConfig(**{**TEXT_CFG, "dim": 48, "mlp_dim": 96})
    hf_cfg = transformers.CLIPConfig(
        projection_dim=vcfg.projection_dim,
        text_config={"vocab_size": tcfg.vocab_size, "hidden_size": tcfg.dim,
                     "intermediate_size": tcfg.mlp_dim, "num_hidden_layers": tcfg.num_layers,
                     "num_attention_heads": tcfg.num_heads,
                     "max_position_embeddings": tcfg.max_length, "hidden_act": tcfg.act,
                     "bos_token_id": tcfg.vocab_size - 2, "eos_token_id": tcfg.vocab_size - 1},
        vision_config={"hidden_size": vcfg.dim, "intermediate_size": vcfg.mlp_dim,
                       "num_hidden_layers": vcfg.num_layers,
                       "num_attention_heads": vcfg.num_heads, "image_size": vcfg.image_size,
                       "patch_size": vcfg.patch_size, "hidden_act": vcfg.act})
    torch.manual_seed(7)
    hf = transformers.CLIPModel(hf_cfg).eval()
    with torch.no_grad():
        for p in hf.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    path = tmp_path / "clip_scorer.safetensors"
    safetensors_io.save_state_dict({k: v for k, v in hf.state_dict().items()
                                    if "position_ids" not in k}, path)
    scorer = tcs.load_scorer_params(path, tcfg, vcfg, device="cpu")
    jscorer = jcs.load_scorer_params(path, jtcfg, jcv.TINY_VISION)
    images = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    ids = text_ids(tcfg, 2, seed=9)
    np.testing.assert_allclose(tcs.embed_images(scorer, images).numpy(),
                               np.asarray(jcs.embed_images(jscorer, jnp.asarray(images))),
                               atol=VIT_ATOL, rtol=0)
    np.testing.assert_allclose(tcs.embed_texts(scorer, ids).numpy(),
                               np.asarray(jcs.embed_texts(jscorer, jnp.asarray(ids))),
                               atol=VIT_ATOL, rtol=0)
    with torch.no_grad():
        px = tcv.preprocess(torch.from_numpy(images), vcfg)
        ref_i = hf.get_image_features(px.permute(0, 3, 1, 2))
        ref_t = hf.get_text_features(torch.from_numpy(ids))
    np.testing.assert_allclose(tcs.embed_images(scorer, images).numpy(),
                               (ref_i / ref_i.norm(dim=-1, keepdim=True)).numpy(),
                               atol=VIT_ATOL, rtol=0)
    np.testing.assert_allclose(tcs.embed_texts(scorer, ids).numpy(),
                               (ref_t / ref_t.norm(dim=-1, keepdim=True)).numpy(),
                               atol=VIT_ATOL, rtol=0)


# -- eval/fid.py ------------------------------------------------------------------

@pytest.mark.parametrize("n,d,seed", [(64, 8, 0), (5, 48, 1), (300, 32, 2)])
def test_fid_math_is_jaxs_bit_for_bit(n, d, seed):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((n, d))
    f2 = rng.standard_normal((n, d)) * 1.3 + 0.2
    for got, want in zip(tfid.feature_stats(f1), jfid.feature_stats(f1)):
        np.testing.assert_array_equal(got, want)
    assert tfid.fid_from_features(f1, f2) == jfid.fid_from_features(f1, f2)
    mu1, s1 = tfid.feature_stats(f1)
    mu2, s2 = tfid.feature_stats(f2.astype(np.float32))
    assert (tfid.frechet_distance(mu1, s1, mu2, s2)
            == jfid.frechet_distance(mu1, s1, mu2, s2))


def test_fid_closed_forms():
    """tests/test_accuracy_eval.py::test_fid_math's closed forms, on the port."""
    rng = np.random.default_rng(0)
    f = rng.standard_normal((64, 8))
    mu, s = tfid.feature_stats(f)
    assert abs(tfid.frechet_distance(mu, s, mu, s)) < 1e-8
    a, b = np.array([1.0, 4.0]), np.array([9.0, 1.0])
    want = 5.0 + (1 - 3) ** 2 + (2 - 1) ** 2
    got = tfid.frechet_distance(np.zeros(2), np.diag(a), np.array([2.0, -1.0]), np.diag(b))
    assert abs(got - want) < 1e-9, (got, want)
    g = f + np.array([0.5] * 8)
    got = tfid.fid_from_features(f, g)
    assert abs(got - 0.25 * 8) < 1e-8, got
    assert abs(tfid.fid_from_features(g, f) - got) < 1e-8
    with pytest.raises(ValueError, match="must be"):
        tfid.feature_stats(np.zeros(8))


# -- tools/accuracy_eval_torch.py ---------------------------------------------------

def test_proof_ids_equal_the_jax_harness(monkeypatch):
    """The JAX harness's proof-mode ids (a closure in its main), read from
    the calls it makes: the pipeline's prompt and empty-prompt ids from
    sd.generate, the scorer's from clip_score. Its main stops there."""
    from tinyfusers_tpu.pipeline import sd as jsd
    from tinyfusers_tpu.tokenizer import bpe as jbpe

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    try:
        jtool = load_file(ROOT / "benchmarks" / "accuracy_eval.py", "jax_accuracy_eval")
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
    seen = {"ids": [], "uids": []}

    class Stop(Exception):
        pass

    def fake_generate(params, ids, uids, lat, g, num_steps, cfg, **kw):
        seen["ids"].append(np.asarray(ids))
        seen["uids"].append(np.asarray(uids))
        return np.zeros((1, cfg.height, cfg.width, 3), np.uint8)

    def fake_score(scorer, images, sids):
        seen["sids"] = np.asarray(sids)
        raise Stop

    real_init = jsd.init  # zeros of its shapes: the ids do not read the weights
    monkeypatch.setattr(jsd, "init", lambda key, cfg, **kw: jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(lambda: real_init(key, cfg))))
    monkeypatch.setattr(jsd, "generate", fake_generate)
    monkeypatch.setattr(jcs, "clip_score", fake_score)
    monkeypatch.setattr(sys, "argv", ["accuracy_eval.py", "--preset", "tiny", "--cpu",
                                      "--prompts", "5", "--variants", ""])
    with pytest.raises(Stop):
        jtool.main()
    tok = jbpe.ClipTokenizer.load_default(allow_fallback=True)
    prompts = acc.PROMPTS[:5]
    np.testing.assert_array_equal(np.concatenate(seen["ids"]), acc.proof_ids(prompts, 128, 16))
    np.testing.assert_array_equal(np.concatenate(seen["uids"]), acc.empty_ids(tok, 5, 128, 16))
    np.testing.assert_array_equal(seen["sids"], acc.proof_ids(prompts, 128, 16))
    assert jtool.PROMPTS == acc.PROMPTS


def test_accuracy_harness_report_and_scores_match_jax(tmp_path, capsys):
    """The JAX harness test's assertions on the port's report, then its
    CLIP scores recomputed by the JAX scorer (the port's seeded scorer
    carried across) on the images the tool returns, and its PSNR by the
    JAX harness's function."""
    out = tmp_path / "report.json"
    report, images = acc.main(["--preset", "tiny", "--cpu", "--steps", "2", "--prompts", "2",
                               "--variants", "int8,cached_cfg", "--json", str(out)])
    assert "== accuracy report ==" in capsys.readouterr().out
    assert report == __import__("json").loads(out.read_text())
    rows = {row["variant"]: row for row in report["rows"]}
    assert set(rows) == {"fp16", "int8", "cached_cfg"}
    for name in ("int8", "cached_cfg"):
        row = rows[name]
        assert "delta_clip_score" in row and "psnr_vs_fp16_db" in row
        assert row["psnr_vs_fp16_db"] > 5.0
        assert row["fid_vs_fp16"] >= 0.0
    assert all(abs(r["clip_score_mean"]) <= 100.0 for r in report["rows"])
    assert report["fid_tower"] == "clip"
    jscorer = as_jax_scorer(tiny_scorer(seed=10))
    sids = jnp.asarray(acc.proof_ids(acc.PROMPTS[:2], 128, 16))
    for name, imgs in images.items():
        assert imgs.dtype == np.uint8 and imgs.shape == (2, 32, 32, 3)
        scores = jcs.clip_score(jscorer, jnp.asarray(imgs), sids)
        assert abs(float(np.mean(scores)) - rows[name]["clip_score_mean"]) <= SCORE_ATOL, name
        if name != "fp16":
            want = round(float(np.mean([acc.psnr(a, b) for a, b in zip(imgs, images["fp16"])])),
                         2)
            assert rows[name]["psnr_vs_fp16_db"] == want


def test_inception_tower_is_refused(capsys):
    with pytest.raises(SystemExit):
        acc.parse_args(["--preset", "tiny", "--cpu", "--fid-tower", "inception"])
    assert "--inception-ckpt" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        acc.parse_args(["--fid-tower", "inception", "--inception-ckpt", "pt_inception.pth"])
    assert "not ported" in capsys.readouterr().err
