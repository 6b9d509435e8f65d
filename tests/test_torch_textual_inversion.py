"""The port's textual inversion (io/textual_inversion.py) against the JAX
package's on the CPU: the accepted file layouts (A1111 .pt, safetensors
by key or as one tensor), the extended CLIP table and the new ids, the
encoding with placeholders (alone and with prompt weights), and CLIP run
on the learned vectors.

Tolerances: files, tables and ids bit for bit (the port reads the same
bytes and appends the same fp32 rows); one TINY CLIP forward in fp32 at
rtol = atol = 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinyfusers_tpu.io import safetensors_io as jst
from tinyfusers_tpu.io import textual_inversion as jti
from tinyfusers_tpu.models import clip as jclip
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu.tokenizer import bpe as jbpe
from tinyfusers_tpu.tokenizer import prompt_weights as jpw
from tinyfusers_tpu_torch.io import textual_inversion as tti
from tinyfusers_tpu_torch.io.from_jax import load_params
from tinyfusers_tpu_torch.models import clip as tclip
from tinyfusers_tpu_torch.pipeline import sd as tsd
from tinyfusers_tpu_torch.tokenizer import bpe as tbpe
from tinyfusers_tpu_torch.tokenizer import prompt_weights as tpw

from torch_parity import few_torch_threads, random_tree  # noqa: F401

CFG = jsd.TINY.clip


def _vecs(n, dim=CFG.dim, seed=0):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


@pytest.fixture(scope="module")
def clips():
    """(JAX CLIP tree, the port's CLIP loaded from it), TINY."""
    params = random_tree(lambda k: jclip.init(k, CFG), 3)
    model = tclip.CLIPTextModel(tsd.TINY.clip, device="cpu")
    load_params(model, params)
    return params, model


def _a1111(path, vec):
    torch.save({"string_to_param": {"*": torch.from_numpy(vec)}, "name": "concept",
                "step": 999, "string_to_token": {"*": 265}}, path)


@pytest.mark.parametrize("layout", ["a1111", "emb_params", "clip_l", "one_tensor",
                                    "one_vector", "fp16"])
def test_load_embedding_matches_jax(tmp_path, layout):
    vec = _vecs(3, 16)
    if layout == "a1111":
        path = tmp_path / "emb.pt"
        _a1111(path, vec)
    else:
        path = tmp_path / "emb.safetensors"
        value = {"one_vector": vec[0], "fp16": vec.astype(np.float16)}.get(layout, vec)
        key = layout if layout in ("emb_params", "clip_l") else "whatever"
        jst.save_state_dict({key: value} if layout != "fp16" else {"emb_params": value}, path)
    want = jti.load_embedding(path)
    got = tti.load_embedding(path)
    assert got.ndim == 2 and tuple(got.shape) == want.shape
    assert str(got.dtype)[6:] == want.dtype.name
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_load_embedding_refuses_an_unknown_layout(tmp_path):
    path = tmp_path / "two.safetensors"
    jst.save_state_dict({"a": _vecs(1, 8), "b": _vecs(1, 8, 1)}, path)
    with pytest.raises(ValueError, match="unrecognized textual-inversion layout"):
        tti.load_embedding(path)


def test_extend_clip_matches_jax(clips):
    params, _ = clips
    model = tclip.CLIPTextModel(tsd.TINY.clip, device="cpu")
    load_params(model, params)
    embs = {"<cat>": _vecs(2, seed=1), "<dog>": _vecs(1, seed=2)}
    jnew, jids = jti.extend_clip(params, embs)
    ids = tti.extend_clip(model, {k: torch.from_numpy(v) for k, v in embs.items()})
    assert ids == jids == {"<cat>": [CFG.vocab_size, CFG.vocab_size + 1],
                           "<dog>": [CFG.vocab_size + 2]}
    table = model.token_embedding.weight
    assert not table.requires_grad and table.shape == (CFG.vocab_size + 3, CFG.dim)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jnew["token_embedding"]["weight"],
                                                            np.float32))
    assert model.cfg.vocab_size == CFG.vocab_size  # EOT stays vocab_size - 1


def test_extend_clip_refuses_a_width_mismatch(clips):
    model = tclip.CLIPTextModel(tsd.TINY.clip, device="cpu")
    with pytest.raises(ValueError, match="does not match CLIP dim"):
        tti.extend_clip(model, {"<x>": torch.ones(1, CFG.dim + 1)})


def test_clip_on_learned_vectors_matches_jax(clips):
    """The placeholder's vectors enter the transformer; the pooled readout
    still finds the true EOT, not the larger placeholder id."""
    params, _ = clips
    model = tclip.CLIPTextModel(tsd.TINY.clip, device="cpu")
    load_params(model, params)
    embs = {"<cat>": _vecs(1, seed=4)}
    jnew, jids = jti.extend_clip(params, embs)
    ids = tti.extend_clip(model, {k: torch.from_numpy(v) for k, v in embs.items()})
    v = CFG.vocab_size
    row = [v - 2, 5, ids["<cat>"][0], 7] + [v - 1] * (CFG.max_length - 4)
    want = jclip.apply(jnew, jnp.asarray([row], jnp.int32), CFG)
    got = tclip.apply(model, torch.tensor([row]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    plain = tclip.apply(model, torch.tensor([[v - 2, 5, 6, 7] + row[4:]]))
    assert not torch.allclose(got, plain)
    assert torch.isfinite(tclip.apply_pooled(model, torch.tensor([row]))).all()


PROMPTS = ["a photo of <my-cat> swimming", "a <MY-CAT> and <dog>, <my-cat>",
           "word " * 200 + "<dog>", "no placeholder here", "<dog><my-cat>"]


@pytest.mark.parametrize("prompt", PROMPTS)
@pytest.mark.parametrize("pad", [None, 0])
def test_encode_with_placeholders_matches_jax(prompt, pad):
    ph = {"<my-cat>": [70001, 70002], "<dog>": [70003]}
    want = jti.encode_with_placeholders(jbpe.ClipTokenizer(None), prompt, ph, 77, pad_token=pad)
    got = tti.encode_with_placeholders(tbpe.ClipTokenizer(None), prompt, ph, 77, pad_token=pad)
    assert got == want and len(got) == 77


def test_placeholders_compose_with_prompt_weights():
    ph = {"<cat>": [70001]}
    prompt = "a photo of (<cat>:1.3) swimming, [blurry]"
    want = jpw.encode_weighted(jbpe.ClipTokenizer(None), prompt, 77, placeholders=ph)
    ids, w = tpw.encode_weighted(tbpe.ClipTokenizer(None), prompt, 77, placeholders=ph)
    assert (ids, w) == want
    assert w[ids.index(70001)] == pytest.approx(1.3) and w[1] == 1.0
