"""The port's CLIP BPE tokenizer and prompt emphasis against the JAX
package's (tokenizer/bpe.py, tokenizer/prompt_weights.py) on the CPU.

The repository holds no real merges file, so the BPE runs with synthetic
merges files (.txt and .gz), as tests/test_tokenizer.py does, and with
the byte-level tokenizer. Ids must be equal, list for list; emphasis
weights equal as Python floats (both sides multiply the same factors in
the same order).
"""
import gzip
import importlib.util
import sys
from pathlib import Path

import pytest

from tinyfusers_tpu.tokenizer import bpe as jbpe
from tinyfusers_tpu.tokenizer import prompt_weights as jpw
from tinyfusers_tpu_torch.tokenizer import bpe as tbpe
from tinyfusers_tpu_torch.tokenizer import prompt_weights as tpw

ROOT = Path(__file__).resolve().parent.parent

MERGES = ["t h", "th e</w>", "c a", "ca t</w>", "d o", "do g</w>", "p h", "ph o",
          "pho t", "phot o</w>", "a </w>", "o f</w>", "i n", "in g</w>", "r e", "s t",
          "st y", "sty le</w>", "l e</w>", "8 k</w>", "h d</w>", "é </w>"]

PROMPTS = [
    "a photo of the cat", "A Photo Of THE Dog.", "cat,dog;the:photo!!", "8k hd, 4096x2160",
    "it's the cat's photo, isn't it? we'll see, they're here, I'd go",
    "  lots   of\twhitespace\n and newlines  ", "café naïve façade", "東京タワー 夜景",
    "x² + y³ = z", "emoji 🐱🔥 cat", "under_score and-dash", "",
    "the cat " * 60, "<|startoftext|> the <|endoftext|> cat",
]
# Where the stdlib approximation splits non-ASCII text otherwise than
# CLIP's pattern: non-decimal numerals ('²', '³', '½') join the letter
# run before them instead of standing alone.
STDLIB_DIFFERS = {"x² + y³ = z", "half½ a cup"}


@pytest.fixture(scope="module", params=["txt", "gz"])
def merges_file(request, tmp_path_factory):
    text = "#version: 0.2\n" + "\n".join(MERGES) + "\n"
    d = tmp_path_factory.mktemp("bpe")
    if request.param == "gz":
        path = d / "bpe_simple_vocab_16e6.txt.gz"
        path.write_bytes(gzip.compress(text.encode()))
    else:
        path = d / "merges.txt"
        path.write_text(text)
    return path


@pytest.mark.parametrize("pad", [None, 0])
def test_bpe_ids_equal_jax(merges_file, pad):
    jt = jbpe.ClipTokenizer.from_merges_file(merges_file)
    tt = tbpe.ClipTokenizer.from_merges_file(merges_file)
    assert (tt.sot_id, tt.eot_id) == (jt.sot_id, jt.eot_id) == (512 + len(MERGES),
                                                                 513 + len(MERGES))
    for text in PROMPTS:
        assert tt.encode_text(text) == jt.encode_text(text), text
        for length in (77, 16):
            assert tt.encode(text, length, pad_token=pad) == jt.encode(text, length, pad_token=pad)
    assert any(i >= 512 for i in tt.encode_text("a photo of the cat"))  # merges applied


@pytest.mark.parametrize("pad", [None, 0])
def test_byte_level_ids_equal_jax(pad):
    jt, tt = jbpe.ClipTokenizer(None), tbpe.ClipTokenizer(None)
    assert (tt.sot_id, tt.eot_id) == (tbpe.SOT, tbpe.EOT) == (jbpe.SOT, jbpe.EOT)
    for text in PROMPTS:
        got = tt.encode(text, pad_token=pad)
        assert got == jt.encode(text, pad_token=pad), text
        assert len(got) == 77 and got[0] == tbpe.SOT
    assert tt.encode("", pad_token=0)[2:] == [0] * 75


def test_load_default_reads_the_environment_and_refuses_the_fallback(merges_file, monkeypatch):
    monkeypatch.setenv("TINYFUSERS_BPE_PATH", str(merges_file))
    tok = tbpe.ClipTokenizer.load_default(allow_fallback=False)
    assert not tok.byte_level_only
    assert tok.encode("the cat") == jbpe.ClipTokenizer.from_merges_file(merges_file).encode("the cat")
    monkeypatch.setenv("TINYFUSERS_BPE_PATH", str(merges_file.parent / "missing.txt"))
    with pytest.raises(FileNotFoundError, match="refusing the byte-level"):
        tbpe.ClipTokenizer.load_default(allow_fallback=False)
    assert tbpe.ClipTokenizer.load_default(allow_fallback=True).byte_level_only
    # the port's own asset folder, never the JAX package's
    assert all("tinyfusers_tpu_torch" in str(c) for c in tbpe._ASSET_CANDIDATES)


def _load_without_regex(path: Path, name: str, monkeypatch):
    """A fresh copy of a bpe module, imported as if `regex` were missing."""
    monkeypatch.setitem(sys.modules, "regex", None)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.delitem(sys.modules, "regex")
    return mod


def test_stdlib_pattern_comes_across_exactly(merges_file, monkeypatch):
    """Without the regex module both packages fall back to the same stdlib
    pattern: equal ids on every prompt, non-ASCII included."""
    jfb = _load_without_regex(ROOT / "tinyfusers_tpu" / "tokenizer" / "bpe.py", "_jbpe_re",
                              monkeypatch)
    tfb = _load_without_regex(ROOT / "tinyfusers_tpu_torch" / "tokenizer" / "bpe.py",
                              "_tbpe_re", monkeypatch)
    assert tfb.WORD_PATTERN == "re" and tbpe.WORD_PATTERN == "regex"
    jt, tt = jfb.ClipTokenizer.from_merges_file(merges_file), tfb.ClipTokenizer.from_merges_file(
        merges_file)
    for text in PROMPTS + sorted(STDLIB_DIFFERS):
        assert tt.encode(text) == jt.encode(text), text


def test_stdlib_pattern_agrees_with_clips_on_ascii(merges_file, monkeypatch):
    tok = tbpe.ClipTokenizer.from_merges_file(merges_file)
    exact = {t: tok.encode(t) for t in PROMPTS + sorted(STDLIB_DIFFERS)}
    monkeypatch.setattr(tbpe, "_WORD_RE", tbpe.STDLIB_WORD_RE)
    tok = tbpe.ClipTokenizer.from_merges_file(merges_file)
    differs = {t for t, ids in exact.items() if tok.encode(t) != ids}
    assert differs == STDLIB_DIFFERS
    assert all(not t.isascii() for t in differs)


EMPHASIS = [
    "a (red) cat", "a ((very red)) cat", "[blurry] photo", "a (cat:1.3) and [[dog]]",
    "(a (nested:0.5) group:1.2) tail", r"literal \(parens\) and \[brackets\]",
    "unclosed (paren and: colon", "closing) without opening]", "(empty:)", "", "plain prompt",
    "(8k:1.5), (masterpiece), [lowres:0.7]",
]


def test_parse_equals_jax():
    for text in EMPHASIS:
        assert tpw.parse(text) == jpw.parse(text), text


@pytest.mark.parametrize("pad", [None, 0])
def test_encode_weighted_equals_jax(merges_file, pad):
    jt = jbpe.ClipTokenizer.from_merges_file(merges_file)
    tt = tbpe.ClipTokenizer.from_merges_file(merges_file)
    for text in EMPHASIS + ["(the cat:1.4) " * 30]:
        got = tpw.encode_weighted(tt, text, 77, pad_token=pad)
        assert got == jpw.encode_weighted(jt, text, 77, pad_token=pad), text
        assert len(got[0]) == len(got[1]) == 77
    # weighted and plain prompts build the same ids
    assert tpw.encode_weighted(tt, "a photo of the cat", pad_token=pad)[0] == \
        tt.encode("a photo of the cat", pad_token=pad)


def test_encode_weighted_placeholders_equal_jax(merges_file):
    jt = jbpe.ClipTokenizer.from_merges_file(merges_file)
    tt = tbpe.ClipTokenizer.from_merges_file(merges_file)
    placeholders = {"<my-cat>": [49408, 49409], "<Style>": [49410]}
    for text in ["a photo of <my-cat>", "(<MY-CAT>:1.3) in <style> style", "<style><my-cat>"]:
        got = tpw.encode_weighted(tt, text, 16, placeholders=placeholders)
        assert got == jpw.encode_weighted(jt, text, 16, placeholders=placeholders), text
    ids, w = tpw.encode_weighted(tt, "(<my-cat>:1.3)", 16, placeholders=placeholders)
    assert ids[1:3] == [49408, 49409] and w[1:3] == [1.3, 1.3]
