"""CLIP BPE tokenizer (port of tinyfusers_tpu/tokenizer/bpe.py).

OpenAI CLIP's simple_tokenizer, which SD checkpoints were trained with:
lowercase and whitespace-normalize, split into words with CLIP's pattern,
map bytes to printable unicode, merge greedily by lowest rank with an
end-of-word ``</w>`` marker, truncate to 75 tokens, wrap with SOT 49406
and pad with EOT 49407 (or with 0, as OpenCLIP does) to length 77.

Word split: CLIP's exact pattern needs the ``regex`` module's ``\\p``
classes. Without that module the JAX package's stdlib-``re``
approximation runs instead, unchanged: ``[^\\W\\d_]+`` for letter runs,
``\\d`` for a numeral (it misses non-decimal numerals such as '²') and
``(?:[^\\s\\w]|_)+`` for punctuation runs. ``WORD_PATTERN`` says which one
this process runs, and ``load_default`` prints it. On ASCII text the two
agree.

The merges file is found at an explicit path, ``$TINYFUSERS_BPE_PATH``,
or this package's own ``tokenizer/assets/`` (nothing is fetched). Without
one, ``load_default(allow_fallback=True)`` gives a byte-level tokenizer
(byte symbols at ids 0..511, the specials at 49406 / 49407): deterministic
and in range for SD's vocabulary, but not CLIP's ids, so right for
random-weight runs and wrong for real checkpoints; ``allow_fallback=False``
refuses it.
"""
from __future__ import annotations

import gzip
import os
import re
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Tuple

SOT = 49406
EOT = 49407
CONTEXT_LENGTH = 77

_ASSET_CANDIDATES = [
    Path(__file__).parent / "assets" / "bpe_simple_vocab_16e6.txt.gz",
    Path(__file__).parent / "assets" / "bpe_simple_vocab_16e6.txt",
    Path(__file__).parent / "assets" / "merges.txt",
]


@lru_cache()
def byte_to_unicode() -> Dict[int, str]:
    """GPT-2 / CLIP printable-unicode byte mapping: the 188 printable latin
    bytes map to themselves, the rest are shifted into 0x100+. Insertion
    order is CLIP's vocabulary order (printable bytes first), so id('a') is
    64, not 97."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


_CLIP_PATTERN = (
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
)

# the stdlib approximation, used where the regex module is missing
STDLIB_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)

try:
    import regex as _regex
except ImportError:
    _regex = None

if _regex is not None:
    _WORD_RE = _regex.compile(_CLIP_PATTERN, _regex.IGNORECASE)
    WORD_PATTERN = "regex"  # CLIP's exact pattern
else:
    _WORD_RE = STDLIB_WORD_RE
    WORD_PATTERN = "re"  # the stdlib approximation

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")


class ClipTokenizer:
    def __init__(self, merges: Optional[List[Tuple[str, str]]] = None):
        self._b2u = byte_to_unicode()
        self.byte_level_only = merges is None
        merges = merges or []
        # CLIP's id layout: 256 byte symbols, the same 256 with </w>, one id
        # per merge, then SOT / EOT (49406 / 49407 with the real 48894
        # merges; the byte-level tokenizer pins them there).
        base = list(self._b2u.values())
        vocab = base + [v + "</w>" for v in base]
        for a, b in merges:
            vocab.append(a + b)
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        if self.byte_level_only:
            self.encoder[_SPECIALS[0]] = SOT
            self.encoder[_SPECIALS[1]] = EOT
        else:
            self.encoder[_SPECIALS[0]] = len(vocab)
            self.encoder[_SPECIALS[1]] = len(vocab) + 1
        self.sot_id: int = self.encoder[_SPECIALS[0]]
        self.eot_id: int = self.encoder[_SPECIALS[1]]
        self.ranks: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        # the special literals pass the merge step untouched
        self._cache: Dict[str, str] = {s: s for s in _SPECIALS}

    @classmethod
    def from_merges_file(cls, path) -> "ClipTokenizer":
        """OpenAI's bpe_simple_vocab_16e6.txt(.gz) or an HF merges.txt: a
        version line, then one space-separated pair a line; CLIP uses
        merges[1:48895]."""
        path = Path(path)
        raw = path.read_bytes()
        if path.suffix == ".gz":
            raw = gzip.decompress(raw)
        lines = raw.decode("utf-8").split("\n")
        lines = lines[1: 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines if line.strip()]
        return cls(merges)  # type: ignore[arg-type]

    @classmethod
    def load_default(cls, allow_fallback: bool = True) -> "ClipTokenizer":
        envp = os.environ.get("TINYFUSERS_BPE_PATH")
        candidates = ([Path(envp)] if envp else []) + _ASSET_CANDIDATES
        split = f"words split by {'CLIP' if WORD_PATTERN == 'regex' else 'the stdlib'} " \
                f"pattern ({WORD_PATTERN})"
        for c in candidates:
            if c.is_file():
                print(f"tokenizer: CLIP BPE merges from {c}; {split}")
                return cls.from_merges_file(c)
        msg = ("no CLIP BPE merges file found: set TINYFUSERS_BPE_PATH or put "
               "bpe_simple_vocab_16e6.txt.gz in tinyfusers_tpu_torch/tokenizer/assets/")
        if not allow_fallback:
            raise FileNotFoundError(
                msg + "; refusing the byte-level tokenizer because real weights are "
                "loaded: its ids are not CLIP's and would give garbage conditioning")
        print(f"warning: {msg}; using the byte-level tokenizer, which is not "
              f"CLIP-compatible (fine for random-weight runs); {split}")
        return cls(None)

    def _merge_word(self, token: str) -> str:
        """Greedy lowest-rank merges of one word: space-joined symbols, the
        last one carrying </w>."""
        if token in self._cache:
            return self._cache[token]
        symbols: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(symbols) > 1:
            pairs = set(zip(symbols[:-1], symbols[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 30))
            if best not in self.ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(symbols):
                if i < len(symbols) - 1 and symbols[i] == a and symbols[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        out = " ".join(symbols)
        self._cache[token] = out
        return out

    def words(self, text: str) -> List[str]:
        """Cleaned, lowercased words, split by the word pattern."""
        return _WORD_RE.findall(_whitespace_clean(text).lower())

    def encode_text(self, text: str) -> List[int]:
        """Raw BPE ids, unpadded."""
        ids: List[int] = []
        for word in self.words(text):
            mapped = "".join(self._b2u[b] for b in word.encode("utf-8"))
            for sym in self._merge_word(mapped).split(" "):
                ids.append(self.encoder[sym])
        return ids

    def encode(self, text: str, length: int = CONTEXT_LENGTH,
               pad_token: Optional[int] = None) -> List[int]:
        """SOT + up to (length - 2) tokens + EOT, padded to ``length``: with
        EOT (SD1.x's CLIP) unless ``pad_token`` is given (0 for OpenCLIP)."""
        if pad_token is None:
            pad_token = self.eot_id
        ids = self.encode_text(text)[: length - 2]
        return ([self.sot_id] + ids + [self.eot_id]
                + [pad_token] * (length - 2 - len(ids)))
