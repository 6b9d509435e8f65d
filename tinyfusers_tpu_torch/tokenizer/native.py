"""ctypes front end of the C++ BPE merge loop (native/bpe.cpp); port of
tinyfusers_tpu/tokenizer/native.py.

Drop-in for bpe.ClipTokenizer.encode*: cleanup, lowercasing and the word
split run in Python through bpe.ClipTokenizer.words (one implementation
of the word boundaries), the merge loop runs native over the
'\\n'-joined words. Without libtfnative, or without merges (the
byte-level tokenizer), it delegates to the Python tokenizer.
"""
from __future__ import annotations

import ctypes
import gzip
import os
from pathlib import Path
from typing import List, Optional

from . import bpe as pybpe
from ..native import get_lib


class NativeClipTokenizer:
    def __init__(self, merges_blob: Optional[bytes]):
        """merges_blob: the merges file's pairs WITHOUT its version line,
        or None for the byte-level tokenizer (the Python one runs)."""
        self._lib = get_lib()
        self._handle = None
        self._fallback: Optional[pybpe.ClipTokenizer] = None
        self._splitter = pybpe.ClipTokenizer(None)
        if self._lib is not None and merges_blob is not None:
            self._handle = self._lib.tf_bpe_create(merges_blob, len(merges_blob))
        if self._handle is None:
            self._fallback = _python_tokenizer_from_blob(merges_blob)
            self.sot_id = self._fallback.sot_id
            self.eot_id = self._fallback.eot_id
        else:
            n_merges = sum(1 for line in merges_blob.split(b"\n") if line.strip())
            self.sot_id = 512 + n_merges
            self.eot_id = 512 + n_merges + 1

    @classmethod
    def from_merges_file(cls, path) -> "NativeClipTokenizer":
        path = Path(path)
        raw = path.read_bytes()
        if path.suffix == ".gz":
            raw = gzip.decompress(raw)
        lines = raw.decode("utf-8").split("\n")
        lines = lines[1: 49152 - 256 - 2 + 1]
        return cls("\n".join(lines).encode("utf-8"))

    @classmethod
    def load_default(cls) -> "NativeClipTokenizer":
        envp = os.environ.get("TINYFUSERS_BPE_PATH")
        candidates = ([Path(envp)] if envp else []) + pybpe._ASSET_CANDIDATES
        for c in candidates:
            if c.is_file():
                return cls.from_merges_file(c)
        return cls(None)

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def encode_text(self, text: str) -> List[int]:
        if self._fallback is not None:
            return self._fallback.encode_text(text)
        payload = "\n".join(self._splitter.words(text)).encode("utf-8")
        cap = max(64, 4 * len(payload) + 16)
        buf = (ctypes.c_int * cap)()
        n = self._lib.tf_bpe_encode_words(self._handle, payload, len(payload), buf, cap)
        return list(buf[:n])

    def encode(self, text: str, length: int = pybpe.CONTEXT_LENGTH,
               pad_token: Optional[int] = None) -> List[int]:
        if pad_token is None:
            pad_token = self.eot_id
        ids = self.encode_text(text)[: length - 2]
        return ([self.sot_id] + ids + [self.eot_id]
                + [pad_token] * (length - 2 - len(ids)))

    def __del__(self):
        if self._handle is not None and self._lib is not None:
            self._lib.tf_bpe_destroy(self._handle)


def _python_tokenizer_from_blob(blob: Optional[bytes]) -> pybpe.ClipTokenizer:
    if blob is None:
        return pybpe.ClipTokenizer(None)
    merges = [tuple(line.split()) for line in blob.decode("utf-8").split("\n") if line.strip()]
    return pybpe.ClipTokenizer(merges)  # type: ignore[arg-type]
