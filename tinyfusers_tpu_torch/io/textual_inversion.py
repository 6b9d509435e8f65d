"""Textual inversion: learned token embeddings spliced into CLIP (port of
tinyfusers_tpu/io/textual_inversion.py).

Reads the two common embedding file formats:

- A1111 ``.pt``: ``{"string_to_param": {"*": (n, dim) tensor}, ...}``
  (through io/torch_pickle.py);
- safetensors: ``{"emb_params": (n, dim)}``, per-encoder keys
  (``clip_l``), or one tensor of any name.

``extend_clip`` appends the learned vectors to the CLIP token-embedding
table once, in place on its device, and gives each placeholder word its
new ids; ``encode_with_placeholders`` (and
tokenizer/prompt_weights.encode_weighted's ``placeholders``) puts those ids
where the word appears in a prompt. The pooled readout stays right because
models/clip.py finds EOT by its id, not by argmax.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Mapping

import torch
from torch import nn

from . import safetensors_io, torch_pickle


def load_embedding(path) -> torch.Tensor:
    """A textual-inversion file -> (n_vectors, dim) tensor on the CPU, in
    the file's dtype."""
    if Path(path).suffix == ".safetensors":
        state = safetensors_io.load_state_dict(path)
    else:
        # the whole pickle: A1111 files nest the tensor under
        # string_to_param, which the flat state-dict reader would drop
        state = torch_pickle.load(path)
    for key in ("string_to_param", "string_to_param.*"):
        if key in state:
            obj = state[key]
            return _as_2d(obj["*"] if isinstance(obj, dict) else obj)
    for key in ("emb_params", "clip_l", "emp_params"):
        if key in state:
            return _as_2d(state[key])
    # a file of one tensor, of any name
    tensors = [v for v in state.values() if isinstance(v, torch.Tensor) and v.ndim in (1, 2)]
    if len(tensors) == 1:
        return _as_2d(tensors[0])
    raise ValueError(f"unrecognized textual-inversion layout: keys {sorted(state)[:8]}")


def _as_2d(t: torch.Tensor) -> torch.Tensor:
    return t[None] if t.ndim == 1 else t


def extend_clip(clip_model: nn.Module, embeddings: Mapping[str, torch.Tensor]
                ) -> Dict[str, List[int]]:
    """Append each placeholder's vectors (fp32, then the table's dtype) to
    the token-embedding table of ``clip_model`` (a models.clip
    CLIPTextModel), in place on its device. Returns {word: its new ids},
    for encode_with_placeholders or encode_weighted's ``placeholders``."""
    table = clip_model.token_embedding.weight
    vocab, dim = table.shape
    rows, ids = [], {}
    next_id = vocab
    for word, vecs in embeddings.items():
        vecs = torch.as_tensor(vecs).float()
        if vecs.ndim != 2 or vecs.shape[1] != dim:
            raise ValueError(f"{word}: embedding shape {tuple(vecs.shape)} does not match "
                             f"CLIP dim {dim}")
        ids[word] = list(range(next_id, next_id + len(vecs)))
        next_id += len(vecs)
        rows.append(vecs.to(device=table.device, dtype=table.dtype))
    clip_model.token_embedding.weight = nn.Parameter(
        torch.cat([table.detach()] + rows), requires_grad=False)
    return ids


def encode_with_placeholders(tok, text: str, placeholders: Mapping[str, List[int]],
                             length: int, *, pad_token=None) -> List[int]:
    """ClipTokenizer.encode, but each placeholder word (say "<my-cat>",
    matched case-insensitively in the raw text: CLIP's word pattern would
    split a bracketed name) becomes its learned ids instead of BPE
    tokens."""
    if pad_token is None:
        pad_token = tok.eot_id
    lowered = {w.lower(): v for w, v in placeholders.items()}
    pattern = "(" + "|".join(
        re.escape(w) for w in sorted(placeholders, key=len, reverse=True)) + ")"
    ids: List[int] = []
    for part in re.split(pattern, text, flags=re.IGNORECASE):
        learned = lowered.get(part.lower())
        if learned is not None:
            ids.extend(learned)
        elif part:
            ids.extend(tok.encode_text(part))
    ids = ids[: length - 2]
    return [tok.sot_id] + ids + [tok.eot_id] + [pad_token] * (length - 2 - len(ids))
