"""Embedding lookup (port of tinyfusers_tpu/ops/embedding.py).

The JAX package looks ids up with ``jnp.take``, whose default mode fills
the rows of ids outside [-vocab, vocab) with NaN (a negative id counts
from the end), where torch indexing would raise. The port fills them
too: a byte-level tokenizer's ids (up to 511, and the specials 49406 /
49407) against a toy config's small vocabulary give NaN conditioning in
both packages, not an error in one of them.
"""
from __future__ import annotations

import torch


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """ids (...,) int -> (..., dim) rows of weight (vocab, dim)."""
    ids = ids.long()
    vocab = weight.shape[0]
    valid = (ids >= -vocab) & (ids < vocab)
    rows = weight[torch.where(valid, ids, 0)]
    # the fill value goes to the kernel as an argument: no host-to-device copy
    return rows.masked_fill(~valid[..., None], float("nan"))
