"""Embedding lookup (port of tinyfusers_tpu/ops/embedding.py)."""
from __future__ import annotations

import torch


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """ids (...,) int -> (..., dim) rows of weight (vocab, dim)."""
    return weight[ids.long()]
