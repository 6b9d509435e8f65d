"""Elementwise activations (port of tinyfusers_tpu/ops/activations.py).

Each runs in the input's dtype, as the JAX versions do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


swish = silu


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's fast GELU: x * sigmoid(1.702 * x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608 * x * (1.0 + 0.044715 * x * x)))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as SD checkpoints were trained with."""
    return F.gelu(x)


def geglu(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """GEGLU combine: x * gelu_erf(gate)."""
    return x * gelu_erf(gate)
