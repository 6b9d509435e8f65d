"""Elementwise activations (port of tinyfusers_tpu/ops/activations.py).

Each runs in the input's dtype, as the JAX versions do.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _sqrt_half(dtype: torch.dtype) -> float:
    return float(torch.tensor(0.5 ** 0.5, dtype=dtype))


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
    """Exact (erf) GELU, as SD checkpoints were trained with, formed as
    ``jax.jit(jax.nn.gelu(approximate=False))`` forms it: 0.5 * x *
    erfc(-x * sqrt(0.5)) with sqrt(0.5) rounded to x's dtype, the product
    inside erfc and erfc itself in fp32, erfc rounded to x's dtype, then
    (0.5 * x) * erfc in x's dtype. For bf16 this equals the JAX package at
    every normal input, where ``F.gelu`` (fp32 inside, one rounding) is an
    ulp off at about 1 in 60."""
    sqrt_half = _sqrt_half(x.dtype)
    e = torch.special.erfc(-x.float() * sqrt_half).to(x.dtype)
    return (0.5 * x) * e


def geglu(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """GEGLU combine: x * gelu_erf(gate)."""
    return x * gelu_erf(gate)
