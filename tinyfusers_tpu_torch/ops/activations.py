"""Elementwise activations (port of tinyfusers_tpu/ops/activations.py).

Each runs in the input's dtype, as the JAX versions do.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def rounded_to(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX's weak typing rounds a Python
    float before an op on a bf16 array; torch keeps a Python float in
    fp32 inside the op and rounds only its result."""
    return float(torch.tensor(value, dtype=dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), one rounding to x's dtype per op: the chain
    ``jax.jit(jax.nn.sigmoid)`` lowers to (``torch.sigmoid`` rounds once)."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


swish = silu


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's fast GELU: x * sigmoid(1.702 * x), 1.702 in x's dtype."""
    return x * sigmoid(rounded_to(1.702, x.dtype) * x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh GELU, its constants in x's dtype."""
    c1, c2 = rounded_to(0.7978845608, x.dtype), rounded_to(0.044715, x.dtype)
    return 0.5 * x * (1.0 + torch.tanh(c1 * x * (1.0 + c2 * x * x)))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as SD checkpoints were trained with, formed as
    ``jax.jit(jax.nn.gelu(approximate=False))`` forms it: 0.5 * x *
    erfc(-x * sqrt(0.5)) with sqrt(0.5) rounded to x's dtype, the product
    inside erfc and erfc itself in fp32, erfc rounded to x's dtype, then
    (0.5 * x) * erfc in x's dtype. For bf16 this equals the JAX package at
    every normal input, where ``F.gelu`` (fp32 inside, one rounding) is an
    ulp off at about 1 in 60."""
    sqrt_half = rounded_to(0.5 ** 0.5, x.dtype)
    e = torch.special.erfc(-x.float() * sqrt_half).to(x.dtype)
    return (0.5 * x) * e


def geglu(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """GEGLU combine: x * gelu_erf(gate)."""
    return x * gelu_erf(gate)
