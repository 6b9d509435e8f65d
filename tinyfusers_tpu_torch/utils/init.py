"""Seeded parameter initializers (port of tinyfusers_tpu/utils/init.py).

Same distributions as the JAX package: linear weights scaled-normal with
std sqrt(1/in), conv weights Kaiming-uniform over fan_in = in*k*k, norm
weights ones and biases zeros, embeddings normal * 0.02, RMSNorm gains
ones, and the adaLN-Zero leaves (modulation and final projection of the
MMDiT) zeros. Values are drawn in place by a ``torch.Generator`` on the
parameter's own device, so full-width weights are made on the GPU without
a host upload. The numbers differ from jax.random's for the same seed;
tests that compare the two packages load the JAX params through
``io/from_jax``.

Weights are in torch layouts: linear (out, in), conv OIHW.
"""
from __future__ import annotations

import torch


def _fill(t: torch.Tensor, sample) -> None:
    with torch.no_grad():
        t.copy_(sample(torch.float32).to(t.dtype))


def linear_(weight: torch.Tensor, bias, gen: torch.Generator) -> None:
    out_dim, in_dim = weight.shape
    std = (1.0 / in_dim) ** 0.5
    _fill(weight, lambda dt: torch.randn(
        weight.shape, generator=gen, device=weight.device, dtype=dt) * std)
    if bias is not None:
        with torch.no_grad():
            bias.zero_()


def conv_(weight: torch.Tensor, bias, gen: torch.Generator) -> None:
    out_ch, in_ch, kh, kw = weight.shape
    bound = (6.0 / (in_ch * kh * kw)) ** 0.5
    _fill(weight, lambda dt: torch.rand(
        weight.shape, generator=gen, device=weight.device, dtype=dt
    ) * (2 * bound) - bound)
    if bias is not None:
        with torch.no_grad():
            bias.zero_()


def norm_(weight: torch.Tensor, bias: torch.Tensor) -> None:
    with torch.no_grad():
        weight.fill_(1.0)
        bias.zero_()


def ones_(weight: torch.Tensor) -> None:
    with torch.no_grad():
        weight.fill_(1.0)


def zeros_(weight: torch.Tensor, bias) -> None:
    with torch.no_grad():
        weight.zero_()
        if bias is not None:
            bias.zero_()


def embedding_(weight: torch.Tensor, gen: torch.Generator) -> None:
    _fill(weight, lambda dt: torch.randn(
        weight.shape, generator=gen, device=weight.device, dtype=dt) * 0.02)
