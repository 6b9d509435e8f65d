"""Dense layers (port of tinyfusers_tpu/ops/linear.py).

Weights arrive **(in_features, out_features)** as in the JAX package; the
port's modules store torch's (out, in) and pass their transposed view, so
no copy is made. Products accumulate in fp32 and the bias is added in the
same call (fp32 arithmetic before the single rounding to the compute
dtype). Quantized weights come with a later part of the port.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.geglu_ff import geglu_matmul
from .activations import geglu


def linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    compute_dtype=None,
) -> torch.Tensor:
    """y = x @ w + b with w of shape (in, out)."""
    cd = compute_dtype or x.dtype
    return F.linear(x.to(cd), w.to(cd).t(), None if b is None else b.to(cd))


def geglu_linear(
    gx: torch.Tensor,
    gate: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    compute_dtype=None,
) -> torch.Tensor:
    """The transformer FF tail: (gx * gelu_erf(gate)) @ w + b.

    On a CUDA tensor this is the hand-written GEGLU kernel
    (kernels/geglu_ff.py), which raises for a weight it cannot take; on
    the CPU it is geglu + linear, as the JAX package computes it off the
    TPU.
    """
    if gx.is_cuda:
        cd = compute_dtype or gx.dtype
        return geglu_matmul(gx.to(cd), gate.to(cd), w.to(cd), b)
    return linear(geglu(gx, gate), w, b, compute_dtype=compute_dtype)
