"""Dense and weight-only quantized layers (port of
tinyfusers_tpu/ops/linear.py).

Weights arrive **(in_features, out_features)** as in the JAX package; the
port's modules store torch's (out, in) and pass their transposed view, so
no copy is made. Products accumulate in fp32 and the bias is added in the
same call (fp32 arithmetic before the single rounding to the compute
dtype).

A quantized weight (ops/quant.py's ``QuantizedTensor`` or ``Int4Tensor``)
goes to its kernel wrapper (kernels/quant_matmul.py): on a CUDA tensor the
hand-written kernel, on the CPU its plain version, which is the JAX
package's arithmetic off the TPU. The port takes the kernel whenever it
is on CUDA, so the JAX package's ``quant_kernel`` policy knob
(``ops/policy.py``, off by default there, a choice measured for one TPU
generation) has no counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.geglu_ff import geglu_matmul_diff
from ..kernels.quant_matmul import quant_matmul, quant_matmul_int4
from .activations import geglu
from .quant import Int4Tensor, QuantizedTensor, is_quantized


def linear(
    x: torch.Tensor,
    w,
    b: Optional[torch.Tensor] = None,
    *,
    compute_dtype=None,
) -> torch.Tensor:
    """y = x @ w + b with w of shape (in, out): a tensor, a
    QuantizedTensor quantized per output channel, or an Int4Tensor packed
    along the input axis."""
    cd = compute_dtype or x.dtype
    if isinstance(w, Int4Tensor):
        return quant_matmul_int4(x.to(cd), w, b)
    if isinstance(w, QuantizedTensor):
        return quant_matmul(x.to(cd), w, b)
    return F.linear(x.to(cd), w.to(cd).t(), None if b is None else b.to(cd))


def geglu_linear(
    gx: torch.Tensor,
    gate: torch.Tensor,
    w,
    b: Optional[torch.Tensor] = None,
    *,
    compute_dtype=None,
) -> torch.Tensor:
    """The transformer FF tail: (gx * gelu_erf(gate)) @ w + b.

    With a dense weight on a CUDA tensor this is the hand-written GEGLU
    kernel (kernels/geglu_ff.py), which raises for a weight it cannot
    take, through its autograd Function (gradients to gx, gate, w and b). Otherwise (the CPU, or a quantized weight on any device) it is
    geglu + linear, as the JAX package computes it off the TPU.
    """
    if gx.is_cuda and not is_quantized(w):
        cd = compute_dtype or gx.dtype
        return geglu_matmul_diff(gx.to(cd), gate.to(cd), w.to(cd), b)
    return linear(geglu(gx, gate), w, b, compute_dtype=compute_dtype)
