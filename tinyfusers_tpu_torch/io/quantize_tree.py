"""Quantize a model's matmul and conv weights in place, weight-only (port
of tinyfusers_tpu/io/quantize_tree.py).

The JAX package's rule, on the port's modules: every Linear or Conv
weight with at least ``_MIN_QUANT_SIZE`` elements (the JAX tree's
"weight" leaves of ndim 2 or 4) is quantized; norms, embeddings and
biases stay as they are. int8 and fp8 quantize per output channel
(axis -1 of the JAX layout); "int4" packs along the contraction axis (0
for (in, out) linears, 2 for HWIO convs) with per-group scales. The work
runs on the module's own device, and each leaf then holds its quantized
buffers (models/layers.py) in place of its weight.

Leaves that the JAX package stacks on a leading axis for ``lax.scan``
stay dense: their weights are 3-D (or 5-D) there, which its rule skips.
Each model names those containers in ``STACKED`` (the MMDiT's and the
DiT's ``blocks``, the CLIP towers' and T5's ``layers``), so a quantized
SD3-medium MMDiT holds 8 quantized leaves, 0.95% of its parameters, as
the JAX package's does.
"""
from __future__ import annotations

import copy
from typing import Union

import torch
from torch import nn

from ..models.layers import Conv, Linear, stacked_index
from ..ops.quant import is_quantized, quantize, quantize_int4

_MIN_QUANT_SIZE = 4096  # don't bother quantizing tiny tensors

# the tools' format names -> quantize_params's qdtype
QDTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "int4": "int4"}


def quantize_params(module: nn.Module, qdtype: Union[torch.dtype, str] = torch.int8, *,
                    group_size: int = 64) -> nn.Module:
    """Quantize ``module``'s eligible weights in place (qdtype torch.int8,
    torch.float8_e4m3fn, torch.float8_e5m2 or "int4"); returns ``module``."""
    stacked = stacked_index(module)
    for leaf in module.modules():
        if not isinstance(leaf, (Linear, Conv)) or id(leaf) in stacked:
            continue
        w = leaf.w
        if is_quantized(w) or w.numel() < _MIN_QUANT_SIZE:
            continue
        if qdtype == "int4":
            q = quantize_int4(w, axis=leaf.INT4_AXIS, group_size=group_size)
        else:
            q = quantize(w, qdtype, axis=-1)
        leaf.set_weight(q)
    return module


def quantized_copy(model: nn.Module, qdtype: Union[torch.dtype, str]) -> nn.Module:
    """A shallow copy of ``model`` (a pipeline model with a ``unet``) whose
    UNet is a quantized deep copy, every other module shared: the JAX
    tools' ``{**params, "unet": quantize_params(params["unet"], q)}``. The
    model given keeps its dense UNet."""
    q = copy.copy(model)
    q._modules = dict(model._modules)  # rebinding q.unet leaves the model's
    q.unet = quantize_params(copy.deepcopy(model.unet), qdtype)
    return q
