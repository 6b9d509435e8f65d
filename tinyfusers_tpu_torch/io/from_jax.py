"""Load the JAX package's param tree into the port's modules.

The tree is given as nested dicts and lists of numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives it, so this module needs no
jax. The port's modules are named after the tree's keys, so the walk is
mechanical: a dict key is an attribute, a list index a ModuleList index.
Leaves change layout on the way: linear weights (in, out) -> (out, in),
conv weights HWIO -> OIHW, and the per-layer leaves stacked on a leading
axis for ``lax.scan`` (the CLIP towers' and T5's layers, the MMDiT's and
the DiT's blocks) are split across the ModuleList.
Every parameter must be written exactly once and every shape must match.
The same walk (``load_params``) loads a UNet of any config (the
9-channel inpainting one and SDXL's too) and a ControlNet (``controlnet.init``'s
tree into a ``models.controlnet.ControlNet``).

A weight-only quantized tree, as ``jax.tree.map(np.asarray,
quantize_params(...))`` gives it, is taken as well. Its quantized leaves
are recognised by their attributes (``values`` and ``scales``, or
``packed``, ``scales``, ``axis``, ``group_size`` and ``orig_dim``), never
by the JAX package's classes, and become ops.quant containers held by
the Linear or Conv in its torch layout (models/layers.py). fp8 values
arrive as ml_dtypes arrays, which torch cannot take directly: they go
through their bytes (a uint8 view, then a float8_e4m3fn view).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.layers import Conv, Linear
from ..ops.quant import Int4Tensor, QuantizedTensor

# ml_dtypes float8 arrays by dtype name -> the torch dtype of their bytes
_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _tensor(value) -> torch.Tensor:
    value = np.asarray(value)
    name = value.dtype.name
    if name == "bfloat16":  # ml_dtypes: torch cannot view it
        return torch.tensor(value.astype(np.float32))
    if name in _FP8:
        return torch.tensor(value.view(np.uint8)).view(_FP8[name])
    return torch.tensor(value)


def _quantized(value):
    """The ops.quant container of a quantized JAX leaf, or None for a
    dense one."""
    if hasattr(value, "packed"):
        return Int4Tensor(_tensor(value.packed), _tensor(value.scales).float(),
                          axis=int(value.axis), group_size=int(value.group_size),
                          orig_dim=int(value.orig_dim))
    if hasattr(value, "values") and hasattr(value, "scales"):
        return QuantizedTensor(_tensor(value.values), _tensor(value.scales).float())
    return None


def _assign_quantized(module, q, where: str) -> None:
    if not isinstance(module, (Linear, Conv)):
        raise ValueError(f"{where}: a quantized weight for {type(module).__name__}")
    try:
        module.set_weight(q)
    except ValueError as e:
        raise ValueError(f"{where}: {e}") from None


def _assign(param: torch.Tensor, value: np.ndarray, where: str) -> None:
    t = _tensor(value)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{where}: shape {tuple(t.shape)} != {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(t.to(param.dtype))


def _load(module: nn.Module, tree, where: str, seen: set) -> None:
    if isinstance(module, nn.ModuleList):
        if isinstance(tree, dict):  # stacked per-layer leaves
            for i, sub in enumerate(module):
                _load(sub, _index(tree, i), f"{where}[{i}]", seen)
            return
        if len(tree) != len(module):
            raise ValueError(f"{where}: {len(tree)} entries for {len(module)} modules")
        for i, (sub, t) in enumerate(zip(module, tree)):
            _load(sub, t, f"{where}[{i}]", seen)
        return
    for key, value in tree.items():
        path = f"{where}.{key}" if where else key
        if not isinstance(value, (dict, list)):  # a leaf: weight, bias, pos_embed
            q = _quantized(value) if key == "weight" else None
            if q is not None:
                _assign_quantized(module, q, path)
                continue
            if isinstance(module, Linear) and key == "weight":
                value = np.swapaxes(value, -1, -2)
            elif isinstance(module, Conv) and key == "weight":
                value = np.transpose(value, (3, 2, 0, 1))
            param = getattr(module, key, None)
            if not isinstance(param, torch.Tensor):
                raise ValueError(f"{path}: the module has no {key}")
            _assign(param, value, path)
            seen.add(id(param))
            continue
        if not hasattr(module, key):
            raise ValueError(f"{path}: no counterpart in {type(module).__name__}")
        _load(getattr(module, key), value, path, seen)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def load_params(module: nn.Module, tree) -> None:
    """Write ``tree`` into ``module``'s parameters."""
    seen: set = set()
    _load(module, tree, "", seen)
    missing = [n for n, p in module.named_parameters() if id(p) not in seen]
    if missing:
        raise ValueError(f"parameters not in the tree: {missing[:8]}")


def load_sd(model: nn.Module, params) -> None:
    """Load a JAX ``sd.init`` tree ({'clip', 'unet', 'vae'}) into a
    ``pipeline.sd.StableDiffusion``."""
    load_params(model, params)


def load_sd3(model: nn.Module, params) -> None:
    """Load a JAX ``sd3.init`` tree ({'clip_l', 'clip_g', 'mmdit', 'vae'}
    and, with T5, 't5'; a learned 'mmdit.pos_embed' when the MMDiT holds
    one) into a ``pipeline.sd3.StableDiffusion3``."""
    load_params(model, params)


def load_sdxl(model: nn.Module, params) -> None:
    """Load a JAX ``sdxl.init`` tree ({'clip_l', 'clip_g', 'unet', 'vae'};
    the UNet's 'label_emb' included) into a
    ``pipeline.sdxl.StableDiffusionXL``."""
    load_params(model, params)


def load_dit(model: nn.Module, params) -> None:
    """Load a JAX ``dit.init`` tree (its stacked ``blocks`` split across the
    ModuleList; ``label_embed`` / ``cond_proj`` where the config has them)
    into a ``models.dit.DiT``."""
    load_params(model, params)


def load_clip_vision(model: nn.Module, params) -> None:
    """Load a JAX ``clip_vision.init`` tree (its stacked ``layers`` split
    across the ModuleList) into a ``models.clip_vision.CLIPVisionModel``."""
    load_params(model, params)
