"""Load the JAX package's param tree into the port's modules.

The tree is given as nested dicts and lists of numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives it, so this module needs no
jax. The port's modules are named after the tree's keys, so the walk is
mechanical: a dict key is an attribute, a list index a ModuleList index.
Leaves change layout on the way: linear weights (in, out) -> (out, in),
conv weights HWIO -> OIHW, and CLIP's per-layer leaves, stacked on a
leading axis for ``lax.scan``, are split across the ModuleList.
Every parameter must be written exactly once and every shape must match.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
from torch import nn

from ..models.layers import Conv, Linear


def _assign(param: torch.Tensor, value: np.ndarray, where: str) -> None:
    value = np.asarray(value)
    if value.dtype.name == "bfloat16":  # ml_dtypes: torch cannot view it
        value = value.astype(np.float32)
    t = torch.tensor(value)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{where}: shape {tuple(t.shape)} != {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(t.to(param.dtype))


def _load(module: nn.Module, tree, where: str, ignore: Iterable[str], seen: set) -> None:
    if isinstance(module, nn.ModuleList):
        if isinstance(tree, dict):  # stacked per-layer leaves
            for i, sub in enumerate(module):
                _load(sub, _index(tree, i), f"{where}[{i}]", ignore, seen)
            return
        if len(tree) != len(module):
            raise ValueError(f"{where}: {len(tree)} entries for {len(module)} modules")
        for i, (sub, t) in enumerate(zip(module, tree)):
            _load(sub, t, f"{where}[{i}]", ignore, seen)
        return
    for key, value in tree.items():
        path = f"{where}.{key}" if where else key
        if path in ignore:
            continue
        if key in ("weight", "bias") and not isinstance(value, (dict, list)):
            if isinstance(module, Linear) and key == "weight":
                value = np.swapaxes(value, -1, -2)
            elif isinstance(module, Conv) and key == "weight":
                value = np.transpose(value, (3, 2, 0, 1))
            param = getattr(module, key)
            if param is None:
                raise ValueError(f"{path}: the module has no {key}")
            _assign(param, value, path)
            seen.add(id(param))
            continue
        if not hasattr(module, key):
            raise ValueError(f"{path}: no counterpart in {type(module).__name__}")
        _load(getattr(module, key), value, path, ignore, seen)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def load_params(module: nn.Module, tree, *, ignore: Iterable[str] = ()) -> None:
    """Write ``tree`` into ``module``'s parameters. ``ignore`` lists dotted
    tree paths with no counterpart in the port yet (e.g. "vae.encoder")."""
    seen: set = set()
    _load(module, tree, "", set(ignore), seen)
    missing = [n for n, p in module.named_parameters() if id(p) not in seen]
    if missing:
        raise ValueError(f"parameters not in the tree: {missing[:8]}")


# The parts of the JAX SD tree that the port does not run yet.
SD_NOT_PORTED = ("vae.encoder", "vae.quant_conv")


def load_sd(model: nn.Module, params) -> None:
    """Load a JAX ``sd.init`` tree ({'clip', 'unet', 'vae'}) into a
    ``pipeline.sd.StableDiffusion``."""
    load_params(model, params, ignore=SD_NOT_PORTED)
