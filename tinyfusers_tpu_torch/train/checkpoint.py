"""Train-state checkpoints: a whole TrainState (step, params, optimizer
state, EMA) as one safetensors file (port of
tinyfusers_tpu/train/checkpoint.py), through the port's safetensors_io.

The file is the JAX package's: keys are the state's tree paths joined by
dots (``step``, ``params.<path>``, ``opt.<path>``, ``ema.<path>``), where a
NamedTuple field adds ``.<field>`` as JAX names it (``opt.1.0..mu.<path>``),
and every linear and conv weight, and each optimizer leaf of a weight's
shape, is stored in the JAX layout ((in, out), HWIO) given by
``layouts`` (``train.step.param_layouts`` of the model; adapters need
none). So each package resumes from the other's file.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..io import safetensors_io
from .step import TrainState


def _names(obj):
    """(child name, child) of a dict, a NamedTuple (``.field``) or a tuple."""
    if isinstance(obj, dict):
        return list(obj.items())
    if hasattr(obj, "_fields"):
        return [(f".{f}", getattr(obj, f)) for f in obj._fields]
    return [(str(i), v) for i, v in enumerate(obj)]


def _to_jax(name: str, t: torch.Tensor, shapes, layouts) -> torch.Tensor:
    lay = layouts.get(name)
    if lay is not None and tuple(t.shape) == shapes.get(name):
        return lay.to_jax(t).contiguous()
    return t


def _flatten(tree, prefix: str, shapes, layouts, out: Dict[str, torch.Tensor]) -> None:
    for name, child in _names(tree):
        key = f"{prefix}.{name}"
        if isinstance(child, torch.Tensor):
            out[key] = _to_jax(name, child, shapes, layouts)
        else:
            _flatten(child, key, shapes, layouts, out)


def _rebuild(template, prefix: str, flat: Mapping[str, torch.Tensor], shapes, layouts):
    def leaf(name: str, key: str, t: torch.Tensor) -> torch.Tensor:
        arr = flat[key]
        if arr.numel() != t.numel():
            raise ValueError(f"checkpoint/state shape mismatch at {key}: "
                             f"{tuple(arr.shape)} vs {tuple(t.shape)}")
        lay = layouts.get(name)
        if lay is not None and tuple(t.shape) == shapes.get(name):
            arr = lay.from_jax(arr.reshape(tuple(lay.to_jax(t).shape)))
        # a copy: what the file gave is a view of its map
        return arr.to(device=t.device, dtype=t.dtype).reshape(t.shape).clone(
            memory_format=torch.contiguous_format)

    items = []
    for name, child in _names(template):
        key = f"{prefix}.{name}"
        items.append((name, leaf(name, key, child) if isinstance(child, torch.Tensor)
                      else _rebuild(child, key, flat, shapes, layouts)))
    if isinstance(template, dict):
        return dict(items)
    if hasattr(template, "_fields"):
        return type(template)(*[v for _, v in items])
    return type(template)(v for _, v in items)


def _shapes(state: TrainState):
    return {k: tuple(p.shape) for k, p in state.params.items()}


def save_train_state(state: TrainState, path, layouts: Optional[Mapping[str, Any]] = None) -> None:
    layouts = layouts or {}
    shapes = _shapes(state)
    flat: Dict[str, Any] = {"step": np.asarray(state.step, np.int32)}
    for prefix, tree in (("params", state.params), ("opt", state.opt_state),
                         ("ema", state.ema_params)):
        if tree is not None:
            _flatten(tree, prefix, shapes, layouts, flat)
    safetensors_io.save_state_dict(flat, path)


def load_train_state(template: TrainState, path,
                     layouts: Optional[Mapping[str, Any]] = None) -> TrainState:
    """Restore into the structure, dtypes and devices of ``template``: build
    it as at save time (TrainState.create with the same params and
    optimizer), then load."""
    layouts = layouts or {}
    shapes = _shapes(template)
    flat = safetensors_io.load_state_dict(path)
    ema = template.ema_params
    return TrainState(
        step=int(flat["step"]),
        params=_rebuild(template.params, "params", flat, shapes, layouts),
        opt_state=_rebuild(template.opt_state, "opt", flat, shapes, layouts),
        ema_params=None if ema is None else _rebuild(ema, "ema", flat, shapes, layouts),
    )
