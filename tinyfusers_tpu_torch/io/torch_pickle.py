"""Loader for PyTorch zip checkpoints (.ckpt / .pt / .pth) (port of
tinyfusers_tpu/io/torch_pickle.py).

The JAX package reads the zip and its pickle by hand; here ``torch.load``
does it with ``weights_only=True`` (its unpickler builds tensors,
containers and plain values and refuses every other global) and
``mmap=True`` (each storage stays in the page cache until it is used).
The JAX reader's rules are kept:

- dtypes and strides are the file's own;
- objects of pytorch-lightning and omegaconf classes (training-callback
  state in SD .ckpt files) load as inert placeholders, and any other
  global is refused;
- ``load_state_dict`` unwraps a top-level ``"state_dict"`` and keeps only
  the tensors.
"""
from __future__ import annotations

import os
import zipfile
from typing import Any, Dict

import torch


class _Opaque:
    """Stands in for a tolerated framework-metadata object."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        pass


def _tolerated(global_name: str) -> bool:
    module = global_name.rsplit(".", 1)[0]
    return "lightning" in module or module.startswith("omegaconf")


def load(path) -> Any:
    """Load a torch zip checkpoint on the CPU: its tensors, containers and
    plain values."""
    path = os.fspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    if not zipfile.is_zipfile(path):
        raise ValueError(f"not a torch zip checkpoint: {path}")
    inert = [(_Opaque, name)
             for name in torch.serialization.get_unsafe_globals_in_checkpoint(path)
             if _tolerated(name)]
    with torch.serialization.safe_globals(inert):
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def load_state_dict(path) -> Dict[str, torch.Tensor]:
    """The flat tensor dict; a top-level 'state_dict' (SD .ckpt layout) is
    unwrapped, and entries that are not tensors are dropped."""
    obj = load(path)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}
