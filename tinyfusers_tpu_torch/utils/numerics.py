"""Numerics checking (port of tinyfusers_tpu/utils/numerics.py).

debug_nans traps the first torch operation whose floating-point result is
not finite and names it (the counterpart of jax_debug_nans); checked(fn)
records it instead and returns it beside fn's output (the counterpart of
checkify's float checks); tree_finite_report counts the non-finite
values of every floating tensor of a module or a nested dict.
Both traps synchronise with the device after every operation: they are
for debugging, not for the serving path.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode, resolve_name


def _outputs(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _outputs(v)


class _NonFinite(TorchFunctionMode):
    """Checks the floating outputs of every torch call made inside it; the
    first non-finite one is kept in ``error`` (and raised with ``trap``)."""

    def __init__(self, trap: bool):
        super().__init__()
        self.trap = trap
        self.error: Optional[str] = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.error is None:
            for t in _outputs(out):
                if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                    name = resolve_name(func) or getattr(func, "__name__", repr(func))
                    self.error = (f"non-finite value in the result of {name} "
                                  f"(shape {tuple(t.shape)}, {t.dtype})")
                    if self.trap:
                        raise FloatingPointError(self.error)
                    break
        return out


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Raise FloatingPointError, naming the operation, at the first torch
    call inside the scope whose floating result holds a NaN or an inf."""
    if not enabled:
        yield
        return
    with _NonFinite(trap=True):
        yield


class CheckError:
    """What checked() found: get() is the message or None; throw() raises
    FloatingPointError with it when there is one."""

    def __init__(self, msg: Optional[str]):
        self._msg = msg

    def get(self) -> Optional[str]:
        return self._msg

    def throw(self) -> None:
        if self._msg is not None:
            raise FloatingPointError(self._msg)


def checked(fn):
    """fn -> a function returning (err, fn's output): err.throw() raises,
    naming the first operation whose floating result was not finite."""
    def run(*args, **kwargs):
        mode = _NonFinite(trap=False)
        with mode:
            out = fn(*args, **kwargs)
        return CheckError(mode.error), out

    return run


def _leaves(tree, path=""):
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}" if path else str(i))
    else:
        yield path, tree


def tree_finite_report(tree) -> Tuple[bool, dict]:
    """(all_finite, {dotted path: count of NaN / inf values}) over the
    floating tensors of a module's state_dict or of nested dicts / lists."""
    bad = {}
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            n = int((~torch.isfinite(leaf)).sum())
            if n:
                bad[path] = n
    return not bad, bad
