"""Parameter-holding leaves of the port's models.

Each leaf holds one params dict of the JAX package's tree ({"weight",
"bias"}) in torch layout: linear weights (out, in), conv weights OIHW.
Their ``forward`` calls the ops with the JAX layout (the transposed views
of the stored weights, so no copy is made). Parameters are created empty
on the requested device and frozen (``set_trainable`` turns gradients on
for a fine-tune); ``init_weights`` fills a whole model from one seed on
that device (utils/init.py).

A Linear or Conv may hold a weight-only quantized weight instead
(``set_weight``, as io/quantize_tree.py and io/from_jax.py use it). It is
stored as buffers in the same torch layout, so ``.to()`` and
``state_dict`` carry it: ``weight_values`` and ``weight_scales`` for
int8 / fp8 (scales (out, 1) or (O, 1, 1, 1)), or ``weight_packed`` and
``weight_scales`` for int4, packed along the input axis ((out, in/2) and
(out, in/g), or (O, I/2, H, W) and (O, I/g, H, W)). ``w`` gives the
ops.quant container of those buffers in the JAX layout, as views.

Under tensor parallelism (parallel/sharding.py ``shard_params``) a Linear
holds this rank's slice and learns its role: a column-parallel one
(``tp_role == "column"``) passes its input through Megatron's *f*; a
row-parallel one computes its partial product, sums it over the model
group (*g*), then adds its whole bias once. Without a role ``forward`` is
what it was.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import ops
from ..parallel import tp
from ..ops.quant import Int4Tensor, QuantizedTensor
from ..utils import init as pinit

_QUANT_BUFFERS = ("weight_values", "weight_packed", "weight_scales")


class _WeightLeaf(nn.Module):
    """A leaf whose weight may be dense or quantized. Subclasses give the
    layout maps between torch's order and the JAX package's, and the JAX
    axis an int4 weight is packed along."""

    INT4_AXIS = 0

    @staticmethod
    def to_jax(t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def from_jax(t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def w(self):
        """The weight in the JAX layout, as views of what is stored: a
        tensor, a QuantizedTensor or an Int4Tensor."""
        if "weight" in self._parameters:
            return self.to_jax(self.weight)
        scales = self.to_jax(self.weight_scales)
        if "weight_packed" in self._buffers:
            k = 2 * self.weight_packed.shape[1]
            return Int4Tensor(self.to_jax(self.weight_packed), scales, axis=self.INT4_AXIS,
                              group_size=k // self.weight_scales.shape[1], orig_dim=k)
        return QuantizedTensor(self.to_jax(self.weight_values), scales)

    def set_weight(self, w) -> None:
        """Hold ``w``, a QuantizedTensor or Int4Tensor in the JAX layout of
        this leaf's weight, in place of the current weight, on this leaf's
        device. Raises ValueError when a shape of ``w`` does not fit."""
        shape = tuple(self.w.shape)
        if isinstance(w, Int4Tensor):
            ax, k, g = w.axis % w.ndim, w.orig_dim, w.group_size
            along = lambda n: shape[:ax] + (n,) + shape[ax + 1:]  # noqa: E731
            ok = (ax == self.INT4_AXIS and len(shape) == w.ndim and shape[ax] == k
                  and g > 0 and k % g == 0 and tuple(w.packed.shape) == along(k // 2)
                  and tuple(w.scales.shape) == along(k // g))
            tensors = {"weight_packed": w.packed, "weight_scales": w.scales}
        elif isinstance(w, QuantizedTensor):
            ok = (tuple(w.values.shape) == shape
                  and tuple(w.scales.shape) == (1,) * (len(shape) - 1) + shape[-1:])
            tensors = {"weight_values": w.values, "weight_scales": w.scales}
        else:
            raise TypeError(f"set_weight takes a quantized weight, not {type(w).__name__}")
        if not ok:
            got = ", ".join(f"{n[7:]} {tuple(t.shape)}" for n, t in tensors.items())
            axis = f" packed on axis {w.axis}" if isinstance(w, Int4Tensor) else ""
            raise ValueError(f"quantized weight shape ({got}{axis}) does not fit "
                             f"{shape}")
        dev = next(iter([*self.parameters(), *self.buffers()])).device
        if "weight" in self._parameters:
            del self.weight
        for name in _QUANT_BUFFERS:
            self._buffers.pop(name, None)
        for name, t in tensors.items():
            self.register_buffer(name, self.from_jax(t).to(dev).contiguous())

    def _apply(self, fn, recurse=True):
        """Device moves reach the quantized buffers; dtype casts do not
        (they would round the fp32 scales and turn fp8 values dense)."""
        held = {n: self._buffers.pop(n) for n in _QUANT_BUFFERS if n in self._buffers}
        super()._apply(fn, recurse)
        for name, t in held.items():
            self._buffers[name] = t.to(fn(torch.empty(0, device=t.device)).device)
        return self


class Linear(_WeightLeaf):
    tp_role = None   # None | "column" | "row" (parallel/sharding.py)
    tp_group = None  # the model axis's process group
    tp_halves = False  # the column slice taken from each half ([gx | gate])

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, **kw), requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(out_dim, **kw), requires_grad=False)
                     if bias else None)

    @staticmethod
    def to_jax(t: torch.Tensor) -> torch.Tensor:
        return t.t()  # (out, in) -> (in, out)

    from_jax = to_jax

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_role is None:
            return ops.linear(x, self.w, self.bias)
        if self.tp_role == "column":
            return ops.linear(tp.copy_to(x, self.tp_group), self.w, self.bias)
        return self._row_sum(ops.linear(x, self.w))

    def geglu(self, gx: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        """(gx * gelu_erf(gate)) @ w + b: the UNet FF's tail through the
        GEGLU kernel (ops.geglu_linear), gx and gate this rank's columns
        when the layer is row-parallel."""
        if self.tp_role is None:
            return ops.geglu_linear(gx, gate, self.w, self.bias)
        return self._row_sum(ops.geglu_linear(gx, gate, self.w))

    def _row_sum(self, partial: torch.Tensor) -> torch.Tensor:
        y = tp.reduce_from(partial, self.tp_group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ZeroLinear(Linear):
    """A Linear whose JAX init is all zeros: the adaLN-Zero modulation and
    the final projection of the transformer denoisers (models/mmdit.py,
    models/dit.py)."""


class Conv(_WeightLeaf):
    INT4_AXIS = 2  # HWIO input channels

    def __init__(self, in_ch: int, out_ch: int, k: int, bias: bool = True, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, **kw), requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(out_ch, **kw), requires_grad=False)
                     if bias else None)

    @staticmethod
    def to_jax(t: torch.Tensor) -> torch.Tensor:
        return t.permute(2, 3, 1, 0)  # OIHW -> HWIO

    @staticmethod
    def from_jax(t: torch.Tensor) -> torch.Tensor:
        return t.permute(3, 2, 0, 1)  # HWIO -> OIHW

    def forward(self, x: torch.Tensor, *, stride=1, padding=0) -> torch.Tensor:
        return ops.conv2d(x, self.w, self.bias, stride=stride, padding=padding)


class ZeroConv(Conv):
    """A Conv whose JAX init is all zeros: ControlNet's zero convs and the
    last conv of its hint encoder (models/controlnet.py)."""


class Norm(nn.Module):
    """Affine parameters of a layer norm or group norm."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(dim, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim, **kw), requires_grad=False)

    def layer(self, x: torch.Tensor) -> torch.Tensor:
        return ops.layer_norm(x, self.weight, self.bias)

    def group(self, x: torch.Tensor, num_groups: int, eps: float) -> torch.Tensor:
        return ops.group_norm(x, num_groups, self.weight, self.bias, eps=eps)


class Gain(nn.Module):
    """A norm's weight alone, no bias: RMSNorm gains (T5, the MMDiT's
    q/k norms)."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device, dtype=dtype),
                                   requires_grad=False)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim, device=device, dtype=dtype),
                                   requires_grad=False)


def stacked_index(model: nn.Module) -> dict:
    """id of each module inside a container that the JAX package stacks on
    a leading axis for ``lax.scan`` (named in a model's ``STACKED``: the
    MMDiT's and the DiT's ``blocks``, CLIP's and T5's ``layers``) -> the
    index of its block."""
    out = {}
    for mod in model.modules():
        for name in getattr(mod, "STACKED", ()):
            for i, block in enumerate(getattr(mod, name)):
                out.update((id(m), i) for m in block.modules())
    return out


def set_trainable(module: nn.Module, trainable: bool = True) -> nn.Module:
    """Turn gradients on (or off) for every floating-point parameter of
    ``module``: a full fine-tune's switch. Parameters are made frozen, so
    inference builds no autograd graph; quantized weights are buffers and
    stay frozen."""
    for p in module.parameters():
        if p.is_floating_point():
            p.requires_grad_(trainable)
    return module


def init_weights(model: nn.Module, seed: int) -> torch.Generator:
    """Fill every leaf of ``model`` with the JAX package's distributions,
    drawn by one torch.Generator on the model's device, and return that
    generator. A learned leaf outside these classes (the MMDiT's optional
    ``pos_embed``, the ViT's ``class_embedding``) is left as it is; a model
    whose JAX init draws one goes on drawing from the returned generator."""
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, ZeroLinear):
            pinit.zeros_(mod.weight, mod.bias)
        elif isinstance(mod, Linear):
            pinit.linear_(mod.weight, mod.bias, generator)
        elif isinstance(mod, ZeroConv):
            pinit.zeros_(mod.weight, mod.bias)
        elif isinstance(mod, Conv):
            pinit.conv_(mod.weight, mod.bias, generator)
        elif isinstance(mod, Norm):
            pinit.norm_(mod.weight, mod.bias)
        elif isinstance(mod, Gain):
            pinit.ones_(mod.weight)
        elif isinstance(mod, Embedding):
            pinit.embedding_(mod.weight, generator)
    return generator
