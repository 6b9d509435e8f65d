"""Parameter-holding leaves of the port's models.

Each leaf holds one params dict of the JAX package's tree ({"weight",
"bias"}) in torch layout: linear weights (out, in), conv weights OIHW.
Their ``forward`` calls the ops with the JAX layout (the transposed views
of the stored weights, so no copy is made). Parameters are created empty
on the requested device; ``init_weights`` fills a whole model from one
seed on that device (utils/init.py).
"""
from __future__ import annotations

import torch
from torch import nn

from .. import ops
from ..utils import init as pinit


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, **kw), requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(out_dim, **kw), requires_grad=False)
                     if bias else None)

    @property
    def w(self) -> torch.Tensor:
        """The weight in the JAX layout (in, out), as a view."""
        return self.weight.t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.linear(x, self.w, self.bias)


class Conv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, k: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(out_ch, **kw), requires_grad=False)

    def forward(self, x: torch.Tensor, *, stride=1, padding=0) -> torch.Tensor:
        return ops.conv2d(x, self.weight.permute(2, 3, 1, 0), self.bias,
                          stride=stride, padding=padding)


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


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim, device=device, dtype=dtype),
                                   requires_grad=False)


def init_weights(model: nn.Module, seed: int) -> None:
    """Fill every leaf of ``model`` with the JAX package's distributions,
    drawn by one torch.Generator on the model's device."""
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, Linear):
            pinit.linear_(mod.weight, mod.bias, generator)
        elif isinstance(mod, Conv):
            pinit.conv_(mod.weight, mod.bias, generator)
        elif isinstance(mod, Norm):
            pinit.norm_(mod.weight, mod.bias)
        elif isinstance(mod, Embedding):
            pinit.embedding_(mod.weight, generator)
