"""Seeded weights for a parameter list, made on the device.

One ``torch.Generator`` on the device, seeded with the run's seed, draws
every parameter as one standard-normal buffer in the served dtype; each
parameter is a view of it, scaled in place by its kind:

- ``w`` (linear and conv weights): std 1 / sqrt(fan_in), fan_in the
  product of the shape past the first axis;
- ``b`` (biases): std 0.02;
- ``nw`` / ``nb`` (norm gains and shifts): 1 + 0.05 N and 0.02 N;
- ``emb`` / ``pos`` (token and position embeddings): std 0.02 and 0.01.

Every leaf is non-zero, the adaLN modulations and output projections
that a zero init would leave empty included, and the scales keep every
activation near unit size through depth, as in a trained model.
The same seed on the same kind of device gives the same weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SCALE = {"b": 0.02, "nb": 0.02, "emb": 0.02, "pos": 0.01}


def make(spec: List[Tuple[str, tuple, str]], seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """name -> tensor (views of one buffer) for every (name, shape, kind)."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    with torch.no_grad():
        for (name, shape, kind), n in zip(spec, sizes):
            t = flat[off:off + n].view(shape)
            off += n
            if kind == "w":
                t.mul_(1.0 / math.sqrt(n // shape[0]))
            elif kind == "nw":
                t.mul_(0.05).add_(1.0)
            else:
                t.mul_(SCALE[kind])
            out[name] = t
    return out
