"""LoRA fine-tuning: low-rank adapters trained over a frozen base (port of
tinyfusers_tpu/train/lora.py).

The adapters are the trainable tree, a dict keyed as the JAX adapter
tree flattens: ``<weight's path>.a`` (..., in, r) and ``<weight's
path>.b`` (..., r, out), in the JAX layout. The base params stay a frozen
argument (bf16 or quantized), so the optimizer state is O(rank). Each
step merges W + scale * a @ b into the weights it runs on (``merge``,
with JAX's single rounding to W's dtype) and runs the model on them
through ``functional_call``: no merged copy of the model is kept.
"""
from __future__ import annotations

from typing import Callable, FrozenSet

import torch

from . import losses, optim
from .step import (Params, TrainState, diffusion_objective, jax_order, rematerialized,
                   value_and_grad)

# Attention + FF projections, the standard LoRA target set for SD UNets
# and DiT / MMDiT trunks (the module names io/lora.py maps).
DEFAULT_TARGETS: FrozenSet[str] = frozenset(
    {"to_q", "to_k", "to_v", "to_out", "qkv",
     "q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"}
)


def _is_target(name: str, p: torch.Tensor, targets) -> bool:
    parts = name.split(".")
    # plain 2-D matmul weights, or stacked (L, in, out) ones
    return len(parts) >= 2 and parts[-1] == "weight" and parts[-2] in targets \
        and p.dim() in (2, 3)


def init_lora(generator: torch.Generator, params: Params, rank: int = 8,
              targets: FrozenSet[str] = DEFAULT_TARGETS,
              dtype: torch.dtype = torch.float32) -> Params:
    """Adapters for every targeted weight of ``params`` (torch layout, so a
    linear weight is (out, in)): a ~ N(0, 1) / rank of shape (in, r), drawn
    from ``generator`` in JAX's leaf order, and b = 0 of shape (r, out), so
    the initial delta is zero."""
    out = {}
    for name in jax_order([n for n, p in params.items() if _is_target(n, p, targets)]):
        p = params[name]
        *stack, fan_out, fan_in = p.shape
        dev = p.device
        a = torch.randn((*stack, fan_in, rank), generator=generator, device=dev,
                        dtype=torch.float32).to(dtype) * (1.0 / rank)
        out[f"{name}.a"] = a
        out[f"{name}.b"] = torch.zeros((*stack, rank, fan_out), dtype=dtype, device=dev)
    return out


def merge(params: Params, lora: Params, scale: float = 1.0) -> Params:
    """params with W + scale * (a @ b) at every adapted weight: the sum in
    fp32, rounded once to W's dtype (W is (out, in), the delta (in, out))."""
    out = dict(params)
    for key in lora:
        if not key.endswith(".a"):
            continue
        name = key[:-2]
        w = params[name]
        delta = torch.matmul(lora[key], lora[f"{name}.b"]).float().transpose(-1, -2)
        out[name] = (w.float() + scale * delta).to(w.dtype)
    return out


def make_lora_train_step(apply_fn: Callable[..., torch.Tensor],
                         optimizer: optim.GradientTransformation,
                         loss_cfg: losses.LossConfig = losses.LossConfig(), *,
                         scale: float = 1.0, remat: bool = False):
    """``step(state, base_params, batch, generator) -> (state, metrics)``:
    ``state.params`` is the adapter dict (init_lora); base_params stay
    frozen and only the adapters get gradients."""
    if remat:
        apply_fn = rematerialized(apply_fn)

    def step(state: TrainState, base_params: Params, batch,
             generator: torch.Generator):
        x0, *cond = batch
        loss, grads = value_and_grad(
            lambda lora: diffusion_objective(apply_fn, loss_cfg,
                                             merge(base_params, lora, scale), x0, cond,
                                             generator),
            state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        lora = optim.apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": optim.global_norm(grads)}
        return TrainState(state.step + 1, lora, opt_state, None), metrics

    return step
