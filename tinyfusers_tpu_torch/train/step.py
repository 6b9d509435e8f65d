"""Train state and the train step (port of tinyfusers_tpu/train/step.py).

Params are a dict of tensors, name -> tensor, named as the model's own
parameters (which are the JAX param tree's paths joined by dots: the
port's modules mirror the tree) and held in the model's torch layout;
``params_of`` takes them from a module in the JAX tree's leaf order, so
that sums over leaves run in optax's order. A step differentiates
``apply_fn(params, x_t, t, *cond)``, the model run on those tensors with
``torch.func.functional_call`` (``module_apply``): the model's own
parameters stay untouched. ``param_layouts`` gives each linear and conv
weight's map to the JAX layout, for checkpoints and Adafactor.

remat wraps apply_fn in ``torch.utils.checkpoint`` (non-reentrant) with a
selective policy, the counterpart of JAX's
``dots_with_no_batch_dims_saveable``: plain matrix products' outputs are
saved and everything else (the attention's batched products, convs,
norms, the flash and GEGLU kernels) is recomputed in the backward, so each
kernel launches twice a step. JAX's buffer donation has no counterpart:
the old and the new state live together through a step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.layers import Conv, Linear
from ..pipeline import samplers
from . import losses, optim

Params = Dict[str, torch.Tensor]


def jax_order(names):
    """``names`` (dotted tree paths) in JAX's leaf order: dict keys sorted as
    strings, list indices as numbers."""
    return sorted(names, key=lambda n: tuple((0, int(p)) if p.isdigit() else (1, p)
                                             for p in n.split(".")))


def params_of(module: nn.Module, *, trainable_only: bool = False) -> Params:
    """The module's floating-point parameters (with ``trainable_only``, those
    that require grad: ``models.layers.set_trainable``), detached, in JAX's
    leaf order."""
    named = {n: p.detach() for n, p in module.named_parameters()
             if p.is_floating_point() and (p.requires_grad or not trainable_only)}
    return {n: named[n] for n in jax_order(named)}


def param_layouts(module: nn.Module) -> Dict[str, type]:
    """name -> the leaf's class (Linear or Conv: its static ``to_jax`` /
    ``from_jax`` map the weight between the port's layout and the JAX
    package's) for every linear and conv weight of ``module``."""
    return {f"{mname}.weight" if mname else "weight": type(mod)
            for mname, mod in module.named_modules()
            if isinstance(mod, (Linear, Conv)) and "weight" in mod._parameters}


def module_apply(module: nn.Module) -> Callable[..., torch.Tensor]:
    """apply_fn(params, *args): ``module(*args)`` run on ``params`` in place
    of its own parameters (those not in ``params`` stay the module's)."""
    def apply_fn(params: Params, *args):
        return torch.func.functional_call(module, params, args, strict=False)

    return apply_fn


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: Any
    ema_params: Optional[Params] = None   # fp32 copies; None when EMA is off

    @classmethod
    def create(cls, params: Params, optimizer: optim.GradientTransformation,
               ema: bool = False) -> "TrainState":
        return cls(step=0, params=dict(params), opt_state=optimizer.init(params),
                   ema_params={k: p.float().clone() for k, p in params.items()}
                   if ema else None)


def default_optimizer(learning_rate: float = 1e-4, *, weight_decay: float = 1e-2,
                      b1: float = 0.9, b2: float = 0.999,
                      grad_clip: Optional[float] = 1.0,
                      warmup_steps: int = 0) -> optim.GradientTransformation:
    """AdamW with global-norm clipping and linear warmup: the standard
    diffusion fine-tune recipe."""
    lr = (optim.linear_schedule(0.0, learning_rate, warmup_steps) if warmup_steps
          else learning_rate)
    parts = []
    if grad_clip is not None:
        parts.append(optim.clip_by_global_norm(grad_clip))
    parts.append(optim.adamw(lr, b1=b1, b2=b2, weight_decay=weight_decay))
    return optim.chain(*parts)


def rematerialized(apply_fn: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """apply_fn under activation checkpointing that keeps plain matrix
    products' outputs and recomputes the rest in the backward."""
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)

    saved = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    def wrapped(*args):
        return checkpoint(apply_fn, *args, use_reentrant=False,
                          context_fn=lambda: create_selective_checkpoint_contexts(policy))

    return wrapped


def diffusion_objective(apply_fn, loss_cfg: losses.LossConfig, params: Params,
                        x0: torch.Tensor, cond, generator: torch.Generator) -> torch.Tensor:
    """The step's loss: t, then the noise, drawn from ``generator``; x_t in
    x0's dtype into the model; the weighted fp32 MSE."""
    t = losses.sample_timesteps(generator, x0.shape[0], loss_cfg, device=x0.device)
    noise = samplers._normal(generator, x0)
    x_t, target = losses.q_sample(x0, noise, t, loss_cfg)
    pred = apply_fn(params, x_t.to(x0.dtype), t, *cond)
    return losses.diffusion_loss(pred, target, losses.loss_weights(t, loss_cfg))


def value_and_grad(fn, params: Params):
    """(fn(leaves), {name: d fn / d leaf}) over detached copies of params."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with torch.enable_grad():
        value = fn(leaves)
        grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))


def ema_update(ema: Params, params: Params, decay: float) -> Params:
    """e * d + p * (1 - d) in fp32, d = fp32(decay)."""
    d = np.float32(decay)
    keep, fresh = float(d), float(np.float32(1) - d)
    keys = list(ema)
    new = torch._foreach_add(torch._foreach_mul([ema[k] for k in keys], keep),
                             torch._foreach_mul([params[k].float() for k in keys], fresh))
    return dict(zip(keys, new))


def make_train_step(apply_fn: Callable[..., torch.Tensor],
                    optimizer: optim.GradientTransformation,
                    loss_cfg: losses.LossConfig = losses.LossConfig(), *,
                    ema_decay: Optional[float] = None, remat: bool = False):
    """``step(state, batch, generator) -> (state, {"loss", "grad_norm"})``.

    apply_fn(params, x_t, t, *cond) -> prediction; ``batch`` is (x0, *cond),
    batch leading. In the JAX step's order: the loss and its gradients, the
    optimizer's update on them, the new params, the fp32 EMA of the new
    params. loss is a 0-d tensor on the batch's device, grad_norm
    (optax.global_norm of the raw gradients) a 0-d CPU tensor."""
    if remat:
        apply_fn = rematerialized(apply_fn)

    def step(state: TrainState, batch, generator: torch.Generator):
        x0, *cond = batch
        loss, grads = value_and_grad(
            lambda p: diffusion_objective(apply_fn, loss_cfg, p, x0, cond, generator),
            state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optim.apply_updates(state.params, updates)
        ema = state.ema_params
        if ema is not None:
            ema = ema_update(ema, params, ema_decay if ema_decay is not None else 0.9999)
        metrics = {"loss": loss, "grad_norm": optim.global_norm(grads)}
        return TrainState(state.step + 1, params, opt_state, ema), metrics

    return step
