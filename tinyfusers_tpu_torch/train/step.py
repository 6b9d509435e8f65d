"""Train state and the train step (port of tinyfusers_tpu/train/step.py).

Params are a dict of tensors, name -> tensor, named as the model's own
parameters (which are the JAX param tree's paths joined by dots: the
port's modules mirror the tree) and held in the model's torch layout;
``params_of`` takes them from a module in the JAX tree's leaf order, so
that sums over leaves run in optax's order. A step differentiates
``apply_fn(params, x_t, t, *cond)``, the model run on those tensors with
``torch.func.functional_call`` (``module_apply``): the model's own
parameters stay untouched. ``param_layouts`` gives each linear and conv
weight's map to the JAX layout and each stacked block's place in its
stack, for checkpoints and Adafactor.

remat wraps apply_fn in ``torch.utils.checkpoint`` (non-reentrant) with a
selective policy, the counterpart of JAX's
``dots_with_no_batch_dims_saveable``: plain matrix products' outputs are
saved and everything else (the attention's batched products, convs,
norms, the flash and GEGLU kernels) is recomputed in the backward, so each
kernel launches twice a step. JAX's buffer donation has no counterpart:
the old and the new state live together through a step.

On a mesh (parallel/) the step computes what the dense step computes on
the global batch, the sum of every rank's rows. Each data rank draws the
global batch's t and noise and keeps its own rows; the loss and the
gradients are means over the data group. A state sharded by
``parallel.shard_fsdp`` carries its placements: the data-split leaves are
gathered before the forward and each rank keeps its slice of the averaged
gradients. Tensor-parallel leaves (``parallel.shard_params`` on the
model) are this rank's slices throughout; the layers' collectives give
every rank of a model group the same gradients for replicated leaves. The
global norm sums over the shards (``optim.sharded``). The mesh is the one
the state's placements carry (``parallel.sharding_tree``), and a model
with tensor-parallel layers needs them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..models.layers import Conv, Linear
from ..parallel import tp
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis, mesh_device
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


class Leaf(NamedTuple):
    """How a parameter maps to its leaf in the JAX package's tree. ``cls``:
    the layer class (models.layers.Linear / Conv) whose static ``to_jax`` /
    ``from_jax`` map a linear or conv weight between the port's layout and
    the JAX package's; None: the same layout. ``stack``: for a block of a
    container the JAX package stacks on a leading axis (a model's
    ``STACKED``), (the JAX leaf's path, the block's index, blocks)."""
    cls: Optional[type] = None
    stack: Optional[tuple] = None

    def to_jax(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.cls is None else self.cls.to_jax(t)

    def from_jax(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.cls is None else self.cls.from_jax(t)


def param_layouts(module: nn.Module) -> Dict[str, Leaf]:
    """name -> Leaf of every linear and conv weight of ``module`` and of
    every parameter in a block the JAX package stacks: what checkpoints
    and Adafactor need to see each leaf as the JAX package holds it."""
    out = {f"{mname}.weight" if mname else "weight": Leaf(type(mod))
           for mname, mod in module.named_modules()
           if isinstance(mod, (Linear, Conv)) and "weight" in mod._parameters}
    for mname, mod in module.named_modules():
        for cname in getattr(mod, "STACKED", ()):
            blocks = getattr(mod, cname)
            base = f"{mname}.{cname}" if mname else cname
            for i, block in enumerate(blocks):
                for pname, _ in block.named_parameters():
                    name = f"{base}.{i}.{pname}"
                    out[name] = Leaf(out.get(name, Leaf()).cls,
                                     (f"{base}.{pname}", i, len(blocks)))
    return out


def module_apply(module: nn.Module) -> Callable[..., torch.Tensor]:
    """apply_fn(params, *args): ``module(*args)`` run on ``params`` in place
    of its own parameters (those not in ``params`` stay the module's)."""
    def apply_fn(params: Params, *args):
        return torch.func.functional_call(module, params, args, strict=False)

    apply_fn.module = module  # make_train_step checks its tensor-parallel layers
    return apply_fn


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: Any
    ema_params: Optional[Params] = None   # fp32 copies; None when EMA is off
    # name -> parallel.Placement on a mesh (parallel.sharding_tree, shard_fsdp)
    placements: Optional[Dict[str, Any]] = None

    @classmethod
    def create(cls, params: Params, optimizer: optim.GradientTransformation,
               ema: bool = False, placements: Optional[Dict[str, Any]] = None) -> "TrainState":
        """The state at step 0; with placements the optimizer's state is
        made for the leaves they split (Adafactor's factoring and statistics
        sized by the whole leaves)."""
        with _sharded(placements):
            opt_state = optimizer.init(params)
        return cls(step=0, params=dict(params), opt_state=opt_state,
                   ema_params={k: p.float().clone() for k, p in params.items()}
                   if ema else None, placements=placements)


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
                        x0: torch.Tensor, cond, generator: torch.Generator,
                        rows=(0, 1)) -> torch.Tensor:
    """The step's loss: t, then the noise, drawn from ``generator``; x_t in
    x0's dtype into the model; the weighted fp32 MSE. rows (r, n): x0 is
    part r of n equal parts of a global batch, whose t and noise are drawn
    and part r of them kept."""
    r, n = rows
    b = x0.shape[0]
    t = losses.sample_timesteps(generator, b * n, loss_cfg, device=x0.device)
    noise = samplers._normal(generator, x0 if n == 1 else x0.new_empty((b * n, *x0.shape[1:])))
    if n > 1:
        t, noise = t[r * b:(r + 1) * b], noise[r * b:(r + 1) * b]
    x_t, target = losses.q_sample(x0, noise, t, loss_cfg)
    pred = apply_fn(params, x_t.to(x0.dtype), t, *cond)
    return losses.diffusion_loss(pred, target, losses.loss_weights(t, loss_cfg))


def value_and_grad(fn, params: Params):
    """(fn(leaves), {name: d fn / d leaf}) over detached copies of params; a
    leaf fn does not reach (the last MMDiT block's text-stream tail) gets
    zeros, as jax.grad gives it."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with torch.enable_grad():
        value = fn(leaves)
        grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True,
                                    materialize_grads=True)
    return value.detach(), dict(zip(leaves, grads))


def ema_update(ema: Params, params: Params, decay: float) -> Params:
    """e * d + p * (1 - d) in fp32, d = fp32(decay)."""
    d = np.float32(decay)
    keep, fresh = float(d), float(np.float32(1) - d)
    keys = list(ema)
    new = torch._foreach_add(torch._foreach_mul([ema[k] for k in keys], keep),
                             torch._foreach_mul([params[k].float() for k in keys], fresh))
    return dict(zip(keys, new))


class _Shards:
    """A sharded state's leaves for ``optim.sharded``, from their
    placements: each leaf's splits over the model and data axes, and its
    sums of squares over the whole leaf, for which each rank adds the
    leaves whose copy it owns (rank 0 of every mesh axis a leaf is whole
    over) and one all-reduce over the world sums them."""

    def __init__(self, placements: Dict[str, Any], mesh):
        self.placements = placements
        self.mesh = mesh
        self.model, self.data = axis(mesh, MODEL_AXIS), axis(mesh, DATA_AXIS)

    def splits(self, name) -> tuple:
        pl = self.placements.get(name)
        if pl is None:
            return ()
        return tuple(optim.Split(dim, n, group)
                     for dim, (n, _, group) in ((pl.model_dim, self.model),
                                                (pl.data_dim, self.data))
                     if dim is not None)

    def _owned(self, name) -> bool:
        pl = self.placements.get(name)
        return ((self.model[1] == 0 or (pl is not None and pl.model_dim is not None))
                and (self.data[1] == 0 or (pl is not None and pl.data_dim is not None)))

    def totals(self, sums: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = list(sums)
        owned = torch.stack([sums[k].float() if self._owned(k) else torch.zeros(
            (), device=sums[k].device) for k in keys])
        out = owned.to(mesh_device(self.mesh))
        torch.distributed.all_reduce(out)
        out = out.to(owned.device)
        return {k: out[i] for i, k in enumerate(keys)}

    def total(self, sums: Dict[str, torch.Tensor]) -> torch.Tensor:
        total = torch.zeros((), dtype=next(iter(sums.values())).dtype)
        for k, s in sums.items():
            if self._owned(k):
                total = total + s
        out = total.float().to(mesh_device(self.mesh))
        torch.distributed.all_reduce(out)
        return out.cpu().to(total.dtype)


def _sharded(placements: Optional[Dict[str, Any]]):
    """optim.sharded over the placements' mesh; nothing without them."""
    if not placements:
        return contextlib.nullcontext()
    return optim.sharded(_Shards(placements, next(iter(placements.values())).mesh))


def _mean_over_data(grads: Params, group, n: int) -> Params:
    """Every gradient averaged over the data group: one all-reduce of each
    dtype's gradients flattened together."""
    if n == 1:
        return grads
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    out = dict(grads)
    by_dtype: Dict[torch.dtype, list] = {}
    for k, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = tp.mean_over(_flatten_dense_tensors([grads[k] for k in keys]), group, n)
        out.update(zip(keys, _unflatten_dense_tensors(flat, [grads[k] for k in keys])))
    return out


def make_train_step(apply_fn: Callable[..., torch.Tensor],
                    optimizer: optim.GradientTransformation,
                    loss_cfg: losses.LossConfig = losses.LossConfig(), *,
                    ema_decay: Optional[float] = None, remat: bool = False):
    """``step(state, batch, generator) -> (state, {"loss", "grad_norm"})``.

    apply_fn(params, x_t, t, *cond) -> prediction; ``batch`` is (x0, *cond),
    batch leading. In the JAX step's order: the loss and its gradients, the
    optimizer's update on them, the new params, the fp32 EMA of the new
    params. loss is a 0-d tensor on the batch's device, grad_norm
    (optax.global_norm of the raw gradients) a 0-d CPU tensor.

    A state with placements (``parallel.sharding_tree`` / ``shard_fsdp``)
    gives a sharded step on their mesh: batch is this rank's rows
    (train.data.shard_batch), every rank's generator in the same state;
    loss and grad_norm are the global batch's. A model that
    ``parallel.shard_params`` split needs them: its step raises without."""
    module = getattr(apply_fn, "module", None)
    if remat:
        apply_fn = rematerialized(apply_fn)

    def step(state: TrainState, batch, generator: torch.Generator):
        pls = state.placements or {}
        if not pls and module is not None and any(
                getattr(m, "tp_role", None) for m in module.modules()):
            raise ValueError("make_train_step: the model's layers are tensor-parallel but the "
                             "state has no placements; create it with "
                             "placements=parallel.sharding_tree(model, mesh)")
        on = next(iter(pls.values())).mesh if pls else None
        n, r, group = axis(on, DATA_AXIS)  # (1, 0, None) without a mesh
        x0, *cond = batch
        split = {k: pls[k].data_dim for k in state.params
                 if k in pls and pls[k].data_dim is not None}
        whole = {k: tp.all_gather(p, group, dim=split[k]) if k in split else p
                 for k, p in state.params.items()}
        loss, grads = value_and_grad(
            lambda p: diffusion_objective(apply_fn, loss_cfg, p, x0, cond, generator,
                                          rows=(r, n)), whole)
        grads = _mean_over_data(grads, group, n)
        grads = {k: tp.rank_slice(g, split[k], r, n).contiguous() if k in split else g
                 for k, g in grads.items()}
        with _sharded(pls):
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
            grad_norm = optim.global_norm(grads)
        params = optim.apply_updates(state.params, updates)
        ema = state.ema_params
        if ema is not None:
            ema = ema_update(ema, params, ema_decay if ema_decay is not None else 0.9999)
        metrics = {"loss": tp.mean_over(loss, group, n), "grad_norm": grad_norm}
        return TrainState(state.step + 1, params, opt_state, ema, state.placements), metrics

    return step
