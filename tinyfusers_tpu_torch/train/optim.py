"""Functional optimizers: the port's own copy of what the JAX package's
training takes from optax (``train/step.py``'s default recipe and the
training CLIs' choices), computing what optax 0.2.6 computes.

``torch.optim`` computes other things (AdamW's decay folded into the
parameter, clip_grad_norm_'s 1e-6 and unconditional scale, float scalars
kept in fp32 inside a bf16 op), so these are written out. A tree is a
dict of tensors (name -> tensor); a ``GradientTransformation`` is an
``(init, update)`` pair as in optax, and states are tuples and
NamedTuples shaped as optax's, so that ``train/checkpoint.py`` flattens
them to optax's keys (``opt.1.0..mu.<path>``). The step count lives on
the host (an int32 CPU tensor), so the bias corrections and schedules
are host scalars.

Arithmetic, op for op as optax's: every Python float meets a tensor
rounded to the tensor's dtype first (JAX's weak typing:
``ops.rounded_to``), each op rounds to its dtype, mixed dtypes promote as
in JAX. The elementwise work runs as ``torch._foreach_*`` ops over the
leaves of one dtype (a few launches for hundreds of tensors), each of
which rounds as the single op it stands for.

Sharded train states (parallel/sharding.py): inside ``sharded(leaves)``
the trees hold this rank's slices. Elementwise transformations (Adam,
SGD, weight decay, schedules, the EMA) need nothing more; ``global_norm``
(and so ``clip_by_global_norm``) sums the squares over the shards through
``leaves.total``, each replicated leaf counted once. Adafactor's
statistics are those of the whole leaves, as optax computes them under
GSPMD: the factored dims are chosen on a leaf's global shape, each row or
column mean is a local sum, an all-reduce over the group that splits the
dim it runs over and a division by the global size, and the block RMS of
the clip and the parameter scale sums the squares over every group the
leaf is split over (``leaves.totals``). Each statistic is held as this
rank computes it: split with its leaf over each group that splits an
axis it keeps, whole (the same on every rank of the group) where its
mean ran over the split axis.

Leaves the JAX package stacks on a leading axis for ``lax.scan`` (the
MMDiT's and DiT's blocks) are one leaf each per block here; their
layouts (train.step.param_layouts) carry the stack, and the block RMS
then runs over the whole stack, as optax's over the stacked leaf.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from ..ops.activations import rounded_to

Tree = Dict[str, torch.Tensor]
# name -> its leaf's layout (train.step.Leaf, or a class with static to_jax /
# from_jax: models.layers.Linear / Conv)
Layouts = Dict[str, Any]


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Any]


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Tree
    nu: Tree


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class TraceState(NamedTuple):
    trace: Tree


class FactoredState(NamedTuple):
    count: torch.Tensor
    v_row: Tree
    v_col: Tree
    v: Tree


# -- sharded trees --------------------------------------------------------------

_SHARDED: contextvars.ContextVar = contextvars.ContextVar("sharded_leaves", default=None)


class Split(NamedTuple):
    """A leaf's storage dim ``dim`` split into ``parts`` over ``group``
    (whichever slice of it a rank holds: each statistic is a sum)."""
    dim: int
    parts: int
    group: Any


@contextlib.contextmanager
def sharded(leaves):
    """Run transformations on trees of shards. ``leaves`` has
    ``total(sums)``: {name: this rank's 0-d sum of squares} -> the 0-d sum
    over the whole leaves; ``totals(sums)``: the same, leaf by leaf (one
    0-d fp32 sum over the whole of each leaf); and ``splits(name)``: the
    leaf's Splits."""
    token = _SHARDED.set(leaves)
    try:
        yield
    finally:
        _SHARDED.reset(token)


def _view_dims(view, ndim: int) -> list:
    """storage dim -> the dim of ``view(t)`` it lands on, for a view that
    permutes dims (a layout's to_jax)."""
    sizes = [2, 3, 5, 7, 11, 13, 17, 19][:ndim]
    got = list(view(torch.empty(sizes, device="meta")).shape)
    return [got.index(s) for s in sizes]


def _splits_in(name: str, view, ndim: int) -> list:
    """[(axis of view(leaf), Split)] of leaf ``name`` on this rank."""
    leaves = _SHARDED.get()
    if leaves is None:
        return []
    dims = _view_dims(view, ndim)
    return [(dims[s.dim], s) for s in leaves.splits(name) if s.parts > 1]


def _reduce(x: torch.Tensor, axis: int, splits) -> torch.Tensor:
    """x summed over the ranks of every split of ``axis``, in place."""
    for a, s in splits:
        if a == axis:
            torch.distributed.all_reduce(x, group=s.group)
    return x


def _stat_splits(splits, removed: int) -> list:
    """The splits of a statistic that drops axis ``removed`` of its leaf."""
    return [(a - (a > removed), s) for a, s in splits if a != removed]


# -- helpers ------------------------------------------------------------------

def _count(n: int = 0) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


def _increment(count: torch.Tensor) -> torch.Tensor:
    """optax's safe_increment: +1, saturating at the int32 maximum."""
    n = int(count)
    return _count(n + 1 if n < np.iinfo(np.int32).max else n)


def _f32(x) -> float:
    return float(np.float32(x))


def _groups(*trees: Tree):
    """The keys of trees[0], grouped by the dtype of their leaf in every tree
    and their device: each group runs as one list of foreach ops."""
    out: Dict[tuple, list] = {}
    for k, x in trees[0].items():
        out.setdefault(tuple(t[k].dtype for t in trees) + (x.device,), []).append(k)
    return list(out.values())


def _mul(xs, value):
    """x * value, value a Python float weak-typed to x's dtype."""
    return list(torch._foreach_mul(xs, rounded_to(float(value), xs[0].dtype)))


def _promoted(xs, ys):
    if xs[0].dtype == ys[0].dtype:
        return xs, ys
    dt = torch.promote_types(xs[0].dtype, ys[0].dtype)
    return [x.to(dt) for x in xs], [y.to(dt) for y in ys]


def _add(xs, ys):
    return list(torch._foreach_add(*_promoted(xs, ys)))


def _div(xs, ys):
    return list(torch._foreach_div(*_promoted(xs, ys)))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt rounded as XLA's: correctly rounded in fp32, then to x's dtype."""
    return torch.sqrt(x.double()).float().to(x.dtype)


def _mapped(fn, keys_of, *trees: Tree):
    """{key: out} over every group of keys: fn(*lists) -> list or tuple of
    lists, in the keys' order of trees[0]."""
    outs = None
    for keys in _groups(*trees):
        res = fn(*[[t[k] for k in keys] for t in trees])
        res = (res,) if not isinstance(res, tuple) else res
        if outs is None:
            outs = [dict() for _ in res]
        for out, vals in zip(outs, res):
            out.update(zip(keys, vals))
    if outs is None:  # an empty tree
        return {}
    order = list(keys_of)
    outs = [{k: o[k] for k in order} for o in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)


def global_norm(tree: Tree) -> torch.Tensor:
    """optax.global_norm: each leaf's squares summed in the leaf's dtype
    (fp32 sums rounded once), the leaves' sums added in turn in their
    promoted dtype, then the sqrt. A 0-d CPU tensor (one copy from the
    device: the sums added in turn are a host loop)."""
    if not tree:
        return torch.zeros(())
    sums = {}
    for keys in _groups(tree):
        xs = [tree[k] for k in keys]
        sq = torch._foreach_mul(xs, xs)
        sums.update(zip(keys, torch.stack([s.sum() for s in sq]).cpu()))
    leaves = _SHARDED.get()
    if leaves is not None:
        return _sqrt(leaves.total({k: sums[k] for k in tree}))
    total = None
    for k in tree:
        total = sums[k] if total is None else total + sums[k]
    return _sqrt(total)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in fp32, pow correctly rounded (as XLA's)."""
    return _f32(np.float32(1) - np.float32(np.float64(np.float32(decay)) ** count))


# -- transformations --------------------------------------------------------------

def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(),
                                  lambda updates, state, params=None: (updates, state))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every update by max_norm / norm when the global norm is not
    below max_norm (``t / norm * max_norm``, in t's dtype); unchanged
    otherwise. The comparison waits for the norm on the host."""

    def update(updates, state, params=None):
        norm = global_norm(updates)
        if bool(norm < rounded_to(float(max_norm), norm.dtype)):
            return updates, state

        def clip(xs):
            xs = torch._foreach_div(xs, float(norm.to(xs[0].dtype)))
            return _mul(xs, max_norm)

        return _mapped(clip, updates, updates), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale(step_size: float) -> GradientTransformation:
    def update(updates, state, params=None):
        return _mapped(lambda xs: _mul(xs, step_size), updates, updates), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_schedule(step_size_fn: Callable[[int], float]) -> GradientTransformation:
    def update(updates, state, params=None):
        step = step_size_fn(int(state.count))
        out = _mapped(lambda xs: _mul(xs, step), updates, updates)
        return out, ScaleByScheduleState(_increment(state.count))

    return GradientTransformation(lambda params: ScaleByScheduleState(_count()), update)


def scale_by_learning_rate(learning_rate: Union[float, Callable[[int], float]], *,
                           flip_sign: bool = True) -> GradientTransformation:
    m = -1 if flip_sign else 1
    if callable(learning_rate):
        return scale_by_schedule(lambda count: _f32(np.float32(m) * learning_rate(count)))
    return scale(m * learning_rate)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over transition_steps, in fp32
    (``(init - end) * (1 - count / steps) + end``)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        frac = np.float32(1) - np.float32(c) / np.float32(transition_steps)
        return _f32(np.float32(init_value - end_value) * frac + np.float32(end_value))

    return schedule


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  mu_dtype: Optional[torch.dtype] = None) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(
            _count(), {k: torch.zeros_like(p, dtype=mu_dtype or p.dtype) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()})

    def update(updates, state, params=None):
        count = _increment(state.count)
        bc1, bc2 = _bias_correction(b1, int(count)), _bias_correction(b2, int(count))

        def adam(g, m, v):
            m = _add(_mul(g, 1 - b1), _mul(m, b1))
            v = _add(_mul(torch._foreach_mul(g, g), 1 - b2), _mul(v, b2))
            m_hat = list(torch._foreach_div(m, rounded_to(bc1, m[0].dtype)))
            v_hat = list(torch._foreach_div(v, rounded_to(bc2, v[0].dtype)))
            den = list(torch._foreach_add(torch._foreach_sqrt(v_hat),
                                          rounded_to(eps, v[0].dtype)))
            if mu_dtype is not None:
                m = [x.to(mu_dtype) for x in m]
            return _div(m_hat, den), m, v

        u, mu, nu = _mapped(adam, updates, updates, state.mu, state.nu)
        return u, ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs params")
        out = _mapped(lambda u, p: _add(u, _mul(p, weight_decay)), updates, updates, params)
        return out, state

    return GradientTransformation(lambda params: EmptyState(), update)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          mu_dtype: Optional[torch.dtype] = None,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw: Adam's mu_hat / (sqrt(nu_hat) + eps), plus weight_decay *
    p, times -learning_rate (a float or a schedule of the step count)."""
    return chain(scale_by_adam(b1, b2, eps, mu_dtype),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def trace(decay: float) -> GradientTransformation:
    """optax.trace: the momentum g + decay * t, in the parameters' dtype."""
    def update(updates, state, params=None):
        new = _mapped(lambda g, t: _add(g, _mul(t, decay)), updates, updates, state.trace)
        return new, TraceState(new)

    return GradientTransformation(
        lambda params: TraceState({k: torch.zeros_like(p) for k, p in params.items()}), update)


def sgd(learning_rate, momentum: Optional[float] = None) -> GradientTransformation:
    return chain(trace(momentum) if momentum is not None else identity(),
                 scale_by_learning_rate(learning_rate))


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """(p + u) cast to p's dtype, leaf by leaf."""
    def add(p, u):
        return [x.to(p0.dtype) for x, p0 in zip(_add(p, u), p)]

    return _mapped(add, params, params, updates)


# -- Adafactor ----------------------------------------------------------------

def _factored_dims(shape, factored: bool, min_dim_size_to_factor: int):
    """(d1, d0), the two largest axes, or None (optax's rule, numpy's
    argsort included, so equal sizes resolve as optax resolves them)."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def dropped_axis(shape, field: str) -> int:
    """The axis of a factored leaf's JAX shape (a stacked leaf's with its
    blocks first) that its statistic ``field`` drops: v_row the mean over
    d0, v_col the mean over d1."""
    d1, d0 = _factored_dims(shape, True, 0)
    return d0 if field == "v_row" else d1


def _pow(x: torch.Tensor, y: float) -> torch.Tensor:
    """x ** y in x's dtype, through fp64 and a correctly rounded fp32 (as
    XLA's pow)."""
    return torch.pow(x.double(), _f32(y)).float().to(x.dtype)


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """jnp.mean: an fp32 sum over the axes, divided, rounded to x's dtype."""
    if dim is None:
        return x.float().mean().to(x.dtype)
    return x.float().mean(dim=dim, keepdim=keepdim).to(x.dtype)


def _mean_over(x: torch.Tensor, axis: int, splits, size: int,
               keepdim: bool = False) -> torch.Tensor:
    """jnp.mean of the whole leaf over ``axis`` (of global size ``size``):
    where ``splits`` split that axis, a local fp32 sum, all-reduced, divided."""
    if not any(a == axis for a, _ in splits):
        return _mean(x, axis, keepdim)
    total = _reduce(x.float().sum(axis, keepdim=keepdim), axis, splits)
    return (total / size).to(x.dtype)


def _stack(layouts: Layouts, name: str) -> Optional[tuple]:
    """(the JAX leaf's path, block index, blocks) of a leaf the JAX package
    stacks (its layout's ``stack``), else None."""
    return getattr(layouts.get(name), "stack", None)


def scale_by_factored_rms(factored: bool = True, decay_rate: float = 0.8,
                          step_offset: int = 0, min_dim_size_to_factor: int = 128,
                          epsilon: float = 1e-30,
                          layouts: Optional[Layouts] = None) -> GradientTransformation:
    """Adafactor's factored second moment. The statistics are those of each
    leaf in the JAX package's layout (``layouts[name].to_jax``: (in, out)
    linears, HWIO convs), as optax factors them there: v_row and v_col are
    kept in that layout, a whole-leaf v in the leaf's own. The factored
    dims are chosen on the global shape of the JAX leaf (a stacked one's
    leading axis included: factoring over it raises)."""
    layouts = layouts or {}

    def views(name):
        lay = layouts.get(name)
        return (lambda t: t, lambda t: t) if lay is None else (lay.to_jax, lay.from_jax)

    def plan(name, leaf):
        """(the leaf's global shape in the JAX layout, its splits there, the
        factored dims (d1, d0) or None)."""
        to_jax = views(name)[0]
        splits = _splits_in(name, to_jax, leaf.ndim)
        shape = list(to_jax(leaf).shape)
        for a, s in splits:
            shape[a] *= s.parts
        stack = _stack(layouts, name)
        lead = (stack[2],) if stack else ()
        dims = _factored_dims(lead + tuple(shape), factored, min_dim_size_to_factor)
        if dims is not None and lead:
            if 0 in dims:
                raise ValueError(f"adafactor: {name}'s stack of {lead[0]} blocks would be "
                                 "factored over its stack axis")
            dims = (dims[0] - 1, dims[1] - 1)
        return tuple(shape), splits, dims

    def init(params):
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            _, _, dims = plan(k, p)
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is not None:
                d1, d0 = dims
                local = list(views(k)[0](p).shape)
                v_row[k] = torch.zeros(np.delete(local, d0).tolist(), dtype=p.dtype, device=p.device)
                v_col[k] = torch.zeros(np.delete(local, d1).tolist(), dtype=p.dtype, device=p.device)
                v[k] = one
            else:
                v_row[k], v_col[k], v[k] = one, one.clone(), torch.zeros_like(p)
        return FactoredState(_count(), v_row, v_col, v)

    def update(grads, state, params):
        if params is None:
            raise ValueError("scale_by_factored_rms needs params")
        t = np.float64(int(state.count) - step_offset + 1)
        d = np.float32(1) - np.float32(t ** np.float64(np.float32(-decay_rate)))
        keep, fresh = float(d), _f32(np.float32(1) - d)
        updates, v_row, v_col, v = {}, {}, {}, {}
        for k, grad in grads.items():
            to_jax, from_jax = views(k)
            g = to_jax(grad)
            dtype = params[k].dtype
            shape, splits, dims = plan(k, grad)
            zero = torch.zeros((1,), dtype=dtype, device=g.device)
            g_sq = g * g + rounded_to(epsilon, g.dtype)
            if dims is not None:
                d1, d0 = dims
                row = (keep * state.v_row[k].float()
                       + fresh * _mean_over(g_sq, d0, splits, shape[d0]).float()).to(dtype)
                col = (keep * state.v_col[k].float()
                       + fresh * _mean_over(g_sq, d1, splits, shape[d1]).float()).to(dtype)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_mean = _mean_over(row, reduced_d1, _stat_splits(splits, d0), shape[d1],
                                      keepdim=True)
                row_factor = _pow(row / row_mean, -0.5)
                col_factor = _pow(col, -0.5)
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                v_row[k], v_col[k], v[k] = row, col, zero
            else:
                new_v = (keep * to_jax(state.v[k]).float() + fresh * g_sq.float()).to(dtype)
                u = g * _pow(new_v, -0.5)
                v_row[k], v_col[k], v[k] = zero, zero.clone(), from_jax(new_v).contiguous()
            updates[k] = from_jax(u).contiguous()
        return updates, FactoredState(_increment(state.count), v_row, v_col, v)

    return GradientTransformation(init, update)


def _block_mean_squares(tree: Tree, layouts: Layouts) -> Tree:
    """{name: jnp.mean(x * x) over the whole JAX leaf} (0-d, x's dtype): a
    split leaf's squares summed over its shards (``leaves.totals``), a
    stacked one's over its stack."""
    leaves = _SHARDED.get()
    stacks = {k: st for k in tree if (st := _stack(layouts, k))}
    out, sums, numel = {}, {}, {}
    for k, x in tree.items():
        splits = [s for s in leaves.splits(k) if s.parts > 1] if leaves is not None else []
        if not splits and k not in stacks:
            out[k] = _mean(x * x)
            continue
        sums[k] = (x * x).float().sum()
        numel[k] = x.numel() * math.prod(s.parts for s in splits)
    if sums and leaves is not None:
        sums = leaves.totals(sums)
    members: Dict[str, list] = {}
    for k in sums:
        members.setdefault(stacks[k][0] if k in stacks else k, []).append(k)
    for ks in members.values():
        ks = sorted(ks, key=lambda k: stacks[k][1] if k in stacks else 0)
        total = sums[ks[0]]
        for k in ks[1:]:
            total = total + sums[k]
        ms = (total / sum(numel[k] for k in ks)).to(tree[ks[0]].dtype)
        out.update((k, ms) for k in ks)
    return out


def clip_by_block_rms(threshold: float, layouts: Optional[Layouts] = None
                      ) -> GradientTransformation:
    def update(updates, state, params=None):
        ms = _block_mean_squares(updates, layouts or {})
        out = {}
        for k, u in updates.items():
            rms = _sqrt(ms[k])
            denom = torch.clamp(rms / rounded_to(threshold, u.dtype), min=1.0)
            out[k] = u / denom
        return out, state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_param_block_rms(min_scale: float = 1e-3, layouts: Optional[Layouts] = None
                             ) -> GradientTransformation:
    def update(updates, state, params):
        ms = _block_mean_squares({k: params[k] for k in updates}, layouts or {})
        out = {}
        for k, u in updates.items():
            p = params[k]
            rms = _sqrt(ms[k])
            floor = rounded_to(min_scale, p.dtype)
            out[k] = u * torch.where(rms <= floor, torch.full_like(rms, floor), rms)
        return out, state

    return GradientTransformation(lambda params: EmptyState(), update)


def adafactor(learning_rate=None, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, decay_offset: int = 0,
              multiply_by_parameter_scale: bool = True,
              clipping_threshold: Optional[float] = 1.0, eps: float = 1e-30,
              factored: bool = True, *,
              layouts: Optional[Layouts] = None) -> GradientTransformation:
    """optax.adafactor with its defaults (no momentum, no weight decay):
    factored RMS scaling, block-RMS clipping, learning rate, parameter
    scale, -1.
    ``layouts`` (train.step.param_layouts of the model) factors each leaf
    in the JAX layout, as optax does, and takes the block RMS of a leaf
    the JAX package stacks over its whole stack."""
    txs = [scale_by_factored_rms(factored, decay_rate, decay_offset,
                                 min_dim_size_to_factor, eps, layouts)]
    if clipping_threshold is not None:
        txs.append(clip_by_block_rms(clipping_threshold, layouts))
    if learning_rate is not None:
        txs.append(scale_by_learning_rate(learning_rate, flip_sign=False))
    if multiply_by_parameter_scale:
        txs.append(scale_by_param_block_rms(layouts=layouts))
    txs.append(scale(-1))
    return chain(*txs)


def state_bytes(state) -> int:
    """Bytes of the tensors in an optimizer state."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    if isinstance(state, (tuple, list)):
        return sum(state_bytes(v) for v in state)
    return 0
