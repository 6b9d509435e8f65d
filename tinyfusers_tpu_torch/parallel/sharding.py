"""Tensor-parallel partition rules and FSDP (port of
tinyfusers_tpu/parallel/sharding.py).

The rules are the JAX package's, by the leaf's path in the param tree
(the port's parameter names are those paths joined by dots):

- column-parallel (output features split over ``model``): q/k/v
  projections, the fused ``qkv``, MLP up-projections (``fc1``, T5's
  ``wi_0`` / ``wi_1``, the GEGLU ``proj`` under ``ff``); JAX spec
  (in, out) -> (None, "model"), bias -> ("model",);
- row-parallel (input features split): attention outputs (``to_out``,
  ``out_proj``, T5's ``o``, ``proj`` under ``attn`` / ``img`` / ``txt``)
  and MLP down-projections (``fc2``, T5's ``wo``, ``out`` under ``ff``);
  weight -> ("model", None), bias replicated;
- everything else (convs, norms, embeddings, ``final.proj``) replicated.
  Only 2-D, or stacked 3-D, matmul weights are split; quantized values and
  scales sit one level deeper in the JAX tree (``weight.values``), where
  the rule sees the module name ``weight`` and leaves them replicated.

``tp_spec_tree`` gives those specs in the JAX package's terms, for every
parameter and quantized buffer, with the leading stack axis of leaves the
JAX package stacks for ``lax.scan``: they equal the JAX
``tp_spec_tree``'s. Where the JAX package hands the specs to GSPMD,
``shard_params`` cuts each weight to this rank's slice in place and the
layers call the collectives themselves (parallel/tp.py). That puts some
things in the port's hands that GSPMD's global semantics took care of:

- storage order: a Linear's weight is stored (out, in), so a column shard
  slices storage dim 0 and a row shard dim 1;
- the GEGLU halves: the UNet FF's ``proj`` output is ``[gx | gate]``,
  each of the inner width I; a plain column shard would give rank 0 every
  gx column. Each rank holds columns r I/n ... (r+1) I/n of both halves
  instead, so the GEGLU kernel stays a local call at K = I/n;
- heads: attention modules carry ``heads``, the count the model code
  runs; ``shard_params`` sets it to this rank's ``heads / n`` where it
  splits the unit. The fused qkv is head-interleaved, so a contiguous
  column shard keeps whole heads;
- the T5 position-bias table (buckets, heads), replicated in the JAX
  tree and sliced by GSPMD to the heads a device holds, is cut to this
  rank's heads (a model's ``TP_HEAD_TABLES``).

Shards are decided per unit, the module that holds a block's column- and
row-parallel Linears (an attention, an MLP, the UNet's FF): a unit is
split only when every split dimension divides by the model size, an
attention unit's ``heads`` divide too, and none of its weights is
quantized; otherwise the whole unit stays replicated and computes what the
dense layer computes. So SD2.x's 5-head level stays whole at model = 2
while its 10- and 20-head levels split (the JAX package computes it
through GSPMD's resharding around the head reshape); the numbers are the
dense ones either way. An attention module without ``heads`` stays
replicated. An attention whose ``impl`` is ring attention over the model
axis (``UNetConfig.self_attn_impl`` / ``MMDiTConfig.attn_impl`` =
"ring:model...") stays whole too: the ring splits its sequence over the
model ranks, each of which then needs every head (the JAX package's GSPMD
re-shards the head-split q / k / v to sequence-split ones instead).

FSDP (ZeRO-3): ``fsdp_spec_tree`` / ``shard_fsdp`` apply the JAX rule,
the TP spec first, then the largest still-unsplit axis (in the JAX
layout) divisible by the data size takes the ``data`` split, leaves under
``min_size`` elements kept whole. It holds for params, the EMA and every
optimizer-state tree keyed by the params' names. Adafactor's v_row and
v_col, whose shapes are not the params', report the rule on their own
global shapes (``fsdp_spec_tree``), but each rank holds them as it
computes them (train/optim.py): split over the data axis with their leaf
unless their mean ran over the split axis. The train step
(train/step.py) gathers the data-split leaves before the forward and
keeps its slice of the averaged gradients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import tp
from .mesh import DATA_AXIS, MODEL_AXIS, Placement, axis
from .pipeline import place_stages

COLUMN_PARALLEL = {"to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj",
                   "fc1", "qkv",
                   # T5 (models/t5.py): q/k/v and both gated-FF ups
                   "q", "k", "v", "wi_0", "wi_1"}
ROW_PARALLEL = {"to_out", "out_proj", "fc2",
                "o", "wo"}  # T5 attention-out / FF-down
# "proj" under "ff" is the GEGLU up-projection (column); under a DiT /
# MMDiT attention or stream ("attn" / "img" / "txt") the attention output
# (row); under "final" the unpatchify head (replicated). "out" under "ff"
# is the FF down-projection (row).
_PROJ_ROW_PARENTS = {"attn", "img", "txt"}
# a unit holding one of these is an attention: it splits by whole heads
_ATTN_COLUMNS = {"to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj", "qkv", "q", "k", "v"}
# the port's quantized buffers -> their field in the JAX tree
_QUANT_FIELDS = {"weight_values": "values", "weight_packed": "packed",
                 "weight_scales": "scales"}


def _role(names: List[str]) -> Optional[str]:
    """"column", "row" or None for the module names[-2] (under names[-3])."""
    if len(names) < 2:
        return None
    module = names[-2]
    parent = names[-3] if len(names) >= 3 else ""
    if module == "proj":
        return "row" if parent in _PROJ_ROW_PARENTS else "column" if parent == "ff" else None
    if module == "out" and parent == "ff":
        return "row"
    if module in COLUMN_PARALLEL:
        return "column"
    if module in ROW_PARALLEL:
        return "row"
    return None


def _leaf_spec(names: List[str], ndim: int) -> tuple:
    """The JAX package's ``_leaf_spec`` for a leaf at path ``names`` of
    ``ndim`` axes in the JAX layout."""
    role = _role(names)
    field = names[-1] if names else ""
    if role == "column":
        if field in ("weight", "values", "scales") and ndim in (2, 3):
            return (None,) * (ndim - 1) + (MODEL_AXIS,)
        if field == "bias" and ndim in (1, 2):
            return (None,) * (ndim - 1) + (MODEL_AXIS,)
    if role == "row" and field in ("weight", "values") and ndim in (2, 3):
        return (None,) * (ndim - 2) + (MODEL_AXIS, None)
    return ()


def _stacked_names(module: nn.Module) -> Dict[str, int]:
    """Parameter and buffer names inside containers the JAX package stacks
    -> the container's blocks."""
    out = {}
    for mname, mod in module.named_modules():
        for cname in getattr(mod, "STACKED", ()):
            blocks = getattr(mod, cname)
            base = f"{mname}.{cname}" if mname else cname
            for i, block in enumerate(blocks):
                for name, _ in [*block.named_parameters(), *block.named_buffers()]:
                    out[f"{base}.{i}.{name}"] = len(blocks)
    return out


def _leaves(module: nn.Module):
    """(name, tensor) of every floating parameter and quantized buffer."""
    for name, p in module.named_parameters():
        yield name, p
    for name, b in module.named_buffers():
        if name.rsplit(".", 1)[-1] in _QUANT_FIELDS:
            yield name, b


def tp_spec_tree(module: nn.Module) -> Dict[str, tuple]:
    """name -> the JAX package's TP PartitionSpec (as a tuple) of that
    leaf: the logical rule, whatever ``shard_params`` placed."""
    stacked = _stacked_names(module)
    out = {}
    for name, t in _leaves(module):
        names = name.split(".")
        if names[-1] in _QUANT_FIELDS:  # weight.values: module "weight"
            names = names[:-1] + ["weight", _QUANT_FIELDS[names[-1]]]
        out[name] = _leaf_spec(names, t.ndim + (name in stacked))
    return out


# -- tensor parallelism ---------------------------------------------------------

@dataclasses.dataclass
class _Member:
    name: str
    linear: nn.Module
    role: str
    halves: bool


def _units(module: nn.Module) -> Dict[str, Tuple[nn.Module, List[_Member]]]:
    """unit path -> (unit module, its column- and row-parallel Linears)."""
    from ..models.layers import Linear

    mods = dict(module.named_modules())
    units: Dict[str, Tuple[nn.Module, List[_Member]]] = {}
    for name, mod in mods.items():
        if not isinstance(mod, Linear):
            continue
        names = name.split(".") + ["weight"]
        role = _role(names)
        if role is None:
            continue
        parent = name.rsplit(".", 1)[0] if "." in name else ""
        halves = names[-2] == "proj" and len(names) >= 3 and names[-3] == "ff"
        units.setdefault(parent, (mods[parent], []))[1].append(
            _Member(name, mod, role, halves))
    return units


def _rings_over_model(impl: Optional[str]) -> bool:
    from .ring_attention import is_ring, ring_axes

    return is_ring(impl) and ring_axes(impl)[0] == MODEL_AXIS


def _splits(unit: nn.Module, members: List[_Member], n: int) -> bool:
    """Whether a unit splits n ways (the rule of the module docstring)."""
    if n == 1:
        return False
    if any(m.name.rsplit(".", 1)[-1] in _ATTN_COLUMNS for m in members):
        heads = getattr(unit, "heads", None)
        if not heads or heads % n or _rings_over_model(getattr(unit, "impl", None)):
            return False
    for m in members:
        if "weight" not in m.linear._parameters:  # quantized
            return False
        out_dim, in_dim = m.linear.weight.shape
        if m.role == "column" and (out_dim // (2 if m.halves else 1)) % n:
            return False
        if m.role == "row" and in_dim % n:
            return False
    return True


def _replace(mod: nn.Module, field: str, value: torch.Tensor) -> None:
    old = getattr(mod, field)
    setattr(mod, field, nn.Parameter(value.contiguous().clone(),
                                     requires_grad=old.requires_grad))


def shard_params(module: nn.Module, mesh):
    """Cut every column- and row-parallel Linear of ``module`` to this
    rank's slice over the mesh's model axis, in place, and set its role
    (``tp_role``, ``tp_group``) and its unit's ``heads`` to this rank's
    count; cut each ``TP_HEAD_TABLES`` table to this rank's heads when the
    model's attention split. On a mesh with a ``pipe`` axis keep only this
    stage's blocks of a pipelined model (``pipeline.place_stages``).
    Returns ``module``. A mesh whose model axis has one rank, and no pipe
    axis of more, changes nothing."""
    n, r, group = axis(mesh, MODEL_AXIS)
    units = _units(module)
    if any(m.linear.tp_role is not None for _, members in units.values() for m in members):
        raise ValueError("shard_params: the module is sharded already")
    for unit, members in units.values():
        if not _splits(unit, members, n):
            continue
        for m in members:
            dim = 0 if m.role == "column" else 1
            _replace(m.linear, "weight", tp.rank_slice(m.linear.weight, dim, r, n, m.halves))
            if m.role == "column" and m.linear.bias is not None:
                _replace(m.linear, "bias", tp.rank_slice(m.linear.bias, 0, r, n, m.halves))
            m.linear.tp_role, m.linear.tp_group, m.linear.tp_halves = m.role, group, m.halves
        if getattr(unit, "heads", None):
            unit.heads //= n
    for mod in module.modules():  # a model whose attention split: its head tables
        tables = getattr(mod, "TP_HEAD_TABLES", ())
        if tables and any(getattr(leaf, "tp_role", None) and name.rsplit(".", 1)[-1]
                          in _ATTN_COLUMNS for name, leaf in mod.named_modules()):
            for name in tables:
                table = getattr(mod, name)
                _replace(table, "weight", tp.rank_slice(table.weight, 1, r, n))
                table.tp_parts = n
    return place_stages(module, mesh)


def _layout_of(mod: nn.Module):
    from ..models.layers import Conv, Linear

    return type(mod) if isinstance(mod, (Linear, Conv)) else None


def _jax_axes(layout, ndim: int) -> List[int]:
    """storage dim -> JAX axis, for a leaf of ``layout``."""
    if layout is None or ndim < 2:
        return list(range(ndim))
    if ndim == 2:  # (out, in) -> (in, out)
        return [1, 0]
    return [3, 2, 0, 1]  # OIHW -> HWIO


def sharding_tree(module: nn.Module, mesh) -> Dict[str, Placement]:
    """name -> the Placement of each floating parameter as
    ``shard_params`` left it: the model split (storage dim, spec in JAX
    terms) of the Linears it cut and the head tables, replicated
    elsewhere. The placements a sharded TrainState carries."""
    stacked = _stacked_names(module)
    out = {}
    for mname, mod in module.named_modules():
        layout = _layout_of(mod)
        for pname, p in mod._parameters.items():
            if p is None or not p.is_floating_point():
                continue
            name = f"{mname}.{pname}" if mname else pname
            dim, halves = None, getattr(mod, "tp_halves", False)
            role = getattr(mod, "tp_role", None)
            if role == "column":
                dim = 0
            elif role == "row" and pname == "weight":
                dim = 1
            elif getattr(mod, "tp_parts", 1) > 1 and role is None:  # a head table
                dim = 1
            spec = [None] * p.ndim
            jaxes = _jax_axes(layout, p.ndim)
            if dim is not None:
                spec[jaxes[dim]] = MODEL_AXIS
            out[name] = Placement(mesh, tuple(spec) if dim is not None else (), model_dim=dim,
                                  halves=halves and dim is not None, layout=layout,
                                  stack=stacked.get(name, 0))
    return out


# -- FSDP ---------------------------------------------------------------------

def _jax_shape(pl: Placement, shape: Tuple[int, ...], model_n: int) -> List[int]:
    """A leaf's global shape in the JAX layout, from this rank's storage
    shape before a data split."""
    gshape = [0] * len(shape)
    for dim, a in enumerate(_jax_axes(pl.layout, len(shape))):
        gshape[a] = shape[dim] * (model_n if dim == pl.model_dim else 1)
    return gshape


def _fsdp_dim(pl: Placement, shape: Tuple[int, ...], model_n: int, data_n: int,
              min_size: int) -> Optional[int]:
    """The storage dim that takes the data split: the JAX rule on the
    leaf's global JAX shape."""
    ndim = len(shape)
    jaxes = _jax_axes(pl.layout, ndim)
    gshape = _jax_shape(pl, shape, model_n)
    if ndim == 0 or math.prod(gshape) < min_size:
        return None
    taken = jaxes[pl.model_dim] if pl.model_dim is not None else None
    for a in sorted(range(ndim), key=lambda a: -gshape[a]):
        if a != taken and gshape[a] % data_n == 0:
            return jaxes.index(a)
    return None


def _placements_of(tree, placements):
    placements = placements if placements is not None else getattr(tree, "placements", None)
    if placements is None:
        raise ValueError("FSDP needs the leaves' placements: pass "
                         "placements=parallel.sharding_tree(model, mesh)")
    return placements


def _params_of(tree) -> Dict[str, torch.Tensor]:
    return tree.params if hasattr(tree, "params") else tree


def _fsdp_placements(tree, mesh, *, placements: Optional[Dict[str, Placement]] = None,
                    min_size: int = 2 ** 16) -> Dict[str, Placement]:
    """name -> Placement with the data split of the FSDP rule added to
    the TP one, for a params dict or a TrainState (its ``params``; the
    EMA and optimizer-state trees keyed by the same names take the same
    placement). ``placements``: the TP placements
    (``sharding_tree(model, mesh)``), else the TrainState's."""
    placements = _placements_of(tree, placements)
    model_n = axis(mesh, MODEL_AXIS)[0]
    data_n = axis(mesh, DATA_AXIS)[0]
    out = {}
    for name, t in _params_of(tree).items():
        pl = placements[name]
        dim = _fsdp_dim(pl, tuple(t.shape), model_n, data_n, min_size)
        spec = pl.spec
        if dim is not None:
            spec = list(spec or (None,) * t.ndim)
            spec[_jax_axes(pl.layout, t.ndim)[dim]] = DATA_AXIS
            spec = tuple(spec)
        out[name] = dataclasses.replace(pl, mesh=mesh, spec=spec, data_dim=dim)
    return out


def _stat_spec(name: str, shape: Tuple[int, ...], data_n: int, min_size: int) -> tuple:
    """The JAX FSDP rule's spec of an Adafactor statistic of leaf ``name``
    and global shape ``shape`` (in the JAX layout): the TP rule of its
    path at its rank, then the largest free axis divisible by the data
    size."""
    tspec = _leaf_spec(name.split("."), len(shape))
    if not shape or math.prod(shape) < min_size:
        return tspec
    spec = list(tspec) + [None] * (len(shape) - len(tspec))
    for a in sorted(range(len(shape)), key=lambda a: -shape[a]):
        if spec[a] is None and shape[a] % data_n == 0:
            spec[a] = DATA_AXIS
            return tuple(spec)
    return tspec


def _dropped(pl: Placement, shape: Tuple[int, ...], model_n: int, field: str
             ) -> Tuple[List[int], int]:
    """(the leaf's global JAX shape, the axis of it that the factored
    statistic ``field`` (v_row / v_col) drops): train.optim's choice, on
    the shape a stacked leaf has in the JAX tree."""
    from ..train.optim import dropped_axis

    gshape = _jax_shape(pl, shape, model_n)
    lead = (pl.stack,) if pl.stack else ()
    return gshape, dropped_axis(lead + tuple(gshape), field) - len(lead)


def _map_state(obj, params: Dict[str, torch.Tensor], param_fn, stat_fn, other):
    """obj with every dict keyed by param names mapped leaf by leaf (a
    tensor of the param's shape by param_fn(name, tensor), an Adafactor
    statistic by stat_fn(name, tensor, field): field "v_row" / "v_col" for
    a factored statistic, None for the one-element stand-in of a leaf not
    so factored), every other tensor by other(tensor), through tuples and
    NamedTuples."""
    from ..train.optim import FactoredState

    if isinstance(obj, FactoredState):
        factored = {k for k, v in obj.v.items() if tuple(v.shape) != tuple(params[k].shape)}
        rows, cols = ({k: stat_fn(k, v, field if k in factored else None)
                       for k, v in getattr(obj, field).items()} for field in ("v_row", "v_col"))
        return FactoredState(other(obj.count), rows, cols,
                             {k: stat_fn(k, v, None) if k in factored else param_fn(k, v)
                              for k, v in obj.v.items()})
    if isinstance(obj, dict):
        if obj and set(obj) <= set(params):
            return {k: param_fn(k, v) if tuple(v.shape) == tuple(params[k].shape)
                    else other(v) for k, v in obj.items()}
        return obj
    if isinstance(obj, tuple):
        items = [_map_state(v, params, param_fn, stat_fn, other) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return other(obj) if isinstance(obj, torch.Tensor) else obj


def fsdp_spec_tree(tree, mesh, *, placements: Optional[Dict[str, Placement]] = None,
                   min_size: int = 2 ** 16):
    """The FSDP + TP specs in the JAX package's terms (the JAX
    ``fsdp_spec_tree`` of the same leaves): for a params dict, name ->
    spec; for a TrainState, {"params": that, "opt_state": the optimizer
    state's structure with a spec in place of each tensor}, Adafactor's
    v_row and v_col by the rule on their own global shapes."""
    pls = _fsdp_placements(tree, mesh, placements=placements, min_size=min_size)
    specs = {k: pl.spec for k, pl in pls.items()}
    if not hasattr(tree, "params"):
        return specs
    model_n, data_n = axis(mesh, MODEL_AXIS)[0], axis(mesh, DATA_AXIS)[0]

    def stat_spec(k, v, field):
        shape = tuple(v.shape)
        if field is not None:
            gshape, drop = _dropped(pls[k], tuple(tree.params[k].shape), model_n, field)
            shape = tuple(np.delete(gshape, drop).tolist())
        return _stat_spec(k, shape, data_n, min_size)

    return {"params": specs, "opt_state": _map_state(
        tree.opt_state, tree.params, lambda k, v: specs[k], stat_spec, lambda v: ())}


def shard_fsdp(tree, mesh, *, placements: Optional[Dict[str, Placement]] = None,
               min_size: int = 2 ** 16):
    """This rank's FSDP slices of a params dict or a TrainState (params,
    optimizer state, EMA), the TrainState carrying its placements for
    the train step. A factored Adafactor statistic is cut as this rank
    computes it: with its leaf's data split, unless it drops that axis."""
    pls = _fsdp_placements(tree, mesh, placements=placements, min_size=min_size)
    n, r, _ = axis(mesh, DATA_AXIS)
    model_n = axis(mesh, MODEL_AXIS)[0]
    params = _params_of(tree)

    def cut(k, v):
        dim = pls[k].data_dim
        return v if dim is None else tp.rank_slice(v, dim, r, n).contiguous().clone()

    def cut_stat(k, v, field):
        pl, shape = pls[k], tuple(params[k].shape)
        if field is None or pl.data_dim is None:
            return v
        a = _jax_axes(pl.layout, len(shape))[pl.data_dim]
        drop = _dropped(pl, shape, model_n, field)[1]
        if a == drop:  # the mean ran over the data-split axis: whole on every rank
            return v
        return tp.rank_slice(v, a - (a > drop), r, n).contiguous().clone()

    if not hasattr(tree, "params"):
        return {k: cut(k, v) for k, v in tree.items()}
    return dataclasses.replace(
        tree, params={k: cut(k, v) for k, v in params.items()},
        opt_state=_map_state(tree.opt_state, params, cut, cut_stat, lambda v: v),
        ema_params=None if tree.ema_params is None
        else {k: cut(k, v) for k, v in tree.ema_params.items()},
        placements=pls)


def unshard(tree: Dict[str, torch.Tensor], placements: Dict[str, Placement]
            ) -> Dict[str, torch.Tensor]:
    """The whole leaves of a sharded params (or EMA) dict on every rank:
    the data slices, then the model slices gathered (no gradient), e.g.
    to save or check a sharded state."""
    out = {}
    for k, v in tree.items():
        pl = placements.get(k)
        if pl is not None and pl.data_dim is not None:
            v = tp.all_gather(v, axis(pl.mesh, DATA_AXIS)[2], dim=pl.data_dim)
        if pl is not None and pl.model_dim is not None:
            v = tp.all_gather(v, axis(pl.mesh, MODEL_AXIS)[2], dim=pl.model_dim,
                              halves=pl.halves)
        out[k] = v
    return out
