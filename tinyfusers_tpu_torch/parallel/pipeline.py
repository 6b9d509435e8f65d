"""Pipeline parallelism over a stack of blocks, GPipe (port of
tinyfusers_tpu/parallel/pipeline.py).

With P stages over the ``pipe`` axis, stage s holds layers
[s L/P, (s+1) L/P) of the L blocks, and the batch is split into M
microbatches that stream through the stages: microbatch i enters stage s
at tick i + s, so the schedule takes M + P - 1 ticks (bubble fraction
(P - 1) / (M + P - 1)). The JAX package runs every tick on every stage
and discards the empty ones; here a stage runs only its M ticks with a
microbatch, receiving each from the stage before and sending it to the
stage after, so the numbers are the same. The last stage's finished
microbatches are broadcast to every stage of the group (the JAX
package's masked ``psum``), since the layers after the stack run
replicated.

The port's blocks are modules of a list (a model's ``STACKED``
containers), not one stacked leaf: ``pipeline_apply`` takes the list and
each rank runs its slice. ``place_stages`` (called by
``parallel.shard_params`` on a mesh with a ``pipe`` axis) is the JAX
package's split of the stacked L axis over ``pipe``: of a model's
``PIPELINED`` list it keeps this stage's L / P blocks and puts an
``Elsewhere`` module, which holds nothing, in place of each other one.
Transfers are ``torch.distributed`` send / recv on the pipe group,
through host memory for CUDA tensors on a gloo group
(parallel/ring_attention.py ``transport``).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch import nn

from .mesh import PIPE_AXIS, axis as mesh_axis, current_mesh
from .ring_attention import transport


class Elsewhere(nn.Module):
    """The place of a block that pipeline stage ``stage`` holds."""

    def __init__(self, stage: int):
        super().__init__()
        self.stage = stage

    def extra_repr(self) -> str:
        return f"stage={self.stage}"


def _stage_range(depth: int, n: int, s: int) -> range:
    if depth % n:
        raise ValueError(f"{depth} blocks do not split over {n} pipeline stages")
    per = depth // n
    return range(s * per, (s + 1) * per)


def place_stages(module: nn.Module, mesh) -> nn.Module:
    """Keep, of each pipelined block list in ``module`` (a model's
    ``PIPELINED`` list, when its ``cfg.pipeline_microbatches`` is set),
    this rank's stage's blocks only over the mesh's ``pipe`` axis; the
    others are freed. A mesh without that axis, or with one stage, changes
    nothing. Returns ``module``."""
    if PIPE_AXIS not in (mesh.mesh_dim_names or ()):
        return module
    n, s, _ = mesh_axis(mesh, PIPE_AXIS)
    models = [m for m in module.modules() if getattr(m, "PIPELINED", None)
              and getattr(m.cfg, "pipeline_microbatches", None)]
    for model in models if n > 1 else ():
        blocks = getattr(model, model.PIPELINED)
        mine = _stage_range(len(blocks), n, s)
        for i in range(len(blocks)):
            if i not in mine:
                blocks[i] = Elsewhere(i // len(mine))
    return module


def _send(leaves, dst: int, group) -> list:
    """(work, tensor sent) of each leaf: the tensor is kept until the wait."""
    host = transport(group, leaves[0]) == "host"
    sent = [x.contiguous().cpu() if host else x.contiguous() for x in leaves]
    return [(dist.isend(x, dst, group=group, tag=i), x) for i, x in enumerate(sent)]


def _recv(like, src: int, group) -> list:
    host = transport(group, like[0]) == "host"
    out = [torch.empty_like(x, device="cpu" if host else x.device) for x in like]
    for i, x in enumerate(out):
        dist.recv(x, src, group=group, tag=i)
    return [x.to(ref.device) for x, ref in zip(out, like)] if host else out


def pipeline_scan(block_fn: Callable, local_blocks: Sequence, carry: Any, microbatches: int,
                  axis_name: str = PIPE_AXIS, *, mesh=None) -> Any:
    """This rank's GPipe loop over its own ``local_blocks``. ``carry`` is a
    pytree of (B, ...) tensors, split into ``microbatches`` along the batch
    dim, streamed through the stages and returned whole on every stage.

    block_fn(block, carry) -> carry of the same structure, shapes and
    dtypes. Conditioning with a batch dim (the MMDiT's modulation vector c)
    travels in the carry so that it is split with the streams. mesh=None
    takes the ambient mesh."""
    mesh = current_mesh() if mesh is None else mesh
    n, s, group = mesh_axis(mesh, axis_name)
    m = microbatches
    leaves, spec = pytree.tree_flatten(carry)
    for x in leaves:
        if x.shape[0] % m:
            raise ValueError(f"batch {x.shape[0]} not divisible by microbatches {m}")
    mbs = [[x.chunk(m, dim=0)[i] for x in leaves] for i in range(m)]
    ranks = dist.get_process_group_ranks(group) if n > 1 else []

    def stage(xs):
        c = pytree.tree_unflatten(xs, spec)
        for blk in local_blocks:
            c = block_fn(blk, c)
        return pytree.tree_flatten(c)[0]

    done, pending = [], []
    for i in range(m):  # the ticks s .. s + M - 1, the ones with a microbatch here
        xs = mbs[i] if s == 0 else _recv(mbs[i], ranks[s - 1], group)
        ys = stage(xs)
        if s < n - 1:
            pending += _send(ys, ranks[s + 1], group)
        done.append(ys)
    for work, _ in pending:
        work.wait()
    out = [torch.cat([d[j] for d in done], dim=0) for j in range(len(leaves))]
    if n > 1:  # the last stage's result on every stage
        host = transport(group, out[0]) == "host"
        for j, x in enumerate(out):
            y = x.contiguous().cpu() if host else x.contiguous()
            dist.broadcast(y, src=ranks[n - 1], group=group)
            out[j] = y.to(x.device) if host else y
    return pytree.tree_unflatten(out, spec)


def pipeline_apply(block_fn: Callable, blocks: Sequence, carry: Any, *, mesh=None,
                   microbatches: int, axis_name: str = PIPE_AXIS) -> Any:
    """The GPipe schedule over all of ``blocks`` (a list or ModuleList of
    L blocks, whole or as ``place_stages`` left them): this rank runs its
    stage's L / P consecutive ones and
    returns the carry pytree, whole on every stage. mesh=None takes the
    ambient mesh (``parallel.use_mesh``). Other mesh axes are untouched:
    each index of the data axis runs its own pipe on the carry it holds."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError("pipeline_apply: no mesh: pass mesh= or enter parallel.use_mesh")
    if axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"pipeline_apply: the mesh has no axis {axis_name!r} "
                         f"(axes {mesh.mesh_dim_names})")
    n, s, _ = mesh_axis(mesh, axis_name)
    local = [blocks[i] for i in _stage_range(len(blocks), n, s)]
    if any(isinstance(b, Elsewhere) for b in local):
        raise ValueError(f"pipeline_apply: stage {s}'s blocks were placed on another stage "
                         "(place_stages over another mesh)")
    return pipeline_scan(block_fn, local, carry, microbatches, axis_name, mesh=mesh)
