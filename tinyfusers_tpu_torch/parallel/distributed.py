"""Process-group setup and hybrid meshes (port of
tinyfusers_tpu/parallel/distributed.py).

- ``initialize`` forms the torch.distributed process group, from
  torchrun's environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK) or
  from explicit arguments; unconfigured it is a no-op, as on one process;
- ``hybrid_mesh`` lays the model (TP) axis inside a host and the data axis
  across hosts: with torchrun's host-major rank order that is the flat
  mesh whenever a host's ranks hold whole model groups;
- ``sync_decision`` broadcasts rank 0's host-side choice (a scheduler's
  admissions, a seed) so that every rank runs the same program.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from .mesh import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Form the process group; True when more than one process takes part.
    coordinator_address "host:port" (else torchrun's MASTER_ADDR /
    MASTER_PORT), num_processes and process_id (else WORLD_SIZE and RANK);
    NCCL with a GPU, gloo without. Nothing configured:
    a no-op returning False. A second call returns the first one's
    answer."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" not in env:
        return False
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return world > 1


def hybrid_mesh(model: int = 1, *, device_type: Optional[str] = None):
    """(data, model) mesh with each model group inside one host. Ranks are
    host-major (torchrun's order), so the flat mesh's model groups, of
    consecutive ranks, lie within a host when the ranks a host runs
    (LOCAL_WORLD_SIZE) hold whole groups; raises otherwise."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if local % model:
        raise ValueError(f"model axis {model} does not divide the {local} ranks of a host")
    return make_mesh(model=model, device_type=device_type)


def sync_decision(value, mesh=None):
    """Rank 0's ``value`` (a pytree of tensors, numpy arrays and scalars,
    of the same structure on every rank) on every rank, each tensor on the
    device its counterpart has here. The identity on one process.

    mesh: the mesh's first rank's value on every rank of the mesh, by a
    broadcast over each axis's group from its index 0 in turn (after the
    one over an axis, a rank holds the value of the rank with that
    coordinate 0), so that a mesh over some of the world's ranks needs no
    group of its own."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    leaves, spec = pytree.tree_flatten(value)
    box = [[x.detach().cpu() if isinstance(x, torch.Tensor) else x for x in leaves]]
    if mesh is None:
        dist.broadcast_object_list(box, src=0)
    else:
        for i, name in enumerate(mesh.mesh_dim_names):
            if mesh.size(i) > 1:
                group = mesh.get_group(name)
                dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                                           group=group)
    return pytree.tree_unflatten(
        [g.to(x.device) if isinstance(x, torch.Tensor) else g for g, x in zip(box[0], leaves)],
        spec)
