"""Device mesh construction (port of tinyfusers_tpu/parallel/mesh.py).

Axis convention, as in the JAX package:

- ``data``: batch / request parallelism: each rank of a data group holds
  its own rows of the batch;
- ``model``: tensor parallelism (attention heads, FF columns): each rank
  of a model group holds its slices of the column- and row-parallel
  weights (parallel/sharding.py) and the collectives of parallel/tp.py
  join them;
- ``pipe`` (parallel/pipeline.py, meshes made with ``pipe=``): pipeline
  stages, each rank of a pipe group running its share of a block stack.

The JAX package hands a ``jax.sharding.Mesh`` to GSPMD, which inserts
every collective. Here the mesh is a ``torch.distributed`` DeviceMesh
over the initialised process group, and the port's layers call the
collectives themselves on the groups the mesh gives
(``mesh.get_group("model")``).

The JAX models reach the mesh of ring attention and of the pipeline
through ``jax.set_mesh``; here ``use_mesh(mesh)`` makes ``mesh`` the
ambient mesh for the code it encloses (``current_mesh()``), restored when
the block is left, by an exception too.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("tinyfusers_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh]) -> Iterator[Optional[DeviceMesh]]:
    """``mesh`` as the ambient mesh (``current_mesh()``) inside the block."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def current_mesh() -> Optional[DeviceMesh]:
    """The mesh of the innermost enclosing ``use_mesh``, else None."""
    return _AMBIENT.get()


def make_mesh(data: Optional[int] = None, model: int = 1, *, pipe: Optional[int] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, model) DeviceMesh over the world of the initialised process
    group, the model axis innermost: ranks r and r + 1 share a model group.
    With ``pipe``, a (data, pipe, model) mesh: each data index holds its own
    pipe groups, so that four ranks at pipe = 2 run two two-stage pipes.

    device_type defaults to "cuda" and raises without a GPU, as the port's
    entry points do; pass "cpu" for a gloo mesh on the CPU."""
    device_type = device_type or "cuda"
    resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: call "
                           "parallel.distributed.initialize() (or "
                           "torch.distributed.init_process_group) first")
    n = dist.get_world_size()
    inner = model * (pipe or 1)
    if data is None:
        data = n // inner
    if data * inner != n:
        raise ValueError(f"a (data {data}, {'' if pipe is None else f'pipe {pipe}, '}model "
                         f"{model}) mesh does not cover the {n} ranks of the process group")
    if pipe is None:
        return init_device_mesh(device_type, (data, model),
                                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return init_device_mesh(device_type, (data, pipe, model),
                            mesh_dim_names=(DATA_AXIS, PIPE_AXIS, MODEL_AXIS))


def axis(mesh: Optional[DeviceMesh], name: str) -> Tuple[int, int, object]:
    """(size, this rank's index, process group) of mesh axis ``name``;
    (1, 0, None) without a mesh."""
    if mesh is None:
        return 1, 0, None
    return mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name), \
        mesh.get_group(name)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on over ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class Placement:
    """How one tensor lies on the mesh: ``spec`` in the JAX package's
    PartitionSpec terms (a tuple naming, per axis of the leaf in the JAX
    layout, the mesh axis it is split over, or None), and where that
    lands in the port's storage: ``model_dim`` / ``data_dim``, the tensor
    dims this rank holds a slice of (None: whole). ``halves``: the model
    slice is taken from each half of dim ``model_dim`` (the GEGLU
    projection's ``[gx | gate]``). ``layout``: the leaf's class
    (models.layers.Linear / Conv) when its storage order is not the JAX
    one. ``stack``: the blocks of the leaf the JAX package stacks this one
    into (0: not stacked)."""

    mesh: Optional[DeviceMesh] = dataclasses.field(default=None, compare=False, repr=False)
    spec: tuple = ()
    model_dim: Optional[int] = None
    data_dim: Optional[int] = None
    halves: bool = False
    layout: Optional[type] = dataclasses.field(default=None, compare=False)
    stack: int = dataclasses.field(default=0, compare=False)

    @property
    def sharded(self) -> bool:
        return self.model_dim is not None or self.data_dim is not None


def replicated(mesh: DeviceMesh) -> Placement:
    return Placement(mesh, ())


def data_sharded(mesh: DeviceMesh, ndim: int = 1) -> Placement:
    """The leading (batch) axis split over the data axis."""
    return Placement(mesh, (DATA_AXIS,) + (None,) * (ndim - 1), data_dim=0)
