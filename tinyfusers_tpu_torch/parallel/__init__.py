"""Tensor-, data- and fully-sharded parallelism on torch.distributed (port
of tinyfusers_tpu/parallel/): the (data, model) mesh, the TP partition
rules and their collectives, FSDP, process-group setup. Ring attention
and GPipe (the JAX package's ``ring_attention``, ``pipeline_apply``,
``pipeline_scan``, ``PIPE_AXIS``) are not ported yet.
"""
from . import distributed, tp
from .mesh import DATA_AXIS, MODEL_AXIS, Placement, data_sharded, make_mesh, replicated
from .sharding import (fsdp_spec_tree, shard_fsdp, shard_params,
                       sharding_tree, tp_spec_tree, unshard)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Placement", "data_sharded", "distributed",
    "make_mesh", "replicated", "fsdp_spec_tree", "shard_fsdp",
    "shard_params", "sharding_tree", "tp", "tp_spec_tree", "unshard",
]
