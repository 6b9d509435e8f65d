"""Tensor-, data-, fully-sharded, sequence- and pipeline-parallelism on
torch.distributed (port of tinyfusers_tpu/parallel/): the (data, model)
mesh (and its ``pipe`` axis) with the ambient mesh of ``use_mesh``, the TP
partition rules and their collectives, FSDP, process-group setup, ring
attention (``ring_attention``) and GPipe (``pipeline_apply``).
"""
from . import distributed, pipeline, ring_attention, tp
from .mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Placement, current_mesh, data_sharded,
                   make_mesh, replicated, use_mesh)
from .pipeline import pipeline_apply, pipeline_scan
from .ring_attention import ring_sdpa, sequence_sharded
from .sharding import (fsdp_spec_tree, shard_fsdp, shard_params,
                       sharding_tree, tp_spec_tree, unshard)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "Placement", "current_mesh", "data_sharded",
    "distributed", "make_mesh", "pipeline", "pipeline_apply", "pipeline_scan", "replicated",
    "ring_attention", "ring_sdpa", "sequence_sharded", "fsdp_spec_tree", "shard_fsdp",
    "shard_params", "sharding_tree", "tp", "tp_spec_tree", "unshard", "use_mesh",
]
