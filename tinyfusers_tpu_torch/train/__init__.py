"""Training (port of tinyfusers_tpu/train/): diffusion objectives, the
train step with remat and EMA, optax's optimizers (optim.py), LoRA
fine-tuning, train-state checkpoints that the JAX package reads, data
feeding; on a mesh (parallel/) data-parallel, tensor-parallel and
FSDP steps, and the batch helpers that split a batch over the data axis.
"""
from .losses import LossConfig, diffusion_loss, loss_weights, q_sample, \
    sample_timesteps
from .step import (Leaf, TrainState, default_optimizer, make_train_step, module_apply,
                   param_layouts, params_of)
from .lora import DEFAULT_TARGETS, init_lora, make_lora_train_step, merge
from .checkpoint import load_train_state, save_train_state
from .data import (LatentDataset, NativeShardDataset, make_global_batch, shard_batch,
                   write_shard)

__all__ = [
    "LossConfig", "diffusion_loss", "loss_weights", "q_sample",
    "sample_timesteps", "TrainState", "default_optimizer",
    "make_train_step", "module_apply", "param_layouts", "params_of", "Leaf",
    "DEFAULT_TARGETS", "init_lora", "make_lora_train_step", "merge",
    "load_train_state", "save_train_state", "LatentDataset",
    "NativeShardDataset", "write_shard", "make_global_batch", "shard_batch",
]
