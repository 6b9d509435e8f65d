"""SD checkpoint files <-> the port's models (port of the SD1.x / SD2.x part
of tinyfusers_tpu/io/checkpoints.py).

load_sd_params(path, cfg): a torch-zip .ckpt or a .safetensors file ->
a pipeline.sd.StableDiffusion holding its weights on the device, in the
requested dtype. save_sd_checkpoint(model, path, cfg): the model as an
SD-format .safetensors file. load_controlnet_params(path, cfg) and
save_controlnet_checkpoint(model, path): the same for a ControlNet in
lllyasviel's ``control_model.*`` layout; load_sdxl_params(path, cfg) and
save_sdxl_checkpoint(model, path) for SDXL-base's layout;
load_sd3_params(path, cfg) and save_sd3_checkpoint(model, path) for SD3's
single-file layout.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Union

import torch

from . import safetensors_io, state_map, torch_pickle


def load_state_dict(path) -> Dict[str, torch.Tensor]:
    path = Path(path)
    if path.suffix == ".safetensors":
        return safetensors_io.load_state_dict(path)
    return torch_pickle.load_state_dict(path)


def load_sd_params(path, cfg=None, *, device: Union[str, torch.device] = "cuda",
                   dtype: torch.dtype = torch.bfloat16):
    """A full SD1.x / SD2.x checkpoint -> a StableDiffusion on ``device``
    (the GPU unless the caller asks for the CPU) in ``dtype``, its text
    encoder in OpenCLIP's layout (``cond_stage_model.model.*``, SD2.x) or
    HF's (SD1.x)."""
    from ..pipeline import sd as sd_pipeline

    cfg = cfg or sd_pipeline.SD15
    state = load_state_dict(path)
    model = sd_pipeline.StableDiffusion(cfg, device=device, dtype=dtype, seed=None)
    state_map.sd_from_state(state, model)
    return model


def save_sd_checkpoint(model, path, cfg=None, *, dtype: Optional[torch.dtype] = None) -> None:
    """Write ``model`` as an SD-format .safetensors checkpoint (CLIP in the
    HF layout, as the JAX package writes it); ``dtype`` casts the floating
    tensors on the way out (fp16, as published checkpoints are). ``cfg``
    must be the model's own."""
    if cfg is not None and cfg != model.cfg:
        raise ValueError("save_sd_checkpoint: cfg is not the model's config")
    state = state_map.sd_state_from_params(model)
    if dtype is not None:
        state = {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}
    safetensors_io.save_state_dict(state, path)


def load_controlnet_params(path, cfg=None, *, device: Union[str, torch.device] = "cuda",
                           dtype: torch.dtype = torch.bfloat16):
    """A ControlNet checkpoint (``control_model.*``, .safetensors or a
    torch-zip .ckpt / .pth) -> a models.controlnet.ControlNet of ``cfg``'s
    UNet (SD1.5's by default) on ``device`` (the GPU unless the caller asks
    for the CPU) in ``dtype``; the hint's channels are read from the file.
    Pair with sd.generate(..., control=(controlnet, hint, scale))."""
    from ..models import controlnet as cn_model
    from ..models import unet as unet_model

    cfg = cfg or unet_model.SD15_CONFIG
    state = load_state_dict(path)
    first = f"{state_map.CONTROLNET_PREFIX}.input_hint_block.0.weight"
    if first not in state:
        raise KeyError(f"controlnet: the checkpoint has no {first!r}")
    model = cn_model.ControlNet(cfg, hint_channels=state[first].shape[1], device=device,
                                dtype=dtype, seed=None)
    state_map.controlnet_from_state(state, model)
    return model


def save_controlnet_checkpoint(model, path, *, dtype: Optional[torch.dtype] = None) -> None:
    """Write a ControlNet as a ``control_model.*`` .safetensors file;
    ``dtype`` casts the tensors on the way out (fp16, as published
    ControlNets are)."""
    state = state_map.controlnet_to_state(model)
    if dtype is not None:
        state = {k: v.to(dtype) for k, v in state.items()}
    safetensors_io.save_state_dict(state, path)


def load_sdxl_params(path, cfg=None, *, device: Union[str, torch.device] = "cuda",
                     dtype: torch.dtype = torch.bfloat16):
    """An SDXL-base checkpoint (.safetensors or torch-zip) -> a
    pipeline.sdxl.StableDiffusionXL on ``device`` (the GPU unless the caller
    asks for the CPU) in ``dtype``."""
    from ..pipeline import sdxl as sdxl_pipeline

    cfg = cfg or sdxl_pipeline.SDXL_BASE
    state = load_state_dict(path)
    model = sdxl_pipeline.StableDiffusionXL(cfg, device=device, dtype=dtype, seed=None)
    state_map.sdxl_params_from_state(state, model)
    return model


def save_sdxl_checkpoint(model, path, *, dtype: Optional[torch.dtype] = None) -> None:
    """Write a StableDiffusionXL as an SDXL-layout .safetensors file;
    ``dtype`` casts the floating tensors on the way out."""
    state = state_map.sdxl_state_from_params(model)
    if dtype is not None:
        state = {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}
    safetensors_io.save_state_dict(state, path)


def load_sd3_params(path, cfg=None, *, device: Union[str, torch.device] = "cuda",
                    dtype: torch.dtype = torch.bfloat16):
    """An SD3 single-file checkpoint (.safetensors or torch-zip) -> a
    pipeline.sd3.StableDiffusion3 on ``device`` (the GPU unless the caller
    asks for the CPU) in ``dtype``; its MMDiT holds a learned pos_embed
    exactly when the file has one (cropped to ``cfg``'s grid)."""
    from ..pipeline import sd3 as sd3_pipeline

    cfg = cfg or sd3_pipeline.SD3_MEDIUM_CFG
    state = load_state_dict(path)
    if cfg.t5 is not None and not any(k.startswith(state_map.T5_PREFIX + ".") for k in state):
        cfg = dataclasses.replace(cfg, t5=None)  # the file has no T5 tower: build none
    model = sd3_pipeline.StableDiffusion3(
        cfg, device=device, dtype=dtype, seed=None,
        learned_pos_embed=f"{state_map.MMDIT_PREFIX}.pos_embed" in state)
    state_map.sd3_params_from_state(state, model)
    return model


def save_sd3_checkpoint(model, path, *, dtype: Optional[torch.dtype] = None) -> None:
    """Write a StableDiffusion3 as an SD3 single-file .safetensors
    checkpoint; ``dtype`` casts the floating tensors on the way out."""
    state = state_map.sd3_state_from_params(model)
    if dtype is not None:
        state = {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}
    safetensors_io.save_state_dict(state, path)
