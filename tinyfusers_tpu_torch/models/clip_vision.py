"""CLIP vision transformer, the image tower of the CLIP scorer (port of
tinyfusers_tpu/models/clip_vision.py).

HF ``CLIPVisionModel``'s architecture (openai/clip-vit-large-patch14): a
bias-free patch conv at stride ``patch_size``, the class token, learned
positions, a pre layer norm, the text tower's encoder layers
(models/clip.py: quick_gelu, no mask), a post layer norm on the class
state, then CLIPModel's ``visual_projection`` into the joint space. Its
257 tokens at 224² take the math attention route (ops/attention.py: the
kernels start at 1024 queries), as the JAX package's do on the TPU.

Activations are NHWC, as everywhere in the port. ``preprocess`` resizes
with ``F.interpolate(..., antialias=True)``: ``jax.image.resize``
antialiases when it downscales (every SD image going to the scorer is
downscaled to 224²), and torch's default does not (0.5 apart at 512 ->
224 on uint8 / 255 images; 3e-7 with antialias).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..utils import init as pinit
from . import clip
from .layers import Conv, Embedding, Linear, Norm, init_weights


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    act: str = "quick_gelu"
    projection_dim: int = 768    # joint-space width (ViT-L/14: 768)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def text_layer_cfg(self) -> clip.CLIPConfig:
        """The encoder-layer geometry as a text-tower config (the layer
        body is models/clip.py's)."""
        return clip.CLIPConfig(dim=self.dim, num_heads=self.num_heads, mlp_dim=self.mlp_dim,
                               act=self.act)


VIT_L_14 = CLIPVisionConfig()

# Tiny geometry for tests.
TINY_VISION = CLIPVisionConfig(image_size=32, patch_size=8, dim=64, num_layers=2, num_heads=4,
                               mlp_dim=128, projection_dim=48)

# CLIP preprocessing constants (openai/clip-vit-large-patch14 processor).
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPVisionModel(nn.Module):
    """The ViT tower on one device, fp32 by default (the scorer's dtype).

    device defaults to "cuda" and raises without a GPU. seed fills the
    weights with the JAX init's distributions, drawn on the device (the
    class embedding normal * 0.02, after the leaves); seed=None leaves them
    empty for a loader (io/state_map.py, io/from_jax.py)."""

    STACKED = ("layers",)  # one stacked leaf per name in the JAX tree

    def __init__(self, cfg: CLIPVisionConfig = VIT_L_14, *,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32, seed: Optional[int] = 0):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.cfg = cfg
        self.class_embedding = nn.Parameter(torch.empty(cfg.dim, **kw), requires_grad=False)
        self.patch_embedding = Conv(3, cfg.dim, cfg.patch_size, bias=False, **kw)
        self.position_embedding = Embedding(cfg.num_patches + 1, cfg.dim, **kw)
        self.pre_layernorm = Norm(cfg.dim, **kw)
        lcfg = cfg.text_layer_cfg()
        self.layers = nn.ModuleList(clip._Layer(lcfg, **kw) for _ in range(cfg.num_layers))
        self.post_layernorm = Norm(cfg.dim, **kw)
        self.visual_projection = Linear(cfg.dim, cfg.projection_dim, bias=False, **kw)
        if seed is not None:
            pinit.embedding_(self.class_embedding, init_weights(self, seed))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return apply(self, pixels)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) float -> (B, size, size, C): ``jax.image.resize(...,
    "bilinear")``, a triangle filter widened by the scale when it
    downscales (``antialias=True``), on half-pixel centres."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True).permute(0, 2, 3, 1)


def preprocess(images: torch.Tensor, cfg: CLIPVisionConfig = VIT_L_14) -> torch.Tensor:
    """uint8 or float (B, H, W, 3) RGB -> normalized (B, S, S, 3) fp32.

    uint8 is divided by 255, float taken as it is; then a bilinear resize
    to S = ``cfg.image_size`` (antialiased when it downscales, as
    ``jax.image.resize`` is) and ``(x - mean) / std``."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    s = cfg.image_size
    if x.shape[1] != s or x.shape[2] != s:
        x = resize_bilinear(x, s)
    mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGE_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def apply(model: CLIPVisionModel, pixels: torch.Tensor) -> torch.Tensor:
    """Preprocessed pixels (B, S, S, 3) -> joint-space embedding
    (B, projection_dim), not normalized (the scorer normalizes)."""
    cfg = model.cfg
    n = pixels.shape[0]
    x = model.patch_embedding(pixels.to(model.class_embedding.dtype), stride=cfg.patch_size)
    x = x.reshape(n, cfg.num_patches, cfg.dim)
    cls = model.class_embedding.expand(n, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + model.position_embedding.weight[None]
    x = model.pre_layernorm.layer(x)
    lcfg = cfg.text_layer_cfg()
    for layer in model.layers:
        x = clip._layer(layer, x, None, lcfg)
    pooled = model.post_layernorm.layer(x[:, 0])
    return model.visual_projection(pooled)
