"""CLIP text transformer: SD v1's conditioning encoder, and SD3's CLIP-L
and OpenCLIP-bigG towers (port of tinyfusers_tpu/models/clip.py).

The JAX package stacks its layers on a leading axis for ``lax.scan``;
here they form an ``nn.ModuleList`` (io/from_jax.py splits the stacked
leaves). Attribute names follow the JAX param tree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import ops
from .layers import Embedding, Linear, Norm


@dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 49408
    max_length: int = 77
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    act: str = "quick_gelu"      # "quick_gelu" (CLIP ViT-L) | "gelu" (OpenCLIP)
    projection_dim: int = 0      # >0: text_projection head (no bias)


# OpenCLIP ViT-bigG/14 text tower (SDXL's second encoder, SD3's CLIP-G).
OPENCLIP_BIGG_CONFIG = CLIPConfig(
    dim=1280, num_layers=32, num_heads=20, mlp_dim=5120,
    act="gelu", projection_dim=1280,
)

# SD 2.x conditioning encoder (OpenCLIP ViT-H/14 text tower).
OPENCLIP_H_CONFIG = CLIPConfig(
    dim=1024, num_layers=24, num_heads=16, mlp_dim=4096, act="gelu",
)


class _Attn(nn.Module):
    def __init__(self, dim, heads, **kw):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(dim, dim, **kw)
        self.k_proj = Linear(dim, dim, **kw)
        self.v_proj = Linear(dim, dim, **kw)
        self.out_proj = Linear(dim, dim, **kw)


class _MLP(nn.Module):
    def __init__(self, dim, mlp_dim, **kw):
        super().__init__()
        self.fc1 = Linear(dim, mlp_dim, **kw)
        self.fc2 = Linear(mlp_dim, dim, **kw)


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPConfig, **kw):
        super().__init__()
        self.layer_norm1 = Norm(cfg.dim, **kw)
        self.self_attn = _Attn(cfg.dim, cfg.num_heads, **kw)
        self.layer_norm2 = Norm(cfg.dim, **kw)
        self.mlp = _MLP(cfg.dim, cfg.mlp_dim, **kw)


class CLIPTextModel(nn.Module):
    STACKED = ("layers",)  # one stacked leaf per name in the JAX tree

    def __init__(self, cfg: CLIPConfig = CLIPConfig(), *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.token_embedding = Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.position_embedding = Embedding(cfg.max_length, cfg.dim, **kw)
        self.layers = nn.ModuleList(_Layer(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_layer_norm = Norm(cfg.dim, **kw)
        if cfg.projection_dim:
            self.text_projection = Linear(cfg.dim, cfg.projection_dim, bias=False, **kw)

    def forward(self, input_ids, **kw):
        return apply(self, input_ids, **kw)


def _attn(p: _Attn, x, mask, num_heads: int):
    b, t, d = x.shape
    hd = d // num_heads
    heads = p.heads  # this rank's, under tensor parallelism
    q, k, v = (m(x).reshape(b, t, heads, hd).transpose(1, 2)
               for m in (p.q_proj, p.k_proj, p.v_proj))
    o = ops.sdpa(q, k, v, mask)
    return p.out_proj(o.transpose(1, 2).reshape(b, t, heads * hd))


def _layer(p: _Layer, x, mask, cfg: CLIPConfig):
    x = x + _attn(p.self_attn, p.layer_norm1.layer(x), mask, cfg.num_heads)
    h = p.mlp.fc1(p.layer_norm2.layer(x))
    h = ops.quick_gelu(h) if cfg.act == "quick_gelu" else ops.gelu_erf(h)
    return x + p.mlp.fc2(h)


def apply(
    model: CLIPTextModel,
    input_ids: torch.Tensor,
    *,
    skip_final_norm_layers: int = 0,
    final_norm_on_skip: bool = False,
) -> torch.Tensor:
    """input_ids (B, T) int -> hidden states (B, T, dim).

    skip_final_norm_layers=k returns the input of layer num_layers-k
    ("clip skip") without the final layer norm, or with it when
    final_norm_on_skip is set (SD 2.x penultimate conditioning).
    """
    x = _run(model, input_ids, model.cfg.num_layers - skip_final_norm_layers)
    if skip_final_norm_layers > 0 and not final_norm_on_skip:
        return x
    return model.final_layer_norm.layer(x)


def _run(model: CLIPTextModel, input_ids: torch.Tensor, stop: int,
         x: Optional[torch.Tensor] = None, start: int = 0) -> torch.Tensor:
    """Layers [start, stop) on x, or on the embeddings of input_ids."""
    cfg = model.cfg
    t = input_ids.shape[-1]
    if x is None:
        x = ops.embedding(input_ids, model.token_embedding.weight)
        x = x + model.position_embedding.weight[:t]
    # additive causal mask, -inf above the diagonal
    mask = torch.triu(torch.full((1, 1, t, t), float("-inf"),
                                 device=x.device), diagonal=1)
    for layer in model.layers[start:stop]:
        x = _layer(layer, x, mask, cfg)
    return x


def _pool(model: CLIPTextModel, input_ids: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The final-norm state x at each sequence's EOT, projected."""
    eot = (input_ids == model.cfg.vocab_size - 1).int().argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    if hasattr(model, "text_projection"):
        pooled = model.text_projection(pooled)
    return pooled


def apply_pooled(model: CLIPTextModel, input_ids: torch.Tensor) -> torch.Tensor:
    """Pooled text embedding (B, projection_dim or dim): the final-norm
    hidden state of the full tower at each sequence's EOT position, through
    ``text_projection`` when the tower has one.

    EOT is the FIRST occurrence of the EOT id (vocab_size - 1), not
    argmax(ids) as in HF CLIP (textual-inversion ids extend the vocabulary
    past EOT); a sequence without one pools position 0."""
    return _pool(model, input_ids, apply(model, input_ids))


def apply_penultimate_and_pooled(model: CLIPTextModel, input_ids: torch.Tensor):
    """(``apply(..., skip_final_norm_layers=1)``, ``apply_pooled(...)``)
    from one pass through the tower: SD3's conditioning."""
    n = model.cfg.num_layers
    early = _run(model, input_ids, n - 1)
    last = model.final_layer_norm.layer(_run(model, input_ids, n, early, n - 1))
    return early, _pool(model, input_ids, last)
