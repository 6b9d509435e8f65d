"""T5 encoder stack, T5-v1.1 (SD3's T5-XXL text conditioning; port of
tinyfusers_tpu/models/t5.py).

The JAX package stacks the layers for ``lax.scan``; here they form an
``nn.ModuleList`` (io/from_jax.py splits the stacked leaves). What is kept
exactly as the JAX package does it:

- attention is UNSCALED (scale 1.0), q/k/v/o and the FF have no biases,
  the FF is gated ``gelu_tanh``;
- the relative-position bias table (``rel_bias``, an embedding of
  (buckets, heads)) gives one bias shared by every layer, added to the
  logits in fp32; the bucket ids take their logs in fp32;
- ``_rms_norm`` has fp32 statistics and casts to x's dtype BEFORE the
  weight multiply.

The attention runs through ``ops.sdpa`` with the bias as its additive
mask, so it takes the math route on every device (77 tokens, as
``impl="xla"`` in the JAX package): no kernel is on this path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import ops
from .layers import Embedding, Gain, Linear


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    dim: int = 4096              # d_model
    ff_dim: int = 10240          # d_ff (v1.1 gated)
    num_layers: int = 24
    num_heads: int = 64
    head_dim: int = 64           # d_kv
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.head_dim


T5_XXL = T5Config()

TINY_T5 = T5Config(vocab_size=256, dim=64, ff_dim=128, num_layers=3,
                   num_heads=4, head_dim=16, rel_buckets=8,
                   rel_max_distance=16)


class _Attn(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        d, inner = cfg.dim, cfg.inner_dim
        self.heads = cfg.num_heads
        self.q = Linear(d, inner, bias=False, **kw)
        self.k = Linear(d, inner, bias=False, **kw)
        self.v = Linear(d, inner, bias=False, **kw)
        self.o = Linear(inner, d, bias=False, **kw)


class _FF(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        self.wi_0 = Linear(cfg.dim, cfg.ff_dim, bias=False, **kw)
        self.wi_1 = Linear(cfg.dim, cfg.ff_dim, bias=False, **kw)
        self.wo = Linear(cfg.ff_dim, cfg.dim, bias=False, **kw)


class _Layer(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        self.attn_norm = Gain(cfg.dim, **kw)
        self.attn = _Attn(cfg, **kw)
        self.ff_norm = Gain(cfg.dim, **kw)
        self.ff = _FF(cfg, **kw)


class T5Encoder(nn.Module):
    STACKED = ("layers",)  # one stacked leaf per name in the JAX tree
    # (buckets, heads): cut to this rank's heads under tensor parallelism
    TP_HEAD_TABLES = ("rel_bias",)

    def __init__(self, cfg: T5Config = T5_XXL, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.token_embedding = Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.rel_bias = Embedding(cfg.rel_buckets, cfg.num_heads, **kw)
        self.layers = nn.ModuleList(_Layer(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = Gain(cfg.dim, **kw)

    def forward(self, ids, mask=None):
        return apply(self, ids, mask)


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    h = x.float()
    h = h * torch.rsqrt(h.square().mean(dim=-1, keepdim=True) + eps)
    return h.to(x.dtype) * weight


def _relative_buckets(qlen: int, klen: int, cfg: T5Config) -> torch.Tensor:
    """Bidirectional T5 bucket ids, (qlen, klen) int32, computed on the
    host so that every device gets the same ids."""
    ctx = torch.arange(qlen, dtype=torch.int32)[:, None]
    mem = torch.arange(klen, dtype=torch.int32)[None, :]
    rel = mem - ctx
    nb = cfg.rel_buckets // 2
    buckets = torch.where(rel > 0, nb, 0)
    n = rel.abs()
    max_exact = nb // 2
    # fp32 logs, the denominator's included, as the JAX package takes them
    denom = torch.log(torch.tensor(cfg.rel_max_distance / max_exact, dtype=torch.float32))
    val_large = max_exact + (
        torch.log(n.float() / max_exact) / denom * (nb - max_exact)
    ).to(torch.int32)
    val_large = torch.clamp(val_large, max=nb - 1)
    return (buckets + torch.where(n < max_exact, n, val_large)).to(torch.int32)


def _position_bias(model: T5Encoder, qlen: int, klen: int) -> torch.Tensor:
    """(1, heads, qlen, klen) additive attention bias, shared by layers."""
    table = model.rel_bias.weight  # (buckets, heads)
    buckets = _relative_buckets(qlen, klen, model.cfg).to(table.device)
    return table[buckets.long()].permute(2, 0, 1)[None]


def _layer(p: _Layer, x, bias, cfg: T5Config):
    b, t, _ = x.shape
    h = _rms_norm(x, p.attn_norm.weight, cfg.eps)
    n = p.attn.heads  # this rank's, under tensor parallelism
    heads = lambda z: z.reshape(b, t, n, cfg.head_dim).transpose(1, 2)  # noqa: E731
    a = ops.sdpa(heads(p.attn.q(h)), heads(p.attn.k(h)), heads(p.attn.v(h)),
                 mask=bias, scale=1.0)
    x = x + p.attn.o(a.transpose(1, 2).reshape(b, t, n * cfg.head_dim))
    h = _rms_norm(x, p.ff_norm.weight, cfg.eps)
    h = ops.gelu_tanh(p.ff.wi_0(h)) * p.ff.wi_1(h)
    return x + p.ff.wo(h)


def apply(model: T5Encoder, ids: torch.Tensor,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ids (B, T) int -> final hidden states (B, T, dim).

    mask: optional (B, T) of {0, 1} key-padding mask (1 = attend), folded
    into the shared bias with fp32's lowest value. SD3 conditions on the
    unmasked padded rows, so the default is None."""
    cfg = model.cfg
    t = ids.shape[-1]
    x = ops.embedding(ids, model.token_embedding.weight)
    bias = _position_bias(model, t, t).float()
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        bias = bias + torch.where(mask[:, None, None, :] > 0, 0.0, neg)
    for layer in model.layers:
        x = _layer(layer, x, bias, cfg)
    return _rms_norm(x, model.final_norm.weight, cfg.eps)
