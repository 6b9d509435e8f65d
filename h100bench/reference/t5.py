"""The T5-v1.1 encoder (Raffel et al. 2020; the v1.1 checkpoints: gated
GELU feed-forward, no biases), plain float32: FLUX.1's text_encoder_2.

Pre-norm layers: RMS norm (no mean, no bias, eps 1e-6) before the
self-attention and before the feed-forward, each added back to the
residual; a final RMS norm. The attention is not scaled by 1/sqrt(d)
and its logits get a relative position bias shared by every layer: the
bidirectional bucket of (key position - query position), half the
buckets for each direction, exact below half of a direction's buckets
and logarithmic up to ``rel_max_distance`` beyond it, looked up in a
(buckets, heads) table. The feed-forward is gelu_tanh(h wi_0) * (h wi_1),
then wo. No attention mask: FLUX conditions on the padded sequence.
"""
from __future__ import annotations

import math

import torch

from . import nn
from .clip import Spec, linear


def spec(c: dict, prefix: str) -> Spec:
    d, inner, f = c["dim"], c["num_heads"] * c["head_dim"], c["ff_dim"]
    out = [(f"{prefix}.token_embedding.weight", (c["vocab_size"], d), "emb"),
           (f"{prefix}.rel_bias.weight", (c["rel_buckets"], c["num_heads"]), "emb")]
    for i in range(c["num_layers"]):
        p = f"{prefix}.layers.{i}"
        out.append((f"{p}.attn_norm.weight", (d,), "nw"))
        for n in ("q", "k", "v"):
            out += linear(f"{p}.attn.{n}", d, inner, bias=False)
        out += linear(f"{p}.attn.o", inner, d, bias=False)
        out.append((f"{p}.ff_norm.weight", (d,), "nw"))
        out += linear(f"{p}.ff.wi_0", d, f, bias=False) + linear(f"{p}.ff.wi_1", d, f, bias=False)
        out += linear(f"{p}.ff.wo", f, d, bias=False)
    return out + [(f"{prefix}.final_norm.weight", (d,), "nw")]


def buckets(n: int, c: dict, device) -> torch.Tensor:
    """(n, n) bucket ids of key position - query position."""
    pos = torch.arange(n, device=device)
    rel = pos[None, :] - pos[:, None]
    half = c["rel_buckets"] // 2
    exact = half // 2
    dist = rel.abs()
    far = exact + (torch.log(dist.float().clamp_min(1) / exact)
                   / math.log(c["rel_max_distance"] / exact) * (half - exact)).long()
    far = far.clamp(max=half - 1)
    return (rel > 0).long() * half + torch.where(dist < exact, dist, far)


def rms_norm(W, name: str, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * W[name].float()


def forward(P: nn.Prec, W, c: dict, prefix: str, ids: torch.Tensor) -> torch.Tensor:
    """ids (B, T) -> final states (B, T, dim)."""
    t, h = ids.shape[1], c["num_heads"]
    x = W[f"{prefix}.token_embedding.weight"].float()[ids]
    table = W[f"{prefix}.rel_bias.weight"].float()
    bias = table[buckets(t, c, ids.device)].permute(2, 0, 1)[None]  # (1, H, T, T)
    for i in range(c["num_layers"]):
        p = f"{prefix}.layers.{i}"
        y = rms_norm(W, f"{p}.attn_norm.weight", x)
        q, k, v = (nn.heads(nn.linear(P, W, f"{p}.attn.{n}", y), h) for n in ("q", "k", "v"))
        logits = torch.matmul(q, k.transpose(-1, -2)) + bias
        o = nn.merge_heads(torch.matmul(torch.softmax(logits, dim=-1), v))
        x = x + nn.linear(P, W, f"{p}.attn.o", o)
        y = rms_norm(W, f"{p}.ff_norm.weight", x)
        y = nn.gelu_tanh(nn.linear(P, W, f"{p}.ff.wi_0", y)) * nn.linear(P, W, f"{p}.ff.wi_1", y)
        x = x + nn.linear(P, W, f"{p}.ff.wo", y)
    return rms_norm(W, f"{prefix}.final_norm.weight", x)
