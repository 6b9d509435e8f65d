"""CLIP text transformer (Radford et al. 2021), plain float32: SD1.5's
conditioning encoder and SD3's CLIP-L / OpenCLIP-bigG towers.

Pre-norm layers with a causal mask; the MLP is quick-GELU (OpenAI CLIP)
or erf GELU (OpenCLIP); layer norms eps 1e-5. The pooled embedding is the
final-norm state at the first end-of-text token (id vocab_size - 1),
through ``text_projection`` when the tower has one.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from . import nn

Spec = List[Tuple[str, tuple, str]]


def spec(c: dict, prefix: str) -> Spec:
    d, m = c["dim"], c["mlp_dim"]
    out = [(f"{prefix}.token_embedding.weight", (c["vocab_size"], d), "emb"),
           (f"{prefix}.position_embedding.weight", (c["max_length"], d), "pos")]
    for i in range(c["num_layers"]):
        p = f"{prefix}.layers.{i}"
        out += norm(f"{p}.layer_norm1", d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += linear(f"{p}.self_attn.{proj}", d, d)
        out += norm(f"{p}.layer_norm2", d)
        out += linear(f"{p}.mlp.fc1", d, m) + linear(f"{p}.mlp.fc2", m, d)
    out += norm(f"{prefix}.final_layer_norm", d)
    if c.get("projection_dim"):
        out.append((f"{prefix}.text_projection.weight", (c["projection_dim"], d), "w"))
    return out


def linear(name: str, din: int, dout: int, bias: bool = True) -> Spec:
    out = [(f"{name}.weight", (dout, din), "w")]
    return out + [(f"{name}.bias", (dout,), "b")] if bias else out


def conv(name: str, cin: int, cout: int, k: int) -> Spec:
    return [(f"{name}.weight", (cout, cin, k, k), "w"), (f"{name}.bias", (cout,), "b")]


def norm(name: str, d: int) -> Spec:
    return [(f"{name}.weight", (d,), "nw"), (f"{name}.bias", (d,), "nb")]


def _layer(P, W, p: str, c: dict, x, mask):
    h = nn.layer_norm(W, f"{p}.layer_norm1", x)
    q, k, v = (nn.heads(nn.linear(P, W, f"{p}.self_attn.{n}", h), c["num_heads"])
               for n in ("q_proj", "k_proj", "v_proj"))
    x = x + nn.linear(P, W, f"{p}.self_attn.out_proj", nn.merge_heads(nn.attention(q, k, v, mask)))
    h = nn.linear(P, W, f"{p}.mlp.fc1", nn.layer_norm(W, f"{p}.layer_norm2", x))
    h = nn.quick_gelu(h) if c["act"] == "quick_gelu" else nn.gelu_erf(h)
    return x + nn.linear(P, W, f"{p}.mlp.fc2", h)


def forward(P: nn.Prec, W, c: dict, prefix: str, ids: torch.Tensor):
    """ids (B, T) -> (final-norm states (B, T, dim), penultimate states
    without the final norm (B, T, dim), pooled (B, projection_dim or dim))."""
    t = ids.shape[1]
    x = (W[f"{prefix}.token_embedding.weight"].float()[ids]
         + W[f"{prefix}.position_embedding.weight"].float()[:t])
    mask = torch.full((t, t), float("-inf"), device=x.device).triu(1)
    penultimate = x
    for i in range(c["num_layers"]):
        if i == c["num_layers"] - 1:
            penultimate = x
        x = _layer(P, W, f"{prefix}.layers.{i}", c, x, mask)
    final = nn.layer_norm(W, f"{prefix}.final_layer_norm", x)
    eot = (ids == c["vocab_size"] - 1).int().argmax(dim=-1)
    pooled = final[torch.arange(ids.shape[0], device=ids.device), eot]
    if c.get("projection_dim"):
        pooled = nn.linear(P, W, f"{prefix}.text_projection", pooled)
    return final, penultimate, pooled
