"""The FLUX.1 transformer (Black Forest Labs 2024, their reference
``flux/model.py`` and ``flux/modules/layers.py``), plain float32.

Image latents (B, C, H, W) are packed 2 x 2 into tokens, ``b c (h 2)
(w 2) -> b (h w) (c 2 2)``, and projected by ``img_in``; the T5 states
by ``txt_in``. vec = time_in(e(t)) + guidance_in(e(g)) + vector_in(y),
each an MLP (in_layer, SiLU, out_layer), e(x) the sinusoidal embedding
of x * 1000, 256 wide, cos half first. RoPE: the position ids of
[txt ‖ img] (text (0, 0, 0), image (0, row, col)) give each axis i its
angles pos_i * theta^(-2k / d_i), k < d_i / 2, in float64, the axes'
pairs side by side; q and k are rotated on their pairs (2k, 2k+1).

- Double-stream block: for image and for text, Modulation (Linear of
  SiLU(vec) into shift, scale, gate twice), LayerNorm without affine
  eps 1e-6, x (1 + scale) + shift, the fused qkv laid out (K H D), RMS
  norm of q and k over each head (eps 1e-6, a gain each); one attention
  over [txt ‖ img] with RoPE; then for each stream x += gate * proj(attn),
  x += gate * MLP(modulated LayerNorm(x)), the MLP Linear, GELU (tanh),
  Linear of ratio 4.
- Single-stream block on [txt ‖ img]: shift, scale, gate; linear1 of the
  modulated LayerNorm into qkv (K H D) and the MLP's hidden part; RMS
  norms of q and k, attention with RoPE; x += gate * linear2([attn ‖
  gelu_tanh(mlp)]).
- Final layer on the image tokens: shift, scale from
  adaLN_modulation(SiLU(vec)); linear(LayerNorm(x) (1 + scale) + shift).

Departures from BFL's code, none of which changes the arithmetic of a
float32 run: the RMS norm multiplies by its gain before any cast (BFL
casts back to the input's dtype first, a no-op in float32); the
position ids are one (tokens, 3) table for the batch; the timesteps and
guidance arrive in float32.
"""
from __future__ import annotations

import torch

from . import nn
from .clip import Spec, linear
from .mmdit import _modulate
from .t5 import rms_norm


def spec(m: dict, prefix: str) -> Spec:
    d = m["num_attention_heads"] * m["attention_head_dim"]
    hd, hid = m["attention_head_dim"], int(m["mlp_ratio"] * d)
    out = linear(f"{prefix}.img_in", m["in_channels"], d)
    out += linear(f"{prefix}.time_in.in_layer", 256, d)
    out += linear(f"{prefix}.time_in.out_layer", d, d)
    out += linear(f"{prefix}.vector_in.in_layer", m["pooled_projection_dim"], d)
    out += linear(f"{prefix}.vector_in.out_layer", d, d)
    out += linear(f"{prefix}.guidance_in.in_layer", 256, d)
    out += linear(f"{prefix}.guidance_in.out_layer", d, d)
    out += linear(f"{prefix}.txt_in", m["joint_attention_dim"], d)

    def qk(p):
        return [(f"{p}.query_norm.scale", (hd,), "nw"), (f"{p}.key_norm.scale", (hd,), "nw")]

    for i in range(m["num_layers"]):
        for s in ("img", "txt"):
            p = f"{prefix}.double_blocks.{i}.{s}"
            out += linear(f"{p}_mod.lin", d, 6 * d)
            out += linear(f"{p}_attn.qkv", d, 3 * d) + qk(f"{p}_attn.norm")
            out += linear(f"{p}_attn.proj", d, d)
            out += linear(f"{p}_mlp.0", d, hid) + linear(f"{p}_mlp.2", hid, d)
    for i in range(m["num_single_layers"]):
        p = f"{prefix}.single_blocks.{i}"
        out += linear(f"{p}.linear1", d, 3 * d + hid) + linear(f"{p}.linear2", d + hid, d)
        out += qk(f"{p}.norm") + linear(f"{p}.modulation.lin", d, 3 * d)
    out += linear(f"{prefix}.final_layer.linear", d, m["in_channels"])
    return out + linear(f"{prefix}.final_layer.adaLN_modulation.1", d, 2 * d)


def pack(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, HW/4, 4C): b c (h 2) (w 2) -> b (h w) (c 2 2)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, HW/4, 4C) -> (B, C, H, W): b (h w) (c 2 2) -> b c (h 2) (w 2)."""
    b, _, c4 = x.shape
    x = x.reshape(b, h // 2, w // 2, c4 // 4, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c4 // 4, h, w)


def ids(txt_len: int, hp: int, wp: int, device) -> torch.Tensor:
    """(txt_len + hp wp, 3) position ids of [txt ‖ img]."""
    img = torch.zeros(hp, wp, 3, device=device)
    img[..., 1] += torch.arange(hp, device=device)[:, None]
    img[..., 2] += torch.arange(wp, device=device)[None, :]
    return torch.cat([torch.zeros(txt_len, 3, device=device), img.reshape(hp * wp, 3)])


def rope(pos: torch.Tensor, axes: list, theta: float):
    """(cos, sin) (N, sum(axes) / 2) of the angles, float64 -> float32."""
    ang = []
    for i, d in enumerate(axes):
        scale = torch.arange(0, d, 2, dtype=torch.float64, device=pos.device) / d
        ang.append(pos[:, i].double()[:, None] * (1.0 / theta ** scale)[None])
    a = torch.cat(ang, dim=-1)
    return torch.cos(a).float(), torch.sin(a).float()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, N, D) on its pairs (2k, 2k+1)."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = cos * x0 - sin * x1
    out[..., 1::2] = sin * x0 + cos * x1
    return out


def _split_qkv(y: torch.Tensor, heads: int):
    """(B, L, 3 H D) laid out (K H D) -> q, k, v (B, H, L, D)."""
    b, n, _ = y.shape
    y = y.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    return y[0], y[1], y[2]


def _attention(q, k, v, pe):
    return nn.merge_heads(nn.attention(rotate(q, *pe), rotate(k, *pe), v))


def _emb(P, W, p, x):
    return nn.linear(P, W, f"{p}.out_layer", nn.silu(nn.linear(P, W, f"{p}.in_layer", x)))


def forward(P: nn.Prec, W, m: dict, prefix: str, img: torch.Tensor, txt: torch.Tensor,
            pe, t: torch.Tensor, y: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
    """img (B, L, in_channels) packed latents, txt (B, T, joint width), pe
    the RoPE table of [txt ‖ img], t (B,) flow times, y (B, pooled width),
    guidance (B,) -> packed velocity (B, L, in_channels)."""
    heads = m["num_attention_heads"]
    d = heads * m["attention_head_dim"]
    img = nn.linear(P, W, f"{prefix}.img_in", img)
    vec = _emb(P, W, f"{prefix}.time_in", nn.timestep_embedding(t * 1000.0, 256))
    vec = vec + _emb(P, W, f"{prefix}.guidance_in", nn.timestep_embedding(guidance * 1000.0, 256))
    vec = vec + _emb(P, W, f"{prefix}.vector_in", y)
    txt = nn.linear(P, W, f"{prefix}.txt_in", txt)
    sv = nn.silu(vec)
    nt = txt.shape[1]
    for i in range(m["num_layers"]):
        p = f"{prefix}.double_blocks.{i}"
        mods, qkv = {}, {}
        for s, x in (("img", img), ("txt", txt)):
            mods[s] = nn.linear(P, W, f"{p}.{s}_mod.lin", sv).chunk(6, dim=-1)
            q, k, v = _split_qkv(nn.linear(P, W, f"{p}.{s}_attn.qkv",
                                           _modulate(nn.layer_norm(W, None, x, 1e-6),
                                                     mods[s][0], mods[s][1])), heads)
            qkv[s] = (rms_norm(W, f"{p}.{s}_attn.norm.query_norm.scale", q),
                      rms_norm(W, f"{p}.{s}_attn.norm.key_norm.scale", k), v)
        q, k, v = (torch.cat([qkv["txt"][j], qkv["img"][j]], dim=2) for j in range(3))
        o = _attention(q, k, v, pe)
        outs = {}
        for s, x, part in (("txt", txt, o[:, :nt]), ("img", img, o[:, nt:])):
            sh1, sc1, g1, sh2, sc2, g2 = mods[s]
            x = x + g1[:, None] * nn.linear(P, W, f"{p}.{s}_attn.proj", part)
            h = _modulate(nn.layer_norm(W, None, x, 1e-6), sh2, sc2)
            h = nn.gelu_tanh(nn.linear(P, W, f"{p}.{s}_mlp.0", h))
            h = nn.linear(P, W, f"{p}.{s}_mlp.2", h)
            outs[s] = x + g2[:, None] * h
        img, txt = outs["img"], outs["txt"]
    x = torch.cat([txt, img], dim=1)
    for i in range(m["num_single_layers"]):
        p = f"{prefix}.single_blocks.{i}"
        shift, scale, gate = nn.linear(P, W, f"{p}.modulation.lin", sv).chunk(3, dim=-1)
        h = _modulate(nn.layer_norm(W, None, x, 1e-6), shift, scale)
        h = nn.linear(P, W, f"{p}.linear1", h)
        q, k, v = _split_qkv(h[..., :3 * d], heads)
        q = rms_norm(W, f"{p}.norm.query_norm.scale", q)
        k = rms_norm(W, f"{p}.norm.key_norm.scale", k)
        o = _attention(q, k, v, pe)
        x = x + gate[:, None] * nn.linear(P, W, f"{p}.linear2",
                                          torch.cat([o, nn.gelu_tanh(h[..., 3 * d:])], dim=-1))
    shift, scale = nn.linear(P, W, f"{prefix}.final_layer.adaLN_modulation.1", sv).chunk(2, dim=-1)
    img = _modulate(nn.layer_norm(W, None, x[:, nt:], 1e-6), shift, scale)
    return nn.linear(P, W, f"{prefix}.final_layer.linear", img)
