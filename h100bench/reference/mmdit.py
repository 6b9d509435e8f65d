"""MMDiT, the multimodal diffusion transformer of Stable Diffusion 3
(Esser et al. 2024), plain float32, on the served model's layout.

Image latents are patchified by a p x p stride-p conv and get a fixed 2-D
sin-cos position embedding (row half, then column half, each sin then
cos); the text context is projected to the model width. Each block has
two streams, image and text, each with its own adaLN modulation
(shift, scale, gate for attention and for the MLP, from SiLU of the
conditioning vector c), layer norms without affine (eps 1e-5), a fused
qkv projection laid out head by head ([h0: q k v | h1: q k v | ...]), an
output projection and a tanh-GELU MLP of ratio 4. Both streams meet in
one attention over the image tokens followed by the text tokens. c is
the MLP of the timestep embedding (t * 1000, 256 wide) plus the MLP of
the pooled text vector. The final layer modulates the image stream,
projects it to p * p * C and unpatchifies it.

Departure from the published SD3-medium, as the served model has it: the
text stream of the last block runs its whole block (the published model
stops it after the attention); the image tokens read nothing from that
part, so the output is the same.
"""
from __future__ import annotations

import math

import torch

from . import nn
from .clip import Spec, conv, linear


def spec(m: dict, prefix: str) -> Spec:
    d, p = m["dim"], m["patch_size"]
    out = conv(f"{prefix}.patch_embed", m["in_channels"], d, p)
    out += linear(f"{prefix}.context_embed", m["context_dim"], d)
    out += linear(f"{prefix}.time_mlp.fc1", 256, d) + linear(f"{prefix}.time_mlp.fc2", d, d)
    out += linear(f"{prefix}.pooled_mlp.fc1", m["pooled_dim"], d)
    out += linear(f"{prefix}.pooled_mlp.fc2", d, d)
    hid = m["mlp_ratio"] * d
    for i in range(m["depth"]):
        for s in ("img", "txt"):
            q = f"{prefix}.blocks.{i}.{s}"
            out += linear(f"{q}.mod", d, 6 * d) + linear(f"{q}.qkv", d, 3 * d)
            out += linear(f"{q}.proj", d, d)
            out += linear(f"{q}.mlp.fc1", d, hid) + linear(f"{q}.mlp.fc2", hid, d)
    out += linear(f"{prefix}.final.mod", d, 2 * d)
    out += linear(f"{prefix}.final.proj", d, p * p * m["out_channels"])
    return out


def pos_embed(n: int, dim: int, device) -> torch.Tensor:
    """(n*n, dim): token (i, j) gets [e(i) | e(j)], e(x) = [sin(x w) | cos(x w)]
    with w_k = 10000^(-k / (dim/4))."""
    quarter = dim // 4
    omega = torch.exp(-math.log(10000.0)
                      * torch.arange(quarter, dtype=torch.float32, device=device) / quarter)
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None] * omega[None]
    e = torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)  # (n, dim/2)
    rows = e[:, None, :].expand(n, n, dim // 2)
    cols = e[None, :, :].expand(n, n, dim // 2)
    return torch.cat([rows, cols], dim=-1).reshape(n * n, dim)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


def forward(P: nn.Prec, W, m: dict, prefix: str, x: torch.Tensor, t: torch.Tensor,
            ctx: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """x (B, C, h, w) latents, t (B,) flow times in [0, 1], ctx (B, T,
    context_dim), pooled (B, pooled_dim) -> velocity (B, C, h, w)."""
    b, _, h, w = x.shape
    p, d, nh = m["patch_size"], m["dim"], m["num_heads"]
    img = nn.conv(P, W, f"{prefix}.patch_embed", x, stride=p).flatten(2).transpose(1, 2)
    img = img + pos_embed(h // p, d, x.device)[None]
    txt = nn.linear(P, W, f"{prefix}.context_embed", ctx)
    temb = nn.timestep_embedding(t * 1000.0, 256)
    c = nn.linear(P, W, f"{prefix}.time_mlp.fc2",
                  nn.silu(nn.linear(P, W, f"{prefix}.time_mlp.fc1", temb)))
    c = c + nn.linear(P, W, f"{prefix}.pooled_mlp.fc2",
                      nn.silu(nn.linear(P, W, f"{prefix}.pooled_mlp.fc1", pooled)))
    sc = nn.silu(c)
    ti = img.shape[1]
    for i in range(m["depth"]):
        streams, qkv = [], []
        for s, tok in (("img", img), ("txt", txt)):
            q = f"{prefix}.blocks.{i}.{s}"
            sh1, s1, g1, sh2, s2, g2 = nn.linear(P, W, f"{q}.mod", sc).chunk(6, dim=-1)
            y = nn.linear(P, W, f"{q}.qkv", _modulate(nn.layer_norm(W, None, tok), sh1, s1))
            y = y.reshape(b, tok.shape[1], nh, 3, d // nh)
            qkv.append([y[:, :, :, j].transpose(1, 2) for j in range(3)])
            streams.append((q, tok, g1, sh2, s2, g2))
        qj, kj, vj = (torch.cat([qkv[0][j], qkv[1][j]], dim=2) for j in range(3))
        o = nn.merge_heads(nn.attention(qj, kj, vj))
        outs = []
        for (q, tok, g1, sh2, s2, g2), part in zip(streams, (o[:, :ti], o[:, ti:])):
            tok = tok + g1[:, None] * nn.linear(P, W, f"{q}.proj", part)
            y = _modulate(nn.layer_norm(W, None, tok), sh2, s2)
            y = nn.linear(P, W, f"{q}.mlp.fc2", nn.gelu_tanh(nn.linear(P, W, f"{q}.mlp.fc1", y)))
            outs.append(tok + g2[:, None] * y)
        img, txt = outs
    shift, scale = nn.linear(P, W, f"{prefix}.final.mod", sc).chunk(2, dim=-1)
    out = nn.linear(P, W, f"{prefix}.final.proj",
                    _modulate(nn.layer_norm(W, None, img), shift, scale))
    hp, wp, co = h // p, w // p, m["out_channels"]
    out = out.reshape(b, hp, wp, p, p, co)  # (b, i, j, pi, pj, c) -> (b, c, i pi, j pj)
    return out.permute(0, 5, 1, 3, 2, 4).reshape(b, co, h, w)
