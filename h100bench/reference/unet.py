"""The latent-diffusion UNet of Stable Diffusion 1.x (Rombach et al. 2022,
``v1-inference.yaml``), plain float32, NCHW.

Levels of ``model_channels * mult`` channels, ``num_res_blocks`` ResBlocks
each, a SpatialTransformer after each ResBlock of an attention level, a
stride-2 conv between levels; the middle is ResBlock, transformer,
ResBlock; the decoder has one more ResBlock per level, each on the
concatenation [x, skip], and a nearest 2x upsample and conv closing each
level but the last. ResBlock GroupNorms eps 1e-5, the transformer's
GroupNorm eps 1e-6, its layer norms eps 1e-5; the feed-forward is GEGLU
(the projection's first half times GELU of its second half).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from . import nn
from .clip import Spec, conv, linear, norm


def plan(u: dict):
    """(input blocks, middle, output blocks), each block a list of items:
    ("conv_in",), ("res", cin, cout), ("attn", ch), ("down", ch), ("up", ch)."""
    ch = u["model_channels"]
    mults = u["channel_mult"]
    inp: List[list] = [[("conv_in",)]]
    skips = [ch]
    for level, mult in enumerate(mults):
        out_ch = mult * u["model_channels"]
        for _ in range(u["num_res_blocks"]):
            block = [("res", ch, out_ch)]
            ch = out_ch
            if level in u["attention_levels"]:
                block.append(("attn", ch))
            inp.append(block)
            skips.append(ch)
        if level != len(mults) - 1:
            inp.append([("down", ch)])
            skips.append(ch)
    mid = [("res", ch, ch), ("attn", ch), ("res", ch, ch)]
    outp: List[list] = []
    for level, mult in reversed(list(enumerate(mults))):
        out_ch = mult * u["model_channels"]
        for i in range(u["num_res_blocks"] + 1):
            block = [("res", ch + skips.pop(), out_ch)]
            ch = out_ch
            if level in u["attention_levels"]:
                block.append(("attn", ch))
            if level != 0 and i == u["num_res_blocks"]:
                block.append(("up", ch))
            outp.append(block)
    return inp, mid, outp


def _blocks(u):
    inp, mid, outp = plan(u)
    for i, block in enumerate(inp):
        yield f"input.{i}", block
    yield "middle", mid
    for i, block in enumerate(outp):
        yield f"output.{i}", block


def spec(u: dict, prefix: str) -> Spec:
    mc, emb = u["model_channels"], 4 * u["model_channels"]
    depth, ctx = u["transformer_depth"], u["context_dim"]
    out = linear(f"{prefix}.time_embed.fc1", mc, emb) + linear(f"{prefix}.time_embed.fc2", emb, emb)
    for bname, block in _blocks(u):
        for j, item in enumerate(block):
            p = f"{prefix}.{bname}.{j}" if bname != "middle" else f"{prefix}.middle.{j}"
            kind = item[0]
            if kind == "conv_in":
                out += conv(p, u["in_channels"], mc, 3)
            elif kind == "res":
                _, cin, cout = item
                out += norm(f"{p}.norm1", cin) + conv(f"{p}.conv1", cin, cout, 3)
                out += linear(f"{p}.emb", emb, cout)
                out += norm(f"{p}.norm2", cout) + conv(f"{p}.conv2", cout, cout, 3)
                if cin != cout:
                    out += conv(f"{p}.skip", cin, cout, 1)
            elif kind == "attn":
                c = item[1]
                out += norm(f"{p}.norm", c) + conv(f"{p}.proj_in", c, c, 1)
                for k in range(depth):
                    b = f"{p}.blocks.{k}"
                    out += norm(f"{b}.norm1", c)
                    for a, kv in (("attn1", c), ("attn2", ctx)):
                        out += linear(f"{b}.{a}.to_q", c, c, bias=False)
                        out += linear(f"{b}.{a}.to_k", kv, c, bias=False)
                        out += linear(f"{b}.{a}.to_v", kv, c, bias=False)
                        out += linear(f"{b}.{a}.to_out", c, c)
                        if a == "attn1":
                            out += norm(f"{b}.norm2", c)
                    out += norm(f"{b}.norm3", c)
                    out += linear(f"{b}.ff.proj", c, 8 * c) + linear(f"{b}.ff.out", 4 * c, c)
                out += conv(f"{p}.proj_out", c, c, 1)
            else:
                out += conv(f"{p}.conv", item[1], item[1], 3)
    out += norm(f"{prefix}.out_norm", mc)
    return out + conv(f"{prefix}.out_conv", mc, u["out_channels"], 3)


def _res(P, W, p, u, x, emb):
    g = u["num_groups"]
    h = nn.conv(P, W, f"{p}.conv1", nn.silu(nn.group_norm(W, f"{p}.norm1", x, g, 1e-5)), padding=1)
    h = h + nn.linear(P, W, f"{p}.emb", nn.silu(emb))[:, :, None, None]
    h = nn.conv(P, W, f"{p}.conv2", nn.silu(nn.group_norm(W, f"{p}.norm2", h, g, 1e-5)), padding=1)
    if f"{p}.skip.weight" in W:
        x = nn.conv(P, W, f"{p}.skip", x)
    return x + h


def _xattn(P, W, p, x, ctx, n_heads):
    q = nn.heads(nn.linear(P, W, f"{p}.to_q", x), n_heads)
    k = nn.heads(nn.linear(P, W, f"{p}.to_k", ctx), n_heads)
    v = nn.heads(nn.linear(P, W, f"{p}.to_v", ctx), n_heads)
    return nn.linear(P, W, f"{p}.to_out", nn.merge_heads(nn.attention(q, k, v)))


def _transformer(P, W, p, u, x, ctx):
    n, c, h, w = x.shape
    x_in = x
    x = nn.conv(P, W, f"{p}.proj_in", nn.group_norm(W, f"{p}.norm", x, u["num_groups"], 1e-6))
    x = x.flatten(2).transpose(1, 2)  # (n, h*w, c)
    for k in range(u["transformer_depth"]):
        b = f"{p}.blocks.{k}"
        hn = nn.layer_norm(W, f"{b}.norm1", x)
        x = x + _xattn(P, W, f"{b}.attn1", hn, hn, u["num_heads"])
        x = x + _xattn(P, W, f"{b}.attn2", nn.layer_norm(W, f"{b}.norm2", x), ctx, u["num_heads"])
        gx, gate = nn.linear(P, W, f"{b}.ff.proj", nn.layer_norm(W, f"{b}.norm3", x)).chunk(2, -1)
        x = x + nn.linear(P, W, f"{b}.ff.out", gx * nn.gelu_erf(gate))
    x = x.transpose(1, 2).reshape(n, c, h, w)
    return nn.conv(P, W, f"{p}.proj_out", x) + x_in


def _run(P, W, p, block, u, x, emb, ctx):
    for j, item in enumerate(block):
        q = f"{p}.{j}"
        kind = item[0]
        if kind == "conv_in":
            x = nn.conv(P, W, q, x, padding=1)
        elif kind == "res":
            x = _res(P, W, q, u, x, emb)
        elif kind == "attn":
            x = _transformer(P, W, q, u, x, ctx)
        elif kind == "down":
            x = nn.conv(P, W, f"{q}.conv", x, stride=2, padding=1)
        else:
            x = nn.conv(P, W, f"{q}.conv", F.interpolate(x, scale_factor=2, mode="nearest"),
                        padding=1)
    return x


def forward(P: nn.Prec, W, u: dict, prefix: str, x: torch.Tensor, t: torch.Tensor,
            ctx: torch.Tensor) -> torch.Tensor:
    """x (B, C, h, w), t (B,) float timesteps, ctx (B, T, context_dim) ->
    the noise prediction (B, C, h, w)."""
    inp, mid, outp = plan(u)
    temb = nn.timestep_embedding(t, u["model_channels"])
    emb = nn.linear(P, W, f"{prefix}.time_embed.fc2",
                    nn.silu(nn.linear(P, W, f"{prefix}.time_embed.fc1", temb)))
    skips = []
    for i, block in enumerate(inp):
        x = _run(P, W, f"{prefix}.input.{i}", block, u, x, emb, ctx)
        skips.append(x)
    x = _run(P, W, f"{prefix}.middle", mid, u, x, emb, ctx)
    for i, block in enumerate(outp):
        x = _run(P, W, f"{prefix}.output.{i}", block, u, torch.cat([x, skips.pop()], 1), emb, ctx)
    x = nn.silu(nn.group_norm(W, f"{prefix}.out_norm", x, u["num_groups"], 1e-5))
    return nn.conv(P, W, f"{prefix}.out_conv", x, padding=1)
