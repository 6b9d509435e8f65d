"""The KL autoencoder of latent diffusion (Rombach et al. 2022), plain
float32, NCHW: the decoder that turns latents into images, and the
encoder's parameter list (the served model holds it, the decode does not
run it).

``channel_mult`` lists the channels from the image side, base times
(1, 1, 2, 4, 4) for SD: the encoder's stages go from each entry to the
next; the decoder runs them back, three ResBlocks a stage and a nearest
2x upsample and conv on all but the last. Every GroupNorm has eps 1e-6;
the middle is ResBlock, single-head attention, ResBlock. The latent is
first unscaled, z / scale_factor + shift_factor, and, where the config
has quant convs, passed through post_quant_conv.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import nn
from .clip import Spec, conv, norm


def _chs(v):
    return [v["base_channels"] * m for m in v["channel_mult"]]


def _resnet_spec(p, cin, cout) -> Spec:
    out = norm(f"{p}.norm1", cin) + conv(f"{p}.conv1", cin, cout, 3)
    out += norm(f"{p}.norm2", cout) + conv(f"{p}.conv2", cout, cout, 3)
    return out + (conv(f"{p}.nin_shortcut", cin, cout, 1) if cin != cout else [])


def _mid_spec(p, c) -> Spec:
    out = _resnet_spec(f"{p}.block_1", c, c) + norm(f"{p}.attn_1.norm", c)
    for n in ("q", "k", "v", "proj_out"):
        out += conv(f"{p}.attn_1.{n}", c, c, 1)
    return out + _resnet_spec(f"{p}.block_2", c, c)


def up_stages(v):
    """(cin, cout, upsample) of decoder stage i, for i = 0 .. n-1; the
    decode runs them from the last to the first."""
    souts = _chs(v)[1:]
    return [(souts[i + 1] if i + 1 < len(souts) else souts[-1], souts[i], i != 0)
            for i in range(len(souts))]


def spec(v: dict, prefix: str) -> Spec:
    chs, lc = _chs(v), v["latent_channels"]
    d = f"{prefix}.decoder"
    out = conv(f"{d}.conv_in", lc, chs[-1], 3) + _mid_spec(f"{d}.mid", chs[-1])
    for i, (cin, cout, up) in enumerate(up_stages(v)):
        for j, (a, b) in enumerate(((cin, cout), (cout, cout), (cout, cout))):
            out += _resnet_spec(f"{d}.up.{i}.block.{j}", a, b)
        if up:
            out += conv(f"{d}.up.{i}.upsample", cout, cout, 3)
    out += norm(f"{d}.norm_out", chs[1]) + conv(f"{d}.conv_out", chs[1], v["in_channels"], 3)
    if v["use_quant_conv"]:
        out += conv(f"{prefix}.post_quant_conv", lc, lc, 1)
    e = f"{prefix}.encoder"
    out += conv(f"{e}.conv_in", v["in_channels"], chs[0], 3)
    stages = list(zip(chs[:-1], chs[1:]))
    for i, (cin, cout) in enumerate(stages):
        out += _resnet_spec(f"{e}.down.{i}.block.0", cin, cout)
        out += _resnet_spec(f"{e}.down.{i}.block.1", cout, cout)
        if i != len(stages) - 1:
            out += conv(f"{e}.down.{i}.downsample", cout, cout, 3)
    out += _mid_spec(f"{e}.mid", chs[-1]) + norm(f"{e}.norm_out", chs[-1])
    out += conv(f"{e}.conv_out", chs[-1], 2 * lc, 3)
    if v["use_quant_conv"]:
        out += conv(f"{prefix}.quant_conv", 2 * lc, 2 * lc, 1)
    return out


def _resnet(P, W, p, x, g):
    h = nn.conv(P, W, f"{p}.conv1", nn.silu(nn.group_norm(W, f"{p}.norm1", x, g, 1e-6)), padding=1)
    h = nn.conv(P, W, f"{p}.conv2", nn.silu(nn.group_norm(W, f"{p}.norm2", h, g, 1e-6)), padding=1)
    if f"{p}.nin_shortcut.weight" in W:
        x = nn.conv(P, W, f"{p}.nin_shortcut", x)
    return x + h


def _attn(P, W, p, x, g):
    n, c, h, w = x.shape
    hn = nn.group_norm(W, f"{p}.norm", x, g, 1e-6)
    q, k, v = (nn.conv(P, W, f"{p}.{m}", hn).flatten(2).transpose(1, 2)[:, None]
               for m in ("q", "k", "v"))
    o = nn.attention(q, k, v)[:, 0].transpose(1, 2).reshape(n, c, h, w)
    return x + nn.conv(P, W, f"{p}.proj_out", o)


def decode(P: nn.Prec, W, v: dict, prefix: str, z: torch.Tensor) -> torch.Tensor:
    """Latent (B, C, h, w) as the sampler leaves it -> image in [-1, 1],
    (B, 3, 8h, 8w)."""
    g = v["num_groups"]
    d = f"{prefix}.decoder"
    z = z / v["scale_factor"] + v["shift_factor"]
    if v["use_quant_conv"]:
        z = nn.conv(P, W, f"{prefix}.post_quant_conv", z)
    x = nn.conv(P, W, f"{d}.conv_in", z, padding=1)
    x = _resnet(P, W, f"{d}.mid.block_1", x, g)
    x = _attn(P, W, f"{d}.mid.attn_1", x, g)
    x = _resnet(P, W, f"{d}.mid.block_2", x, g)
    for i, (_, _, up) in reversed(list(enumerate(up_stages(v)))):
        for j in range(3):
            x = _resnet(P, W, f"{d}.up.{i}.block.{j}", x, g)
        if up:
            x = nn.conv(P, W, f"{d}.up.{i}.upsample",
                        F.interpolate(x, scale_factor=2, mode="nearest"), padding=1)
    x = nn.silu(nn.group_norm(W, f"{d}.norm_out", x, g, 1e-6))
    return nn.conv(P, W, f"{d}.conv_out", x, padding=1)
