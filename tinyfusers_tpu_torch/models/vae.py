"""VAE (AutoencoderKL) decoder, NHWC (port of tinyfusers_tpu/models/vae.py).

The module tree mirrors the JAX param tree. The decoder and
``post_quant_conv`` are ported; the encoder (used by img2img and
inpainting) comes with a later part of the port. Every norm uses
eps=1e-6.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from .. import ops
from .layers import Conv, Norm


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    base_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 1, 2, 4, 4)
    latent_channels: int = 4
    num_groups: int = 32
    scale_factor: float = 0.18215
    shift_factor: float = 0.0
    use_quant_conv: bool = True

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.channel_mult) - 2)


SD_VAE_CONFIG = VAEConfig()

TINY_VAE_CONFIG = VAEConfig(base_channels=16, channel_mult=(1, 1, 2), num_groups=8)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, **kw):
        super().__init__()
        self.norm1 = Norm(in_ch, **kw)
        self.conv1 = Conv(in_ch, out_ch, 3, **kw)
        self.norm2 = Norm(out_ch, **kw)
        self.conv2 = Conv(out_ch, out_ch, 3, **kw)
        if in_ch != out_ch:
            self.nin_shortcut = Conv(in_ch, out_ch, 1, **kw)


class AttnBlock(nn.Module):
    def __init__(self, ch: int, **kw):
        super().__init__()
        self.norm = Norm(ch, **kw)
        self.q = Conv(ch, ch, 1, **kw)
        self.k = Conv(ch, ch, 1, **kw)
        self.v = Conv(ch, ch, 1, **kw)
        self.proj_out = Conv(ch, ch, 1, **kw)


class Mid(nn.Module):
    def __init__(self, ch: int, **kw):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch, **kw)
        self.attn_1 = AttnBlock(ch, **kw)
        self.block_2 = ResnetBlock(ch, ch, **kw)


class UpStage(nn.Module):
    def __init__(self, cin: int, cout: int, upsample: bool, **kw):
        super().__init__()
        self.block = nn.ModuleList([ResnetBlock(cin, cout, **kw),
                                    ResnetBlock(cout, cout, **kw),
                                    ResnetBlock(cout, cout, **kw)])
        if upsample:
            self.upsample = Conv(cout, cout, 3, **kw)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        chs = [cfg.base_channels * m for m in cfg.channel_mult]
        souts = chs[1:]
        # stage i outputs souts[i]; its input is stage i+1's output
        self.conv_in = Conv(cfg.latent_channels, chs[-1], 3, **kw)
        self.mid = Mid(chs[-1], **kw)
        self.up = nn.ModuleList(
            UpStage(souts[i + 1] if i + 1 < len(souts) else souts[-1], souts[i],
                    upsample=i != 0, **kw)
            for i in range(len(souts)))
        self.norm_out = Norm(souts[0], **kw)
        self.conv_out = Conv(souts[0], cfg.in_channels, 3, **kw)


class AutoencoderKL(nn.Module):
    """The decoder half of the JAX package's VAE param tree."""

    def __init__(self, cfg: VAEConfig = SD_VAE_CONFIG, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.decoder = Decoder(cfg, **kw)
        if cfg.use_quant_conv:
            self.post_quant_conv = Conv(cfg.latent_channels, cfg.latent_channels, 1, **kw)


def _resnet_apply(p: ResnetBlock, x, g: int):
    h = p.conv1(ops.swish(p.norm1.group(x, g, 1e-6)), padding=1)
    h = p.conv2(ops.swish(p.norm2.group(h, g, 1e-6)), padding=1)
    if hasattr(p, "nin_shortcut"):
        x = p.nin_shortcut(x)
    return x + h


def _attnblock_apply(p: AttnBlock, x, g: int):
    """Single-head self-attention over the spatial tokens."""
    n, h, w, c = x.shape
    hn = p.norm.group(x, g, 1e-6)
    q, k, v = (m(hn).reshape(n, 1, h * w, c) for m in (p.q, p.k, p.v))
    o = ops.sdpa(q, k, v)[:, 0].reshape(n, h, w, c)
    return x + p.proj_out(o)


def _mid_apply(p: Mid, x, g: int):
    x = _resnet_apply(p.block_1, x, g)
    x = _attnblock_apply(p.attn_1, x, g)
    return _resnet_apply(p.block_2, x, g)


def decode(model: AutoencoderKL, z: torch.Tensor) -> torch.Tensor:
    """Latent (B, h, w, latent_ch) -> image in [-1, 1], (B, 8h, 8w, 3),
    with the 1/scale_factor pre-scale, shift_factor and post_quant_conv."""
    cfg = model.cfg
    g = cfg.num_groups
    z = z / cfg.scale_factor + cfg.shift_factor
    if cfg.use_quant_conv:
        z = model.post_quant_conv(z)
    p = model.decoder
    x = p.conv_in(z, padding=1)
    x = _mid_apply(p.mid, x, g)
    for stage in reversed(p.up):
        for bp in stage.block:
            x = _resnet_apply(bp, x, g)
        if hasattr(stage, "upsample"):
            x = stage.upsample(ops.upsample_nearest_2x(x), padding=1)
    x = p.norm_out.group(x, g, 1e-6)
    return p.conv_out(ops.swish(x), padding=1)


def to_image(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> uint8 in [0, 255]; the cast truncates, it does not
    round. The arithmetic stays in x's dtype, as in the JAX package."""
    x = torch.clamp((x + 1.0) / 2.0, 0.0, 1.0) * 255.0
    return x.to(torch.uint8)
