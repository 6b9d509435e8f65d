"""SD UNet (latent diffusion denoiser), NHWC (port of
tinyfusers_tpu/models/unet.py).

The topology is generated from the config by ``build_plan`` exactly as in
the JAX package; the module tree mirrors the JAX param tree ("input",
"middle", "output" lists of blocks, each a list of per-spec leaves), so
io/from_jax.py loads it by walking both. The plain path only: DeepCache,
ControlNet residuals, FreeU and ADM conditioning come with later parts of
the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from .. import ops
from .layers import Conv, Linear, Norm


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    attention_levels: Tuple[int, ...] = (0, 1, 2)
    transformer_depth: Union[int, Tuple[int, ...]] = 1
    context_dim: int = 768
    num_heads: int = 8
    head_dim: Optional[int] = None
    num_groups: int = 32

    def heads_for(self, ch: int) -> Tuple[int, int]:
        if self.head_dim is not None:
            return ch // self.head_dim, self.head_dim
        return self.num_heads, ch // self.num_heads

    def depth_for(self, level: int) -> int:
        if isinstance(self.transformer_depth, tuple):
            return self.transformer_depth[level]
        return self.transformer_depth


SD15_CONFIG = UNetConfig()

TINY_CONFIG = UNetConfig(
    model_channels=32,
    channel_mult=(1, 2),
    attention_levels=(0, 1),
    context_dim=16,
    num_heads=4,
    num_groups=8,
)


@dataclass(frozen=True)
class ResSpec:
    in_ch: int
    out_ch: int


@dataclass(frozen=True)
class AttnSpec:
    ch: int
    depth: int


@dataclass(frozen=True)
class SampleSpec:
    ch: int
    mode: str  # "down" | "up"


def build_plan(cfg: UNetConfig):
    """(input_blocks, middle, output_blocks), each block a list of specs;
    input/output block boundaries define the skip pushes and pops."""
    ch = cfg.model_channels
    input_blocks: List[list] = [["conv_in"]]
    skip_chs = [ch]
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = mult * cfg.model_channels
        for _ in range(cfg.num_res_blocks):
            block = [ResSpec(ch, out_ch)]
            ch = out_ch
            if level in cfg.attention_levels:
                block.append(AttnSpec(ch, cfg.depth_for(level)))
            input_blocks.append(block)
            skip_chs.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append([SampleSpec(ch, "down")])
            skip_chs.append(ch)

    mid_depth = cfg.depth_for(len(cfg.channel_mult) - 1)
    middle = [ResSpec(ch, ch), AttnSpec(ch, mid_depth), ResSpec(ch, ch)]

    output_blocks: List[list] = []
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        out_ch = mult * cfg.model_channels
        for i in range(cfg.num_res_blocks + 1):
            block = [ResSpec(ch + skip_chs.pop(), out_ch)]
            ch = out_ch
            if level in cfg.attention_levels:
                block.append(AttnSpec(ch, cfg.depth_for(level)))
            if level != 0 and i == cfg.num_res_blocks:
                block.append(SampleSpec(ch, "up"))
            output_blocks.append(block)
    assert not skip_chs
    return input_blocks, middle, output_blocks


# ---------------------------------------------------------------------------
# Modules, named after the JAX param tree
# ---------------------------------------------------------------------------

class ResBlock(nn.Module):
    def __init__(self, spec: ResSpec, emb_ch: int, **kw):
        super().__init__()
        self.norm1 = Norm(spec.in_ch, **kw)
        self.conv1 = Conv(spec.in_ch, spec.out_ch, 3, **kw)
        self.emb = Linear(emb_ch, spec.out_ch, **kw)
        self.norm2 = Norm(spec.out_ch, **kw)
        self.conv2 = Conv(spec.out_ch, spec.out_ch, 3, **kw)
        if spec.in_ch != spec.out_ch:
            self.skip = Conv(spec.in_ch, spec.out_ch, 1, **kw)


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, inner_dim: int, **kw):
        super().__init__()
        self.to_q = Linear(query_dim, inner_dim, bias=False, **kw)
        self.to_k = Linear(context_dim, inner_dim, bias=False, **kw)
        self.to_v = Linear(context_dim, inner_dim, bias=False, **kw)
        self.to_out = Linear(inner_dim, query_dim, **kw)


class _FF(nn.Module):
    def __init__(self, ch: int, **kw):
        super().__init__()
        self.proj = Linear(ch, ch * 4 * 2, **kw)
        self.out = Linear(ch * 4, ch, **kw)


class TransformerBlock(nn.Module):
    def __init__(self, ch: int, cfg: UNetConfig, **kw):
        super().__init__()
        self.norm1 = Norm(ch, **kw)
        self.attn1 = CrossAttention(ch, ch, ch, **kw)
        self.norm2 = Norm(ch, **kw)
        self.attn2 = CrossAttention(ch, cfg.context_dim, ch, **kw)
        self.norm3 = Norm(ch, **kw)
        self.ff = _FF(ch, **kw)


class SpatialTransformer(nn.Module):
    def __init__(self, spec: AttnSpec, cfg: UNetConfig, **kw):
        super().__init__()
        self.norm = Norm(spec.ch, **kw)
        self.proj_in = Conv(spec.ch, spec.ch, 1, **kw)
        self.blocks = nn.ModuleList(
            TransformerBlock(spec.ch, cfg, **kw) for _ in range(spec.depth))
        self.proj_out = Conv(spec.ch, spec.ch, 1, **kw)


class Sample(nn.Module):
    def __init__(self, spec: SampleSpec, **kw):
        super().__init__()
        self.conv = Conv(spec.ch, spec.ch, 3, **kw)


def _block_modules(block, cfg: UNetConfig, emb_ch: int, **kw) -> nn.ModuleList:
    mods = []
    for spec in block:
        if spec == "conv_in":
            mods.append(Conv(cfg.in_channels, cfg.model_channels, 3, **kw))
        elif isinstance(spec, ResSpec):
            mods.append(ResBlock(spec, emb_ch, **kw))
        elif isinstance(spec, AttnSpec):
            mods.append(SpatialTransformer(spec, cfg, **kw))
        elif isinstance(spec, SampleSpec):
            mods.append(Sample(spec, **kw))
        else:
            raise ValueError(spec)
    return nn.ModuleList(mods)


class _TimeEmbed(nn.Module):
    def __init__(self, ch: int, emb_ch: int, **kw):
        super().__init__()
        self.fc1 = Linear(ch, emb_ch, **kw)
        self.fc2 = Linear(emb_ch, emb_ch, **kw)


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig = SD15_CONFIG, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        inp, mid, outp = build_plan(cfg)
        emb_ch = cfg.model_channels * 4
        self.time_embed = _TimeEmbed(cfg.model_channels, emb_ch, **kw)
        self.input = nn.ModuleList(_block_modules(b, cfg, emb_ch, **kw) for b in inp)
        self.middle = _block_modules(mid, cfg, emb_ch, **kw)
        self.output = nn.ModuleList(_block_modules(b, cfg, emb_ch, **kw) for b in outp)
        self.out_norm = Norm(cfg.model_channels, **kw)
        self.out_conv = Conv(cfg.model_channels, cfg.out_channels, 3, **kw)

    def forward(self, x, timesteps, context):
        return apply(self, x, timesteps, context)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, cos-then-sin halves, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _res_apply(p: ResBlock, x, emb, cfg: UNetConfig):
    h = p.conv1(ops.silu(p.norm1.group(x, cfg.num_groups, 1e-5)), padding=1)
    h = h + p.emb(ops.silu(emb))[:, None, None, :]
    h = p.conv2(ops.silu(p.norm2.group(h, cfg.num_groups, 1e-5)), padding=1)
    if hasattr(p, "skip"):
        x = p.skip(x)
    return x + h


def _xattn_apply(p: CrossAttention, x, context, num_heads: int):
    o = ops.sdpa_packed(p.to_q(x), p.to_k(context), p.to_v(context), heads=num_heads)
    return p.to_out(o)


def _transformer_block_apply(p: TransformerBlock, x, context, num_heads: int):
    h = p.norm1.layer(x)
    x = x + _xattn_apply(p.attn1, h, h, num_heads)
    x = x + _xattn_apply(p.attn2, p.norm2.layer(x), context, num_heads)
    h = p.ff.proj(p.norm3.layer(x))
    gx, gate = h.chunk(2, dim=-1)
    return x + ops.geglu_linear(gx, gate, p.ff.out.w, p.ff.out.bias)


def _attn_apply(p: SpatialTransformer, x, context, cfg: UNetConfig):
    n, h, w, c = x.shape
    num_heads, _ = cfg.heads_for(c)
    x_in = x
    # the SpatialTransformer's GroupNorm uses eps=1e-6, the ResBlocks' 1e-5
    x = p.proj_in(p.norm.group(x, cfg.num_groups, 1e-6)).reshape(n, h * w, c)
    for bp in p.blocks:
        x = _transformer_block_apply(bp, x, context, num_heads)
    return p.proj_out(x.reshape(n, h, w, c)) + x_in


def _run_block(mods, block, x, emb, context, cfg: UNetConfig):
    for p, spec in zip(mods, block):
        if spec == "conv_in":
            x = p(x, padding=1)
        elif isinstance(spec, ResSpec):
            x = _res_apply(p, x, emb, cfg)
        elif isinstance(spec, AttnSpec):
            x = _attn_apply(p, x, context, cfg)
        elif spec.mode == "down":
            x = p.conv(x, stride=2, padding=1)
        else:
            x = p.conv(ops.upsample_nearest_2x(x), padding=1)
    return x


def apply(model: UNet, x: torch.Tensor, timesteps: torch.Tensor,
          context: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C_in) NHWC latents, timesteps (B,) float, context
    (B, S, context_dim) -> noise prediction (B, H, W, C_out)."""
    cfg = model.cfg
    inp, mid, outp = build_plan(cfg)
    t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
    emb = model.time_embed.fc2(ops.silu(model.time_embed.fc1(t_emb)))
    skips = []
    for mods, block in zip(model.input, inp):
        x = _run_block(mods, block, x, emb, context, cfg)
        skips.append(x)
    x = _run_block(model.middle, mid, x, emb, context, cfg)
    for mods, block in zip(model.output, outp):
        x = torch.cat([x, skips.pop()], dim=-1)
        x = _run_block(mods, block, x, emb, context, cfg)
    x = model.out_norm.group(x, cfg.num_groups, 1e-5)
    return model.out_conv(ops.silu(x), padding=1)
