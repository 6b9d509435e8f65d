"""SD UNet (latent diffusion denoiser), NHWC (port of
tinyfusers_tpu/models/unet.py).

The topology is generated from the config by ``build_plan`` exactly as in
the JAX package; the module tree mirrors the JAX param tree ("input",
"middle", "output" lists of blocks, each a list of per-spec leaves), so
io/from_jax.py loads it by walking both. ``apply`` takes the JAX
package's extra inputs: SDXL's ADM conditioning (``adm_cond``, into the
``label_emb`` MLP), DeepCache (``deepcache``, ``cache``), ControlNet
residuals (``control``, from models/controlnet.py) and FreeU (``freeu``).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .. import ops
from ..parallel import ring_attention
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
    # SDXL's "text_time" ADM conditioning: the pooled text embedding and the
    # size embeddings through a second MLP, added to the timestep embedding
    adm_in_channels: Optional[int] = None
    # the spatial self-attention's ops.sdpa impl (e.g. "ring:model": ring
    # attention over the mesh's model axis); cross-attention keeps the default
    self_attn_impl: Optional[str] = None

    def heads_for(self, ch: int) -> Tuple[int, int]:
        if self.head_dim is not None:
            return ch // self.head_dim, self.head_dim
        return self.num_heads, ch // self.num_heads

    def depth_for(self, level: int) -> int:
        if isinstance(self.transformer_depth, tuple):
            return self.transformer_depth[level]
        return self.transformer_depth


SD15_CONFIG = UNetConfig()

# SD 2.x: 64-wide heads (5 / 10 / 20 of them), OpenCLIP-H context.
SD21_CONFIG = UNetConfig(context_dim=1024, num_heads=-1, head_dim=64)

# SD 1.5 inpainting: the input is latent (4) + mask (1) + masked latent (4).
SD15_INPAINT_CONFIG = UNetConfig(in_channels=9)

# SDXL-base: 3 levels, transformer depths (0, 2, 10), 64-wide heads, the
# two text towers' 2048-wide context, ADM 2816 = 1280 pooled + 6 * 256.
SDXL_CONFIG = UNetConfig(
    channel_mult=(1, 2, 4),
    attention_levels=(1, 2),
    transformer_depth=(0, 2, 10),
    context_dim=2048,
    num_heads=-1,
    head_dim=64,
    adm_in_channels=2816,
)

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
    """impl: the ops.sdpa impl of this attention (None: the default route)."""

    def __init__(self, query_dim: int, context_dim: int, inner_dim: int, heads: int,
                 impl: Optional[str] = None, **kw):
        super().__init__()
        self.heads = heads
        self.impl = impl
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
        heads, _ = cfg.heads_for(ch)
        self.norm1 = Norm(ch, **kw)
        self.attn1 = CrossAttention(ch, ch, ch, heads, cfg.self_attn_impl, **kw)
        self.norm2 = Norm(ch, **kw)
        self.attn2 = CrossAttention(ch, cfg.context_dim, ch, heads, **kw)
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
    """fc2(silu(fc1(.))): the timestep MLP, and SDXL's ADM MLP (label_emb)."""

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
        if cfg.adm_in_channels:
            self.label_emb = _TimeEmbed(cfg.adm_in_channels, emb_ch, **kw)
        self.input = nn.ModuleList(_block_modules(b, cfg, emb_ch, **kw) for b in inp)
        self.middle = _block_modules(mid, cfg, emb_ch, **kw)
        self.output = nn.ModuleList(_block_modules(b, cfg, emb_ch, **kw) for b in outp)
        self.out_norm = Norm(cfg.model_channels, **kw)
        self.out_conv = Conv(cfg.model_channels, cfg.out_channels, 3, **kw)

    def forward(self, x, timesteps, context, adm_cond=None):
        return apply(self, x, timesteps, context, adm_cond=adm_cond)


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


def _xattn_apply(p: CrossAttention, x, context):
    # p.heads: this rank's under tensor parallelism (parallel/sharding.py)
    if ring_attention.is_ring(p.impl):
        return _ring_self_attn_apply(p, x)
    o = ops.sdpa_packed(p.to_q(x), p.to_k(context), p.to_v(context), heads=p.heads,
                        impl=p.impl)
    return p.to_out(o)


def _ring_self_attn_apply(p: CrossAttention, x):
    """A self-attention on the ring of its impl: this rank projects its own
    rows of the sequence, attends over all of it and gathers the rows."""
    sp = ring_attention.split_for(x.shape[1], p.impl)
    xl = x[:, sp.lo:sp.hi]
    b, s, c = xl.shape
    unpack = lambda t: t.reshape(b, s, p.heads, -1).transpose(1, 2)  # noqa: E731
    o = sp.attend(unpack(p.to_q(xl)), unpack(p.to_k(xl)), unpack(p.to_v(xl)))
    return sp.gather(p.to_out(o.transpose(1, 2).reshape(b, s, -1)), dim=1)


def _transformer_block_apply(p: TransformerBlock, x, context):
    h = p.norm1.layer(x)
    x = x + _xattn_apply(p.attn1, h, h)
    x = x + _xattn_apply(p.attn2, p.norm2.layer(x), context)
    h = p.ff.proj(p.norm3.layer(x))
    # [gx | gate]: under TP this rank's columns of each half
    gx, gate = h.chunk(2, dim=-1)
    return x + p.ff.out.geglu(gx, gate)


def _attn_apply(p: SpatialTransformer, x, context, cfg: UNetConfig):
    n, h, w, c = x.shape
    x_in = x
    # the SpatialTransformer's GroupNorm uses eps=1e-6, the ResBlocks' 1e-5
    x = p.proj_in(p.norm.group(x, cfg.num_groups, 1e-6)).reshape(n, h * w, c)
    for bp in p.blocks:
        x = _transformer_block_apply(bp, x, context)
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


@functools.lru_cache(maxsize=None)
def _box_mask(h: int, w: int, threshold: int, scale: float, device: torch.device):
    """(1, h, w, 1) fp32: ``scale`` inside the centred box |i - h//2| <
    threshold (strict, as the JAX package's), 1 outside. Made once per
    shape and device: a mask built from device scalars on every call would
    copy them from the host, each copy a wait for the card."""
    rows = (torch.arange(h) - h // 2).abs() < threshold
    cols = (torch.arange(w) - w // 2).abs() < threshold
    mask = torch.where(rows[:, None] & cols[None, :], scale, 1.0).float()
    return mask[None, :, :, None].to(device)


def _fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the low-frequency (centered) box of an NHWC feature map's 2-D
    FFT by ``scale`` (FreeU's skip filter): complex64 FFT over H and W, the
    real part cast back to x's dtype. The box is |i - h//2| < threshold
    (strict), so threshold = 1 scales the DC bin alone."""
    f = torch.fft.fftshift(torch.fft.fft2(x.to(torch.complex64), dim=(1, 2)), dim=(1, 2))
    f = f * _box_mask(x.shape[1], x.shape[2], threshold, float(scale), x.device)
    out = torch.fft.ifft2(torch.fft.ifftshift(f, dim=(1, 2)), dim=(1, 2))
    return out.real.to(x.dtype)


def _apply_freeu(x: torch.Tensor, skip: torch.Tensor, level: int, freeu):
    """FreeU (Si et al. 2023) on decoder levels 0 (b1, s1) and 1 (b2, s2):
    the first half of the backbone's channels times b (rounded to x's
    dtype first, as the JAX package takes it), the skip's lowest frequency
    times s. Other levels pass through."""
    b1, b2, s1, s2 = freeu
    if level == 0:
        b, s = b1, s1
    elif level == 1:
        b, s = b2, s2
    else:
        return x, skip
    half = x.shape[-1] // 2
    x = torch.cat([x[..., :half] * ops.rounded_to(b, x.dtype), x[..., half:]], dim=-1)
    return x, _fourier_filter(skip, threshold=1, scale=s)


def _add_control(skips: List[torch.Tensor], residuals: Sequence[torch.Tensor]):
    return [s + c.to(s.dtype) for s, c in zip(skips, residuals)]


def apply(model: UNet, x: torch.Tensor, timesteps: torch.Tensor,
          context: torch.Tensor, *, adm_cond: Optional[torch.Tensor] = None,
          deepcache: Optional[Tuple[str, int]] = None,
          cache: Optional[torch.Tensor] = None, control=None,
          freeu: Optional[Tuple[float, float, float, float]] = None):
    """x (B, H, W, C_in) NHWC latents, timesteps (B,) float, context
    (B, S, context_dim) -> noise prediction (B, H, W, C_out).

    adm_cond (B, adm_in_channels): SDXL's conditioning vector (pooled text
    embedding and size embeddings), needed when the config has
    adm_in_channels; label_emb's MLP of it is added to the timestep
    embedding.

    control: (skip residuals, middle residual) from models/controlnet.apply;
    each skip residual is added to its skip as it is popped, the middle one
    after the middle block. In deepcache "shallow" mode control may instead
    be a sequence of (at least) the first m skip residuals: the middle
    residual is already in the cache.

    freeu: (b1, b2, s1, s2), FreeU on the two deepest decoder levels.

    deepcache (DeepCache, Ma et al. 2023): ("full", m) runs everything and
    also returns the hidden state entering the last m output blocks;
    ("shallow", m) runs the first m input and last m output blocks around
    ``cache``. Both return (eps, cache)."""
    cfg = model.cfg
    inp, mid, outp = build_plan(cfg)
    t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
    emb = model.time_embed.fc2(ops.silu(model.time_embed.fc1(t_emb)))
    if cfg.adm_in_channels:
        if adm_cond is None:
            raise ValueError("this UNet config has adm_in_channels: apply needs adm_cond")
        emb = emb + model.label_emb.fc2(ops.silu(model.label_emb.fc1(adm_cond.to(x.dtype))))
    mode, m = deepcache if deepcache is not None else (None, 0)
    if mode is not None and not 1 <= m <= min(len(inp), len(outp)):
        raise ValueError(
            f"deepcache split m={m} out of range: need 1 <= m <= "
            f"{min(len(inp), len(outp))} (input/output block counts "
            f"{len(inp)}/{len(outp)}) — otherwise the cache tap "
            f"j == len(outp)-m is never reached and cache_out stays None")
    per_level = cfg.num_res_blocks + 1
    if mode == "shallow":
        if cache is None:
            raise ValueError("deepcache 'shallow' mode needs cache=")
        skips = []
        for mods, block in zip(model.input[:m], inp[:m]):
            x = _run_block(mods, block, x, emb, context, cfg)
            skips.append(x)
        if control is not None:
            # a (skips, middle) pair, or the skip residuals alone: told apart
            # by the first item, so that two cached residuals are not
            # mistaken for a pair (the JAX package's len(control) == 2 test is)
            pair = isinstance(control, tuple) and not isinstance(control[0], torch.Tensor)
            skips = _add_control(skips, control[0] if pair else control)
        x = cache
        for i, (mods, block) in enumerate(zip(model.output[-m:], outp[-m:])):
            s = skips.pop()
            if freeu is not None:
                x, s = _apply_freeu(x, s, (len(outp) - m + i) // per_level, freeu)
            x = _run_block(mods, block, torch.cat([x, s], dim=-1), emb, context, cfg)
        cache_out = cache
    else:
        skips = []
        for mods, block in zip(model.input, inp):
            x = _run_block(mods, block, x, emb, context, cfg)
            skips.append(x)
        x = _run_block(model.middle, mid, x, emb, context, cfg)
        if control is not None:
            ctrl_skips, ctrl_mid = control
            if len(ctrl_skips) != len(skips):
                raise ValueError(f"control has {len(ctrl_skips)} skip residuals, "
                                 f"UNet plan has {len(skips)} skips")
            x = x + ctrl_mid.to(x.dtype)
            skips = _add_control(skips, ctrl_skips)
        cache_out = None
        for j, (mods, block) in enumerate(zip(model.output, outp)):
            if mode == "full" and j == len(outp) - m:
                cache_out = x
            s = skips.pop()
            if freeu is not None:
                x, s = _apply_freeu(x, s, j // per_level, freeu)
            x = _run_block(mods, block, torch.cat([x, s], dim=-1), emb, context, cfg)
    x = model.out_norm.group(x, cfg.num_groups, 1e-5)
    x = model.out_conv(ops.silu(x), padding=1)
    if deepcache is not None:
        return x, cache_out
    return x
