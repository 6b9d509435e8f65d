"""MMDiT, the multimodal diffusion transformer of SD3 (port of
tinyfusers_tpu/models/mmdit.py).

Two token streams, image patches and text context, each with its own
projections and adaLN-Zero modulation, meet in one joint attention over
the concatenation of both streams' q/k/v. The module tree is named after
the JAX param tree: the JAX package stacks the blocks on a leading axis
for ``lax.scan``; here ``blocks`` is an ``nn.ModuleList`` of ``{img,
txt}`` stream pairs (io/from_jax.py splits the stacked leaves).

What is kept exactly as the JAX package does it: the fused qkv is
head-interleaved (models/dit.py ``split_fused_qkv``); the adaLN layer
norms have no affine and the ops default eps 1e-5; the MLP is
``gelu_tanh``; the txt stream is padded once per forward so that the
joint sequence is a multiple of 128 with ``kv_len`` masking the pad
keys; the timestep embedding is ``timestep_embedding(t * 1000, 256)``;
the unpatchify transpose is (0, 1, 3, 2, 4, 5).

On CUDA the joint attention goes to the heads-packed flash kernel
(``ops.packed_beneficial`` is true at >= 1024 joint tokens); on the CPU
it takes the bhsd math route, as the JAX package does off the TPU.
Under tensor parallelism (parallel.shard_params) each stream's fused qkv,
output projection and MLP hold this rank's slices and the joint attention
runs this rank's heads. The parallel options of the JAX config:

- ``attn_impl`` (an ops.sdpa impl, e.g. "ring:model"): the txt stream is
  unpadded and there is no ``kv_len``. Under a ring impl each rank
  projects only its rows of the joint sequence, runs the ring on them and
  gathers the output rows (parallel/ring_attention.py); a stream whose
  attention rings over the model axis stays whole under shard_params
  (parallel/sharding.py). Another impl takes the bhsd route through
  ``ops.sdpa(impl=...)``;
- ``pipeline_microbatches``: the block stack runs as a GPipe pipeline over
  the ambient mesh's ``pipe`` axis (parallel/pipeline.py), the modulation
  vector c riding the carry with the two streams; shard_params on a mesh
  with a ``pipe`` axis keeps only this stage's blocks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..parallel import pipeline, ring_attention, tp
from .dit import _modulate, _pos_embed_2d, split_fused_qkv
from .layers import Conv, Gain, Linear, ZeroLinear
from .unet import timestep_embedding


@dataclass(frozen=True)
class MMDiTConfig:
    input_size: int = 128          # latent H = W (SD3: 1024px / 8)
    patch_size: int = 2
    in_channels: int = 16          # SD3 VAE latent channels
    out_channels: int = 16
    dim: int = 1536                # SD3-medium
    depth: int = 24
    num_heads: int = 24
    mlp_ratio: int = 4
    context_dim: int = 4096        # joint text embedding width
    pooled_dim: int = 2048         # pooled CLIP-L + bigG conditioning
    context_len: int = 77
    attn_impl: Optional[str] = None               # the joint attention's ops.sdpa impl
    qk_norm: Optional[str] = None                 # "rms" (SD3.5) | None
    pipeline_microbatches: Optional[int] = None   # GPipe over the mesh's pipe axis


SD3_MEDIUM = MMDiTConfig()

# SD3.5-large: deeper and wider trunk with RMS q/k norms.
SD35_LARGE = MMDiTConfig(dim=2432, depth=38, num_heads=38, qk_norm="rms")

TINY_MMDIT = MMDiTConfig(input_size=8, patch_size=2, in_channels=4,
                         out_channels=4, dim=64, depth=2, num_heads=4,
                         context_dim=32, pooled_dim=16, context_len=8)

TINY_MMDIT_QKN = MMDiTConfig(input_size=8, patch_size=2, in_channels=4,
                             out_channels=4, dim=64, depth=2, num_heads=4,
                             context_dim=32, pooled_dim=16, context_len=8,
                             qk_norm="rms")


class _MLP(nn.Module):
    def __init__(self, din: int, dhid: int, dout: int, **kw):
        super().__init__()
        self.fc1 = Linear(din, dhid, **kw)
        self.fc2 = Linear(dhid, dout, **kw)


class _Stream(nn.Module):
    """One stream's half of a block: modulation, fused qkv, output
    projection, MLP and (SD3.5) the q/k RMS gains."""

    def __init__(self, cfg: MMDiTConfig, **kw):
        super().__init__()
        d = cfg.dim
        self.heads = cfg.num_heads
        self.impl = cfg.attn_impl  # read by parallel.shard_params
        self.mod = ZeroLinear(d, 6 * d, **kw)
        self.qkv = Linear(d, 3 * d, **kw)
        self.proj = Linear(d, d, **kw)
        self.mlp = _MLP(d, cfg.mlp_ratio * d, d, **kw)
        if cfg.qk_norm:
            self.ln_q = Gain(d // cfg.num_heads, **kw)
            self.ln_k = Gain(d // cfg.num_heads, **kw)


class _Block(nn.Module):
    def __init__(self, cfg: MMDiTConfig, **kw):
        super().__init__()
        self.img = _Stream(cfg, **kw)
        self.txt = _Stream(cfg, **kw)


class _Final(nn.Module):
    def __init__(self, cfg: MMDiTConfig, **kw):
        super().__init__()
        p = cfg.patch_size
        self.mod = ZeroLinear(cfg.dim, 2 * cfg.dim, **kw)
        self.proj = ZeroLinear(cfg.dim, p * p * cfg.out_channels, **kw)


class MMDiT(nn.Module):
    """learned_pos_embed: hold a learned (1, (input_size/p)^2, dim)
    ``pos_embed``, as real SD3 checkpoints do (set to the fixed sin-cos
    table until a loader writes it); without one the fixed table is
    computed on each forward, as in the JAX package."""

    STACKED = ("blocks",)  # one stacked leaf per name in the JAX tree
    PIPELINED = "blocks"   # the stack pipeline_apply runs (cfg.pipeline_microbatches)

    def __init__(self, cfg: MMDiTConfig = SD3_MEDIUM, *, learned_pos_embed: bool = False,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        d = cfg.dim
        self.patch_embed = Conv(cfg.in_channels, d, cfg.patch_size, **kw)
        self.context_embed = Linear(cfg.context_dim, d, **kw)
        self.time_mlp = _MLP(256, d, d, **kw)
        self.pooled_mlp = _MLP(cfg.pooled_dim, d, d, **kw)
        self.blocks = nn.ModuleList(_Block(cfg, **kw) for _ in range(cfg.depth))
        self.final = _Final(cfg, **kw)
        self.pos_embed = None
        if learned_pos_embed:
            n = cfg.input_size // cfg.patch_size
            self.pos_embed = nn.Parameter(
                _pos_embed_2d(n, d, device)[None].to(dtype or torch.float32),
                requires_grad=False)

    def forward(self, x, timesteps, context, pooled):
        return apply(self, x, timesteps, context, pooled)


def _rms_qk(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over head_dim (SD3.5 ln_q / ln_k), fp32 statistics;
    the weight is shared across heads."""
    xf = x.float()
    rms = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * rms * weight.float()).to(x.dtype)


def _stream_pre(p: _Stream, x, c, cfg: MMDiTConfig):
    """Modulated LN + fused qkv -> (q, k, v each (B, T, H, hd), gates)."""
    sh1, sc1, g1, sh2, sc2, g2 = p.mod(ops.silu(c)).chunk(6, dim=-1)
    h = _modulate(ops.layer_norm(x), sh1, sc1)
    q, k, v = split_fused_qkv(p.qkv(h), p.heads)
    if cfg.qk_norm == "rms":
        # the gains act on this rank's heads only under tensor parallelism:
        # Megatron's f sums their gradients over the model group
        q = _rms_qk(q, tp.copy_to(p.ln_q.weight, p.qkv.tp_group))
        k = _rms_qk(k, tp.copy_to(p.ln_k.weight, p.qkv.tp_group))
    elif cfg.qk_norm is not None:
        raise ValueError(f"unsupported qk_norm {cfg.qk_norm!r}")
    return q, k, v, (g1, sh2, sc2, g2)


def _stream_post(p: _Stream, x, attn_out, gates):
    g1, sh2, sc2, g2 = gates
    x = x + g1[:, None, :] * p.proj(attn_out)
    h = _modulate(ops.layer_norm(x), sh2, sc2)
    h = p.mlp.fc2(ops.gelu_tanh(p.mlp.fc1(h)))
    return x + g2[:, None, :] * h


def _block(p: _Block, img, txt, c, cfg: MMDiTConfig, kv_len: Optional[int] = None):
    """Joint attention over [img ‖ txt] tokens; kv_len marks the real
    tokens when apply() padded the txt stream."""
    b, ti = img.shape[:2]
    t_all = ti + txt.shape[1]
    # under tensor parallelism this rank's heads and their width
    heads = p.img.heads
    dim = heads * (cfg.dim // cfg.num_heads)
    joint = lambda a, z: torch.cat([a, z], dim=1)  # noqa: E731  (B, T, H, hd)
    if ring_attention.is_ring(cfg.attn_impl):
        # this rank's rows [lo, hi) of [img ‖ txt] only, projected by their
        # streams; the output rows gathered back
        sp = ring_attention.split_for(t_all, cfg.attn_impl)
        lo_i, hi_i = min(sp.lo, ti), min(sp.hi, ti)
        qi, ki, vi, gi = _stream_pre(p.img, img[:, lo_i:hi_i], c, cfg)
        qt, kt, vt, gt = _stream_pre(p.txt, txt[:, max(sp.lo - ti, 0):max(sp.hi - ti, 0)],
                                     c, cfg)
        bhsd = lambda a, z: joint(a, z).transpose(1, 2)  # noqa: E731
        o = sp.attend(bhsd(qi, qt), bhsd(ki, kt), bhsd(vi, vt))
        o = sp.gather(o.transpose(1, 2).reshape(b, sp.hi - sp.lo, dim), dim=1)
        return _stream_post(p.img, img, o[:, :ti], gi), _stream_post(p.txt, txt, o[:, ti:], gt)
    qi, ki, vi, gi = _stream_pre(p.img, img, c, cfg)
    qt, kt, vt, gt = _stream_pre(p.txt, txt, c, cfg)
    if cfg.attn_impl is None and ops.packed_beneficial(t_all, t_all, dim, heads,
                                                       img.element_size(), device=img.device):
        packed = lambda a, z: joint(a, z).reshape(b, t_all, dim)  # noqa: E731
        o = ops.sdpa_packed(packed(qi, qt), packed(ki, kt), packed(vi, vt),
                            heads=heads, kv_len=kv_len)
    else:
        bhsd = lambda a, z: joint(a, z).transpose(1, 2)  # noqa: E731
        o = ops.sdpa(bhsd(qi, qt), bhsd(ki, kt), bhsd(vi, vt), impl=cfg.attn_impl,
                     kv_len=kv_len)
        o = o.transpose(1, 2).reshape(b, t_all, dim)
    img = _stream_post(p.img, img, o[:, :ti], gi)
    txt = _stream_post(p.txt, txt, o[:, ti:], gt)
    return img, txt


def apply(model: MMDiT, x: torch.Tensor, timesteps: torch.Tensor,
          context: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) latents, timesteps (B,) flow times in [0, 1],
    context (B, T, context_dim), pooled (B, pooled_dim) -> velocity
    (B, H, W, C)."""
    cfg = model.cfg
    b, h, w, _ = x.shape
    p = cfg.patch_size
    img = model.patch_embed(x, stride=p).reshape(b, -1, cfg.dim)
    pe = model.pos_embed
    if pe is None:
        pe = _pos_embed_2d(h // p, cfg.dim, x.device)
    img = img + pe.reshape(1, img.shape[1], cfg.dim).to(img.dtype)
    txt = model.context_embed(context.to(x.dtype))
    # Pad the txt stream once so that every block's joint sequence is a
    # multiple of 128; kv_len masks the pad tokens as keys, and their own
    # outputs ride the txt stream unread (the final layer reads img only).
    kv_len = None
    t_all = img.shape[1] + txt.shape[1]
    if cfg.attn_impl is None and t_all >= 1024 and t_all % 128:
        txt = F.pad(txt, (0, 0, 0, (-t_all) % 128))
        kv_len = t_all

    t_emb = timestep_embedding(timesteps.float() * 1000.0, 256)
    c = model.time_mlp.fc2(ops.silu(model.time_mlp.fc1(t_emb.to(x.dtype))))
    pc = model.pooled_mlp.fc2(ops.silu(model.pooled_mlp.fc1(pooled.to(x.dtype))))
    c = c + pc

    if cfg.pipeline_microbatches:
        def stage(blk, carry):  # c rides the carry, split with the streams
            im, tx, cc = carry
            im, tx = _block(blk, im, tx, cc, cfg, kv_len=kv_len)
            return im, tx, cc

        img, txt, _ = pipeline.pipeline_apply(stage, model.blocks, (img, txt, c),
                                              microbatches=cfg.pipeline_microbatches)
    else:
        for blk in model.blocks:
            img, txt = _block(blk, img, txt, c, cfg, kv_len=kv_len)

    shift, scale = model.final.mod(ops.silu(c)).chunk(2, dim=-1)
    out = model.final.proj(_modulate(ops.layer_norm(img), shift, scale))
    hp, wp = h // p, w // p
    out = out.reshape(b, hp, wp, p, p, cfg.out_channels)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, cfg.out_channels)
