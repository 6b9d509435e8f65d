"""FLUX.1, the rectified-flow transformer of Black Forest Labs (the layer
equations of their reference ``flux/model.py`` and
``flux/modules/layers.py``). It has no counterpart in the JAX package.

Image latents are packed 2 x 2 into tokens (``pack``: (B, H, W, C) ->
(B, HW/4, 4C), channel-major inside a token, as ``b c (h 2) (w 2) -> b
(h w) (c 2 2)``) and projected by ``img_in``; the T5 states by
``txt_in``. The conditioning vector is ``time_in(emb(t))`` +
``guidance_in(emb(g))`` + ``vector_in(pooled CLIP)``, each an MLP of
linear, SiLU, linear, the embeddings ``timestep_embedding(x * 1000,
256)`` (cos half, then sin half). Every block reads SiLU of it.

- Double-stream block (``double_blocks``): image and text each have their
  own adaLN modulation (shift, scale, gate for the attention and for the
  MLP), LayerNorm without affine (eps 1e-6), a fused qkv with bias laid
  out (K H D), K outermost, per-head RMS norms of q and k, an output
  projection and a tanh-GELU MLP of ratio 4. Both meet in one attention
  over [txt ‖ img], text first.
- Single-stream block (``single_blocks``), on [txt ‖ img]: one modulation
  (shift, scale, gate); ``linear1`` gives qkv (K H D) and the MLP's hidden
  part side by side; attention and MLP run in parallel and ``linear2``
  maps [attn ‖ gelu_tanh(mlp)] back, then the gate and the residual.
- The final layer: adaLN (shift, then scale) over a LayerNorm without
  affine, and a linear to the packed channels.

Every attention rotates q and k after their RMS norms with one 3-axis
RoPE table (ops/rope.py) built once per forward from the position ids:
text tokens (0, 0, 0), image tokens (0, row, col). The joint attention
goes to ``ops.sdpa_packed`` unpadded: on CUDA the heads-packed flash
kernel (FLUX.1-dev at 1024²: 512 + 4096 tokens, 24 heads of 128), on
the CPU the math route over (B, H, S, d).

Modules and parameters are named as BFL's state dict names them
(``img_mlp.0`` / ``.2``, ``final_layer.adaLN_modulation.1``, the RMS
gains ``...norm.query_norm.scale``), so that their checkpoints load as
they are. Departure: the timesteps and the guidance are embedded from
float32 values (BFL's sampler hands them over in the latents' dtype).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from .. import ops
from ..utils import profiling
from .dit import _modulate
from .layers import Linear
from .mmdit import _rms_qk
from .unet import timestep_embedding

LN_EPS = 1e-6


@dataclass(frozen=True)
class FluxConfig:
    """Named as the published ``transformer/config.json`` names them."""
    in_channels: int = 64               # 16 latent channels x 2 x 2
    num_layers: int = 19                # double-stream blocks
    num_single_layers: int = 38         # single-stream blocks
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096     # the T5 states' width
    pooled_projection_dim: int = 768    # CLIP-L's pooled vector
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    mlp_ratio: float = 4.0

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mlp_dim(self) -> int:
        return int(self.dim * self.mlp_ratio)


FLUX1_DEV = FluxConfig()

TINY_FLUX = FluxConfig(in_channels=16, num_layers=2, num_single_layers=2, attention_head_dim=16,
                       num_attention_heads=4, joint_attention_dim=32, pooled_projection_dim=16,
                       axes_dims_rope=(4, 6, 6))


class _Seq(nn.Module):
    """An ``nn.Sequential`` of BFL's, its linears at their indices (its
    activations hold no parameters)."""

    def __init__(self, linears: Dict[str, Linear]):
        super().__init__()
        for name, layer in linears.items():
            self.add_module(name, layer)

    def __getitem__(self, i: int) -> Linear:
        return self._modules[str(i)]


def _mlp(din: int, dhid: int, dout: int, **kw) -> _Seq:
    """Linear, GELU (tanh), Linear: ``.0`` and ``.2``."""
    return _Seq({"0": Linear(din, dhid, **kw), "2": Linear(dhid, dout, **kw)})


class _Embedder(nn.Module):
    """BFL's MLPEmbedder: in_layer, SiLU, out_layer."""

    def __init__(self, din: int, dim: int, **kw):
        super().__init__()
        self.in_layer = Linear(din, dim, **kw)
        self.out_layer = Linear(dim, dim, **kw)

    def forward(self, x):
        return self.out_layer(ops.silu(self.in_layer(x)))


class _Modulation(nn.Module):
    def __init__(self, dim: int, n: int, **kw):
        super().__init__()
        self.lin = Linear(dim, n * dim, **kw)


class _Scale(nn.Module):
    """An RMS norm's gain, named ``scale`` as BFL's RMSNorm names it."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim, device=device, dtype=dtype),
                                  requires_grad=False)


class _QKNorm(nn.Module):
    def __init__(self, head_dim: int, **kw):
        super().__init__()
        self.query_norm = _Scale(head_dim, **kw)
        self.key_norm = _Scale(head_dim, **kw)

    def forward(self, q, k):
        return _rms_qk(q, self.query_norm.scale), _rms_qk(k, self.key_norm.scale)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: FluxConfig, **kw):
        super().__init__()
        self.qkv = Linear(cfg.dim, 3 * cfg.dim, **kw)
        self.norm = _QKNorm(cfg.attention_head_dim, **kw)
        self.proj = Linear(cfg.dim, cfg.dim, **kw)


class _DoubleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, **kw):
        super().__init__()
        for s in ("img", "txt"):
            self.add_module(f"{s}_mod", _Modulation(cfg.dim, 6, **kw))
            self.add_module(f"{s}_attn", _SelfAttention(cfg, **kw))
            self.add_module(f"{s}_mlp", _mlp(cfg.dim, cfg.mlp_dim, cfg.dim, **kw))


class _SingleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, **kw):
        super().__init__()
        d = cfg.dim
        self.linear1 = Linear(d, 3 * d + cfg.mlp_dim, **kw)
        self.linear2 = Linear(d + cfg.mlp_dim, d, **kw)
        self.norm = _QKNorm(cfg.attention_head_dim, **kw)
        self.modulation = _Modulation(d, 3, **kw)


class _LastLayer(nn.Module):
    def __init__(self, cfg: FluxConfig, **kw):
        super().__init__()
        self.linear = Linear(cfg.dim, cfg.in_channels, **kw)
        self.adaLN_modulation = _Seq({"1": Linear(cfg.dim, 2 * cfg.dim, **kw)})


class FluxTransformer(nn.Module):
    def __init__(self, cfg: FluxConfig = FLUX1_DEV, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if sum(cfg.axes_dims_rope) != cfg.attention_head_dim:
            raise ValueError("axes_dims_rope must sum to attention_head_dim")
        self.cfg = cfg
        d = cfg.dim
        self.img_in = Linear(cfg.in_channels, d, **kw)
        self.time_in = _Embedder(256, d, **kw)
        self.vector_in = _Embedder(cfg.pooled_projection_dim, d, **kw)
        self.guidance_in = _Embedder(256, d, **kw)
        self.txt_in = Linear(cfg.joint_attention_dim, d, **kw)
        self.double_blocks = nn.ModuleList(_DoubleBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.single_blocks = nn.ModuleList(_SingleBlock(cfg, **kw)
                                           for _ in range(cfg.num_single_layers))
        self.final_layer = _LastLayer(cfg, **kw)

    def forward(self, x, timesteps, context, pooled, guidance):
        return apply(self, x, timesteps, context, pooled, guidance)


def pack(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) latents -> (B, HW/4, 4C) tokens, row-major over the 2 x 2
    patches, each token's channels (c, ph, pw)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """pack's inverse: (B, HW/4, 4C) -> (B, H, W, C)."""
    b, _, c4 = x.shape
    x = x.reshape(b, h // 2, w // 2, c4 // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h, w, c4 // 4)


def position_ids(txt_len: int, hp: int, wp: int, device=None) -> torch.Tensor:
    """(txt_len + hp*wp, 3) float ids of [txt ‖ img]: text (0, 0, 0), the
    image token of packed row i, column j (0, i, j)."""
    ids = torch.zeros(txt_len + hp * wp, 3, device=device)
    ids[txt_len:, 1] = torch.arange(hp, device=device).repeat_interleave(wp).float()
    ids[txt_len:, 2] = torch.arange(wp, device=device).repeat(hp).float()
    return ids


def _qkv(p: _SelfAttention, x: torch.Tensor, heads: int):
    """Fused (K H D) projection -> q, k, v (B, T, H, D), q and k RMS-normed."""
    b, t, _ = x.shape
    q, k, v = p.qkv(x).reshape(b, t, 3, heads, -1).unbind(2)
    q, k = p.norm(q, k)
    return q, k, v


def _attend(q, k, v, rope, heads: int) -> torch.Tensor:
    """RoPE on q and k, then attention: (B, S, H, D) each -> (B, S, H*D)."""
    b, s = q.shape[:2]
    q, k = (ops.apply_rope(z, *rope) for z in (q, k))
    flat = lambda z: z.reshape(b, s, -1)  # noqa: E731
    return ops.sdpa_packed(flat(q), flat(k), flat(v), heads=heads)


def _double(p: _DoubleBlock, img, txt, svec, rope, cfg: FluxConfig):
    heads, nt = cfg.num_attention_heads, txt.shape[1]
    streams, qkv = [], []
    for s, x in (("txt", txt), ("img", img)):
        sh1, sc1, g1, sh2, sc2, g2 = getattr(p, f"{s}_mod").lin(svec).chunk(6, dim=-1)
        attn = getattr(p, f"{s}_attn")
        qkv.append(_qkv(attn, _modulate(ops.layer_norm(x, eps=LN_EPS), sh1, sc1), heads))
        streams.append((s, x, attn, g1, sh2, sc2, g2))
    q, k, v = (torch.cat([a, z], dim=1) for a, z in zip(*qkv))
    o = _attend(q, k, v, rope, heads)
    outs = []
    for (s, x, attn, g1, sh2, sc2, g2), part in zip(streams, (o[:, :nt], o[:, nt:])):
        x = x + g1[:, None, :] * attn.proj(part)
        mlp = getattr(p, f"{s}_mlp")
        h = _modulate(ops.layer_norm(x, eps=LN_EPS), sh2, sc2)
        outs.append(x + g2[:, None, :] * mlp[2](ops.gelu_tanh(mlp[0](h))))
    txt, img = outs
    return img, txt


def _single(p: _SingleBlock, x, svec, rope, cfg: FluxConfig):
    b, s, d = x.shape
    heads = cfg.num_attention_heads
    shift, scale, gate = p.modulation.lin(svec).chunk(3, dim=-1)
    h = p.linear1(_modulate(ops.layer_norm(x, eps=LN_EPS), shift, scale))
    qkv, mlp = h.split([3 * d, cfg.mlp_dim], dim=-1)
    q, k, v = qkv.reshape(b, s, 3, heads, -1).unbind(2)
    q, k = p.norm(q, k)
    o = _attend(q, k, v, rope, heads)
    return x + gate[:, None, :] * p.linear2(torch.cat([o, ops.gelu_tanh(mlp)], dim=-1))


def apply(model: FluxTransformer, x: torch.Tensor, timesteps: torch.Tensor,
          context: torch.Tensor, pooled: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) latents, timesteps (B,) flow times in [0, 1], context
    (B, T, joint_attention_dim), pooled (B, pooled_projection_dim),
    guidance (B,) the distilled guidance scale -> velocity (B, H, W, C).
    Spans: ``flux.double`` and ``flux.single`` around the two stacks."""
    cfg = model.cfg
    _, h, w, _ = x.shape
    dt = x.dtype
    img = model.img_in(pack(x))
    emb = lambda v: timestep_embedding(v.float() * 1000.0, 256).to(dt)  # noqa: E731
    vec = model.time_in(emb(timesteps)) + model.guidance_in(emb(guidance))
    vec = vec + model.vector_in(pooled.to(dt))
    svec = ops.silu(vec)
    txt = model.txt_in(context.to(dt))
    nt = txt.shape[1]
    rope = ops.rope_table(position_ids(nt, h // 2, w // 2, x.device), cfg.axes_dims_rope,
                          cfg.theta)
    with profiling.span("flux.double"):
        for blk in model.double_blocks:
            img, txt = _double(blk, img, txt, svec, rope, cfg)
    joint = torch.cat([txt, img], dim=1)
    with profiling.span("flux.single"):
        for blk in model.single_blocks:
            joint = _single(blk, joint, svec, rope, cfg)
    shift, scale = model.final_layer.adaLN_modulation[1](svec).chunk(2, dim=-1)
    out = model.final_layer.linear(
        _modulate(ops.layer_norm(joint[:, nt:], eps=LN_EPS), shift, scale))
    return unpack(out, h, w)
