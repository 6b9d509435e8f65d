"""Analytic forward-FLOP counts for the model families (MFU reporting);
port of tinyfusers_tpu/utils/flops.py, the same integer arithmetic.

Counts 2*MACs for every conv / linear / attention matmul, walking the
same config-generated topology the models execute (models/unet.py
build_plan, models/mmdit.py stream structure), so the counts track
config changes automatically.

Conventions: FLOPs = 2 * MACs; attention counts the two S*S*d matmuls
(logits + PV) but no softmax/elementwise (vector-unit work, not MXU);
elementwise/norms excluded throughout (sub-1% of these models).
MFU = flops / seconds / peak; the H100 SXM's dense bf16 peak is 989
TFLOP/s (NVIDIA's data sheet, at its 700 W limit).
"""
from __future__ import annotations

H100_PEAK_BF16 = 989e12


def _conv(b, h, w, cin, cout, k) -> int:
    return 2 * b * h * w * cout * cin * k * k


def _lin(b, s, k, n) -> int:
    return 2 * b * s * k * n


def _attn(b, heads, sq, sk, d) -> int:
    # logits (sq,d)x(d,sk) + pv (sq,sk)x(sk,d)
    return 2 * b * heads * sq * sk * d * 2


def unet_fwd_flops(cfg, h: int, w: int, batch: int, ctx_len: int = 77) -> int:
    """One UNet forward (models/unet.py apply) at latent (batch, h, w)."""
    from ..models.unet import AttnSpec, ResSpec, SampleSpec, build_plan

    inp, mid, outp = build_plan(cfg)
    emb_ch = cfg.model_channels * 4
    total = _lin(batch, 1, cfg.model_channels, emb_ch)
    total += _lin(batch, 1, emb_ch, emb_ch)
    if cfg.adm_in_channels:
        total += _lin(batch, 1, cfg.adm_in_channels, emb_ch)
        total += _lin(batch, 1, emb_ch, emb_ch)

    level = [0]  # downsample count mutated as we walk the plan

    def res(spec, hh, ww):
        f = _conv(batch, hh, ww, spec.in_ch, spec.out_ch, 3)
        f += _lin(batch, 1, emb_ch, spec.out_ch)
        f += _conv(batch, hh, ww, spec.out_ch, spec.out_ch, 3)
        if spec.in_ch != spec.out_ch:
            f += _conv(batch, hh, ww, spec.in_ch, spec.out_ch, 1)
        return f

    def attn(spec, hh, ww):
        heads, hd = cfg.heads_for(spec.ch)
        s = hh * ww
        c = spec.ch
        f = 2 * _conv(batch, hh, ww, c, c, 1)  # proj_in + proj_out
        per_block = (
            _lin(batch, s, c, c) * 2              # self qk... q + out
            + _lin(batch, s, c, c) * 2            # self k, v
            + _attn(batch, heads, s, s, hd)       # self sdpa
            + _lin(batch, s, c, c)                # cross q
            + _lin(batch, ctx_len, cfg.context_dim, c) * 2  # cross k, v
            + _lin(batch, s, c, c)                # cross out
            + _attn(batch, heads, s, ctx_len, hd)  # cross sdpa
            + _lin(batch, s, c, c * 8)            # ff proj (geglu 2x4c)
            + _lin(batch, s, c * 4, c)            # ff out
        )
        return f + spec.depth * per_block

    def walk(blocks, hh, ww, direction):
        nonlocal total
        for block in blocks:
            for spec in block:
                if spec == "conv_in":
                    total += _conv(batch, hh, ww, cfg.in_channels,
                                   cfg.model_channels, 3)
                elif isinstance(spec, ResSpec):
                    total += res(spec, hh, ww)
                elif isinstance(spec, AttnSpec):
                    total += attn(spec, hh, ww)
                elif isinstance(spec, SampleSpec):
                    if spec.mode == "down":
                        hh, ww = hh // 2, ww // 2
                        total += _conv(batch, hh, ww, spec.ch, spec.ch, 3)
                    else:
                        hh, ww = hh * 2, ww * 2
                        total += _conv(batch, hh, ww, spec.ch, spec.ch, 3)
        return hh, ww

    hh, ww = walk(inp, h, w, "down")
    hh, ww = walk([mid], hh, ww, "mid")
    hh, ww = walk(outp, hh, ww, "up")
    total += _conv(batch, h, w, cfg.model_channels, cfg.out_channels, 3)
    return total


def mmdit_fwd_flops(cfg, h: int, w: int, batch: int,
                    ctx_len: int = 77) -> int:
    """One MMDiT forward (models/mmdit.py) at latent (batch, h, w)."""
    d = cfg.dim
    s_img = (h // cfg.patch_size) * (w // cfg.patch_size)
    s_txt = ctx_len
    s = s_img + s_txt
    heads = cfg.num_heads
    hd = d // heads
    total = _conv(batch, h // cfg.patch_size, w // cfg.patch_size,
                  cfg.in_channels * cfg.patch_size ** 2, d, 1)  # patch embed
    total += _lin(batch, 1, cfg.pooled_dim, d) + _lin(batch, 1, d, d)
    total += _lin(batch, s_txt, cfg.context_dim, d)  # context embed
    per_layer = 0
    for stream_len in (s_img, s_txt):
        per_layer += _lin(batch, stream_len, d, 3 * d)   # fused qkv
        per_layer += _lin(batch, stream_len, d, d)       # out proj
        per_layer += _lin(batch, stream_len, d, 4 * d) * 2  # mlp in/out
        per_layer += _lin(batch, stream_len, d, 6 * d)   # adaLN modulation
    per_layer += _attn(batch, heads, s, s, hd)           # joint attention
    total += cfg.depth * per_layer
    total += _lin(batch, s_img, d, cfg.patch_size ** 2 * cfg.out_channels)
    return total


def vae_decode_flops(cfg, h: int, w: int, batch: int) -> int:
    """Decoder (models/vae.py): conv ladder from latent (h, w) to 8x."""
    ch = [cfg.base_channels * m for m in cfg.channel_mult]
    total = _conv(batch, h, w, cfg.latent_channels, cfg.latent_channels, 1)
    total += _conv(batch, h, w, cfg.latent_channels, ch[-1], 3)
    # mid: 2 res + 1 attention at latent res
    total += 2 * 2 * _conv(batch, h, w, ch[-1], ch[-1], 3)
    total += 4 * _conv(batch, h, w, ch[-1], ch[-1], 1)
    total += _attn(batch, 1, h * w, h * w, ch[-1])
    hh, ww = h, w
    for i, c in enumerate(reversed(ch)):
        c_prev = ch[-1] if i == 0 else list(reversed(ch))[i - 1]
        total += _conv(batch, hh, ww, c_prev, c, 3)
        total += 2 * 2 * _conv(batch, hh, ww, c, c, 3)  # 3 res blocks-ish
        if i != len(ch) - 1:
            hh, ww = hh * 2, ww * 2
            total += _conv(batch, hh, ww, c, c, 3)
    total += _conv(batch, hh, ww, ch[0], 3, 3)
    return total


def clip_fwd_flops(cfg, batch: int) -> int:
    s, d = cfg.max_length, cfg.dim
    per_layer = (4 * _lin(batch, s, d, d)
                 + _attn(batch, cfg.num_heads, s, s, d // cfg.num_heads)
                 + 2 * _lin(batch, s, d, cfg.mlp_dim))
    return cfg.num_layers * per_layer
