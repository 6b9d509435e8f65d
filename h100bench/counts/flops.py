"""Analytic forward FLOPs of the models, and the attention and GEGLU calls
of a forward with their operations and bytes.

Adapted from the port's ``utils/flops.py`` with two repairs: the MMDiT's
adaLN modulation acts on the conditioning vector c, once per sample and
not once per token; and the VAE decoder's count walks its real list of
blocks (three ResBlocks a stage, the shortcuts, the upsample convs) in
place of an estimate.

Conventions: FLOPs = 2 * multiply-adds of every linear, convolution and
attention product (q k^T and p v), nothing for norms, activations and
softmax. Attention counts real tokens only: the served MMDiT pads its
joint sequence to a multiple of 128, which is the implementation's, not
the model's, work. Bytes count each input and each output once, at the
served dtype's width.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..reference import unet as ref_unet, vae as ref_vae


def conv(b, h, w, cin, cout, k) -> int:
    """h, w: the output's size."""
    return 2 * b * h * w * cout * cin * k * k


def lin(rows, k, n) -> int:
    return 2 * rows * k * n


def attn(b, heads, sq, sk, d) -> int:
    return 4 * b * heads * sq * sk * d


@dataclass(frozen=True)
class Call:
    """One call of a kernel family: "attn" (q, k, v -> o) or "geglu"
    ((gx * gelu(gate)) @ w + b)."""
    family: str
    shape: tuple
    flops: int
    bytes: int


def attn_call(b, sq, sk, heads, d, item) -> Call:
    c = heads * d
    return Call("attn", (b, sq, sk, heads, d), attn(b, heads, sq, sk, d),
                item * (2 * b * sq * c + 2 * b * sk * c))


def geglu_call(m, k, n, item) -> Call:
    """m rows, k the inner width (each half), n outputs."""
    return Call("geglu", (m, k, n), lin(m, k, n), item * (2 * m * k + k * n + n + m * n))


def clip_flops(c: dict, batch: int) -> int:
    s, d = c["max_length"], c["dim"]
    per_layer = (4 * lin(batch * s, d, d) + attn(batch, c["num_heads"], s, s, d // c["num_heads"])
                 + 2 * lin(batch * s, d, c["mlp_dim"]))
    proj = lin(batch, d, c["projection_dim"]) if c.get("projection_dim") else 0
    return c["num_layers"] * per_layer + proj


def unet_flops(u: dict, h: int, w: int, batch: int, ctx_len: int) -> int:
    return _unet(u, h, w, batch, ctx_len, item=2)[0]


def unet_calls(u: dict, h: int, w: int, batch: int, ctx_len: int, item: int) -> List[Call]:
    return _unet(u, h, w, batch, ctx_len, item)[1]


def _unet(u, h, w, batch, ctx_len, item):
    inp, mid, outp = ref_unet.plan(u)
    mc, emb = u["model_channels"], 4 * u["model_channels"]
    total = lin(batch, mc, emb) + lin(batch, emb, emb)
    calls: List[Call] = []

    def res(cin, cout, hh, ww):
        f = conv(batch, hh, ww, cin, cout, 3) + lin(batch, emb, cout)
        f += conv(batch, hh, ww, cout, cout, 3)
        return f + (conv(batch, hh, ww, cin, cout, 1) if cin != cout else 0)

    def transformer(c, hh, ww):
        s, nh = hh * ww, u["num_heads"]
        d, rows = c // nh, batch * hh * ww
        f = 2 * conv(batch, hh, ww, c, c, 1)
        for _ in range(u["transformer_depth"]):
            f += 4 * lin(rows, c, c) + attn(batch, nh, s, s, d)          # self
            f += 2 * lin(rows, c, c) + 2 * lin(batch * ctx_len, u["context_dim"], c)
            f += attn(batch, nh, s, ctx_len, d)                          # cross
            f += lin(rows, c, 8 * c) + lin(rows, 4 * c, c)               # GEGLU FF
            calls.extend([attn_call(batch, s, s, nh, d, item),
                          attn_call(batch, s, ctx_len, nh, d, item),
                          geglu_call(rows, 4 * c, c, item)])
        return f

    hh, ww = h, w
    for block in [*inp, mid, *outp]:
        for item_ in block:
            kind = item_[0]
            if kind == "conv_in":
                total += conv(batch, hh, ww, u["in_channels"], mc, 3)
            elif kind == "res":
                total += res(item_[1], item_[2], hh, ww)
            elif kind == "attn":
                total += transformer(item_[1], hh, ww)
            elif kind == "down":
                hh, ww = hh // 2, ww // 2
                total += conv(batch, hh, ww, item_[1], item_[1], 3)
            else:
                hh, ww = hh * 2, ww * 2
                total += conv(batch, hh, ww, item_[1], item_[1], 3)
    total += conv(batch, h, w, mc, u["out_channels"], 3)
    return total, calls


def vae_decode_flops(v: dict, h: int, w: int, batch: int) -> int:
    return _vae_decode(v, h, w, batch, item=2)[0]


def vae_decode_calls(v: dict, h: int, w: int, batch: int, item: int) -> List[Call]:
    return _vae_decode(v, h, w, batch, item)[1]


def _vae_decode(v, h, w, batch, item):
    chs = [v["base_channels"] * m for m in v["channel_mult"]]
    lc, top = v["latent_channels"], chs[-1]

    def res(cin, cout, hh, ww):
        f = conv(batch, hh, ww, cin, cout, 3) + conv(batch, hh, ww, cout, cout, 3)
        return f + (conv(batch, hh, ww, cin, cout, 1) if cin != cout else 0)

    total = conv(batch, h, w, lc, lc, 1) if v["use_quant_conv"] else 0
    total += conv(batch, h, w, lc, top, 3)
    total += 2 * res(top, top, h, w) + 4 * conv(batch, h, w, top, top, 1)
    total += attn(batch, 1, h * w, h * w, top)
    calls = [attn_call(batch, h * w, h * w, 1, top, item)]
    hh, ww = h, w
    for cin, cout, up in reversed(ref_vae.up_stages(v)):
        total += res(cin, cout, hh, ww) + 2 * res(cout, cout, hh, ww)
        if up:
            hh, ww = 2 * hh, 2 * ww
            total += conv(batch, hh, ww, cout, cout, 3)
    total += conv(batch, hh, ww, chs[1], v["in_channels"], 3)
    return total, calls


def mmdit_flops(m: dict, h: int, w: int, batch: int, ctx_len: int) -> int:
    return _mmdit(m, h, w, batch, ctx_len, item=2)[0]


def mmdit_calls(m: dict, h: int, w: int, batch: int, ctx_len: int, item: int) -> List[Call]:
    return _mmdit(m, h, w, batch, ctx_len, item)[1]


def _mmdit(m, h, w, batch, ctx_len, item):
    d, p, nh = m["dim"], m["patch_size"], m["num_heads"]
    s_img = (h // p) * (w // p)
    s = s_img + ctx_len
    hid = m["mlp_ratio"] * d
    total = conv(batch, h // p, w // p, m["in_channels"], d, p)
    total += lin(batch * ctx_len, m["context_dim"], d)
    total += lin(batch, 256, d) + lin(batch, m["pooled_dim"], d) + 2 * lin(batch, d, d)
    per_block = 2 * lin(batch, d, 6 * d)                       # both streams' modulation
    per_block += lin(batch * s, d, 3 * d) + lin(batch * s, d, d)  # qkv, out projection
    per_block += lin(batch * s, d, hid) + lin(batch * s, hid, d)  # MLP
    per_block += attn(batch, nh, s, s, d // nh)
    total += m["depth"] * per_block
    total += lin(batch, d, 2 * d) + lin(batch * s_img, d, p * p * m["out_channels"])
    calls = [attn_call(batch, s, s, nh, d // nh, item)] * m["depth"]
    return total, calls
