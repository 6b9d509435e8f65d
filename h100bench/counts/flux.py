"""Analytic forward FLOPs of FLUX.1's transformer and T5 encoder, and the
transformer's attention calls, with counts/flops.py's conventions (2 *
multiply-adds of every linear and of the attention's two products;
nothing for norms, activations, softmax and RoPE; bytes each input and
output once at the served width).

A FLUX forward on b images of h x w latents and t text tokens works on
n = t + (h/2)(w/2) joint tokens of width D = heads * head_dim:

- double block: two modulations (D -> 6D on the vector), then over all n
  tokens (each stream its own weights, the same product shapes) qkv
  D -> 3D, proj D -> D, MLP D -> 4D -> D, and one attention over n;
- single block: one modulation (D -> 3D), linear1 D -> 3D + 4D, linear2
  5D -> D, one attention over n;
- around them img_in, txt_in, the three embedders, the final layer's
  modulation (D -> 2D) and linear on the image tokens.
"""
from __future__ import annotations

from typing import List

from .flops import Call, attn, attn_call, lin


def _dims(m: dict):
    d = m["num_attention_heads"] * m["attention_head_dim"]
    return d, int(m["mlp_ratio"] * d), m["num_attention_heads"], m["attention_head_dim"]


def double_block_flops(m: dict, batch: int, n: int) -> int:
    d, hid, heads, hd = _dims(m)
    return (2 * lin(batch, d, 6 * d) + lin(batch * n, d, 3 * d) + lin(batch * n, d, d)
            + lin(batch * n, d, hid) + lin(batch * n, hid, d) + attn(batch, heads, n, n, hd))


def single_block_flops(m: dict, batch: int, n: int) -> int:
    d, hid, heads, hd = _dims(m)
    return (lin(batch, d, 3 * d) + lin(batch * n, d, 3 * d + hid) + lin(batch * n, d + hid, d)
            + attn(batch, heads, n, n, hd))


def flux_flops(m: dict, h: int, w: int, batch: int, txt_len: int) -> int:
    """One transformer forward on latents of h x w (before packing)."""
    d = _dims(m)[0]
    n_img = (h // 2) * (w // 2)
    n = txt_len + n_img
    total = lin(batch * n_img, m["in_channels"], d)
    total += lin(batch * txt_len, m["joint_attention_dim"], d)
    total += 2 * lin(batch, 256, d) + lin(batch, m["pooled_projection_dim"], d)
    total += 3 * lin(batch, d, d)
    total += m["num_layers"] * double_block_flops(m, batch, n)
    total += m["num_single_layers"] * single_block_flops(m, batch, n)
    return total + lin(batch, d, 2 * d) + lin(batch * n_img, d, m["in_channels"])


def flux_calls(m: dict, h: int, w: int, batch: int, txt_len: int, item: int) -> List[Call]:
    """The joint attention of every block: (b, n, n) over heads x head_dim."""
    _, _, heads, hd = _dims(m)
    n = txt_len + (h // 2) * (w // 2)
    return [attn_call(batch, n, n, heads, hd, item)] * (m["num_layers"] + m["num_single_layers"])


def t5_flops(c: dict, batch: int, length: int) -> int:
    d, inner, f = c["dim"], c["num_heads"] * c["head_dim"], c["ff_dim"]
    rows = batch * length
    per_layer = (3 * lin(rows, d, inner) + lin(rows, inner, d)
                 + attn(batch, c["num_heads"], length, length, c["head_dim"])
                 + 2 * lin(rows, d, f) + lin(rows, f, d))
    return c["num_layers"] * per_layer
