"""Kohya LoRA files merged into the port's models (port of
tinyfusers_tpu/io/lora.py).

W <- W + scale * (alpha / r) * up @ down, merged into the model's weights
before inference: no runtime cost, and a model quantized after the merge
holds it. The key layout is the kohya-ss safetensors convention,

  lora_unet_<module>.lora_down.weight / .lora_up.weight / .alpha
  lora_te_<module>...   (the text encoder)

with diffusers-style module names (down_blocks_0_attentions_1_...), mapped
to the JAX param tree's paths, which name the port's modules too. Unknown
modules are reported, not dropped in silence. The delta is formed in
numpy fp32 as the JAX package forms it, then cast to the weight's dtype
and added on the weight's device.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..models import unet as unet_model

# a path into the JAX param tree, which the port's module names follow
Path = Tuple

_ATTN_LEAF = {
    "to_q": ("to_q",), "to_k": ("to_k",), "to_v": ("to_v",),
    "to_out_0": ("to_out",),
    "ff_net_0_proj": ("ff", "proj"), "ff_net_2": ("ff", "out"),
}

_TE_LEAF = {
    "q_proj": ("self_attn", "q_proj"), "k_proj": ("self_attn", "k_proj"),
    "v_proj": ("self_attn", "v_proj"), "out_proj": ("self_attn", "out_proj"),
    "fc1": ("mlp", "fc1"), "fc2": ("mlp", "fc2"),
}


def _unet_attention_positions(cfg) -> Dict[str, Dict[Tuple[int, int], int]]:
    """(diffusers block, attention index) -> our input / output block index.
    SD1.x groups 2 attentions per down block between downsamples: our input
    blocks 1, 2 -> down 0; 4, 5 -> 1; ..."""
    inp, _, outp = unet_model.build_plan(cfg)
    positions = {}
    for kind, blocks, group in (("down", inp, lambda i: (i - 1) // 3),
                                ("up", outp, lambda i: i // 3)):
        found, seen = {}, {}
        for i, block in enumerate(blocks):
            for spec in block:
                if isinstance(spec, unet_model.AttnSpec):
                    b = group(i)
                    a = seen.get(b, 0)
                    seen[b] = a + 1
                    found[(b, a)] = i
        positions[kind] = found
    return positions


_KOHYA_UNET = re.compile(
    r"lora_unet_(?:"
    r"down_blocks_(\d+)_attentions_(\d+)|"
    r"mid_block_attentions_0|"
    r"up_blocks_(\d+)_attentions_(\d+)"
    r")_transformer_blocks_(\d+)_(attn\d)_(to_q|to_k|to_v|to_out_0)$"
    r"|lora_unet_(?:"
    r"down_blocks_(\d+)_attentions_(\d+)|"
    r"mid_block_attentions_0|"
    r"up_blocks_(\d+)_attentions_(\d+)"
    r")_transformer_blocks_(\d+)_(ff_net_0_proj|ff_net_2)$"
)

_KOHYA_TE = re.compile(
    r"lora_te_text_model_encoder_layers_(\d+)_"
    r"(?:self_attn_(q_proj|k_proj|v_proj|out_proj)|mlp_(fc1|fc2))$"
)


def parse_kohya_module(name: str, cfg) -> Path:
    """kohya module name (without the lora_down / lora_up suffix) -> our tree
    path, ("__te__", layer, ...) for the text encoder. Raises KeyError for an
    unsupported module."""
    m = _KOHYA_UNET.match(name)
    if m:
        g = m.groups()
        if g[4] is not None:  # attention branch
            db, da, ub, ua, depth, attn, leaf = g[0], g[1], g[2], g[3], g[4], g[5], g[6]
        else:  # ff branch
            db, da, ub, ua, depth, leaf = g[7], g[8], g[9], g[10], g[11], g[12]
            attn = None
        pos = _unet_attention_positions(cfg)
        inp, mid, outp = unet_model.build_plan(cfg)
        if db is not None:
            i = pos["down"][(int(db), int(da))]
            block, bpath = inp[i], ("input", i)
        elif ub is not None:
            i = pos["up"][(int(ub), int(ua))]
            block, bpath = outp[i], ("output", i)
        else:
            block, bpath = mid, ("middle",)
        attn_idx = next(j for j, s in enumerate(block) if isinstance(s, unet_model.AttnSpec))
        base = bpath + (attn_idx, "blocks", int(depth))
        if attn is not None:
            return base + (attn,) + _ATTN_LEAF[leaf]
        return base + _ATTN_LEAF[leaf]
    m = _KOHYA_TE.match(name)
    if m:
        layer, attn_leaf, mlp_leaf = m.groups()
        return ("__te__", int(layer)) + _TE_LEAF[attn_leaf or mlp_leaf]
    raise KeyError(name)


def group_lora_state(state: Mapping) -> Dict[str, Dict]:
    """{module: {'down', 'up', 'alpha'}} from a flat lora state dict."""
    mods: Dict[str, Dict] = {}
    for k, v in state.items():
        for suffix, part in ((".lora_down.weight", "down"), (".lora_up.weight", "up"),
                             (".alpha", "alpha")):
            if k.endswith(suffix):
                mods.setdefault(k[: -len(suffix)], {})[part] = v
                break
    return mods


def _np32(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).numpy()
    return np.asarray(value, np.float32)


def merge_lora(model: nn.Module, lora_state: Mapping, *, scale: float = 1.0,
               cfg=None) -> List[str]:
    """Merge a kohya-format LoRA into ``model`` (a pipeline.sd
    StableDiffusion: its ``unet`` and ``clip``) in place; returns the module
    names skipped (unknown, or without both halves). delta = (up @ down).T *
    (alpha / r) * scale in fp32, cast to the weight's dtype and added."""
    from ..pipeline import sd as sd_pipeline

    cfg = cfg or getattr(model, "cfg", None) or sd_pipeline.SD15
    skipped: List[str] = []
    for name, t in group_lora_state(lora_state).items():
        if "down" not in t or "up" not in t:
            skipped.append(name)
            continue
        try:
            path = parse_kohya_module(name, cfg.unet)
        except KeyError:
            skipped.append(name)
            continue
        down, up = _np32(t["down"]), _np32(t["up"])   # (r, in), (out, r)
        r = down.shape[0]
        alpha = float(_np32(t["alpha"])) if "alpha" in t else float(r)
        delta = (up @ down).T * (alpha / r) * scale  # (in, out)
        if path[0] == "__te__":
            mod_path = ("clip", "layers", path[1]) + path[2:]
        else:
            mod_path = ("unet",) + path
        leaf = model.get_submodule(".".join(str(p) for p in mod_path))
        w = leaf.weight
        with torch.no_grad():
            w.copy_(w + leaf.from_jax(torch.from_numpy(delta)).to(device=w.device,
                                                                   dtype=w.dtype))
    return skipped


def load_lora(path) -> Dict[str, torch.Tensor]:
    from . import safetensors_io

    return safetensors_io.load_state_dict(path)
