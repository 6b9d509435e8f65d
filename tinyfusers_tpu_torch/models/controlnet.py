"""ControlNet (Zhang et al. 2023): spatially conditioned SD (port of
tinyfusers_tpu/models/controlnet.py).

A copy of the UNet's encoder half (input blocks and middle, from the same
``unet.build_plan``) that reads an image-space hint (edges, depth, pose,
...) and gives one residual per UNet skip plus one for the middle block.
Every residual passes a 1x1 "zero conv", zeros under the JAX init, so a
fresh ControlNet is an exact no-op on the UNet. The module tree mirrors
the JAX param tree ("time_embed", "input", "middle", "input_hint",
"zero_convs", "middle_out"), so io/from_jax.py loads it by walking both.

The hint encoder runs at the image's resolution and does not depend on
the step: pipeline/sd.py encodes the hint once per generation and passes
``hint_features`` to every ``apply``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from .. import ops
from ..device import resolve_device
from . import unet as unet_model
from .layers import Conv, ZeroConv, init_weights
from .unet import UNetConfig, timestep_embedding

# The hint encoder's channel ladder (cldm.py input_hint_block): 3 -> 16 ->
# 16 -> 32 -> 32 -> 96 -> 96 -> 256 -> model_channels, stride 2 at each
# channel jump, so the hint is 8x the latent grid.
_HINT_LADDER = ((3, 16, 1), (16, 16, 1), (16, 32, 2), (32, 32, 1),
                (32, 96, 2), (96, 96, 1), (96, 256, 2))


def _skip_channels(cfg: UNetConfig) -> List[int]:
    """The channels of the tensor leaving each input block."""
    ch = cfg.model_channels
    chs = [ch]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            ch = mult * cfg.model_channels
            chs.append(ch)
        if level != len(cfg.channel_mult) - 1:
            chs.append(ch)
    return chs


class ControlNet(nn.Module):
    """The control branch of ``cfg``'s UNet.

    device defaults to "cuda" and raises without a GPU. seed fills the
    weights with the JAX package's init distributions (the zero convs with
    zeros), drawn on the device; seed=None leaves them empty for a loader
    (io/checkpoints.load_controlnet_params, io/from_jax.py)."""

    def __init__(self, cfg: UNetConfig = unet_model.SD15_CONFIG, *, hint_channels: int = 3,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32, seed: Optional[int] = 0):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.cfg = cfg
        inp, mid, _ = unet_model.build_plan(cfg)
        emb_ch = cfg.model_channels * 4
        self.time_embed = unet_model._TimeEmbed(cfg.model_channels, emb_ch, **kw)
        self.input = nn.ModuleList(unet_model._block_modules(b, cfg, emb_ch, **kw) for b in inp)
        self.middle = unet_model._block_modules(mid, cfg, emb_ch, **kw)
        ladder = ((hint_channels,) + _HINT_LADDER[0][1:],) + _HINT_LADDER[1:]
        self.input_hint = nn.ModuleList(
            [Conv(cin, cout, 3, **kw) for cin, cout, _ in ladder]
            + [ZeroConv(ladder[-1][1], cfg.model_channels, 3, **kw)])
        skip_chs = _skip_channels(cfg)
        self.zero_convs = nn.ModuleList(ZeroConv(ch, ch, 1, **kw) for ch in skip_chs)
        self.middle_out = ZeroConv(skip_chs[-1], skip_chs[-1], 1, **kw)
        if seed is not None:
            init_weights(self, seed)


def encode_hint(model: ControlNet, hint: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) hint image in [0, 1] -> (B, H/8, W/8, model_channels)."""
    x = hint
    for conv, (_, _, stride) in zip(model.input_hint[:-1], _HINT_LADDER):
        x = ops.silu(conv(x, stride=stride, padding=1))
    return model.input_hint[-1](x, padding=1)


def apply(model: ControlNet, x: torch.Tensor, hint: Optional[torch.Tensor],
          timesteps: torch.Tensor, context: torch.Tensor, *, scale=1.0,
          hint_features: Optional[torch.Tensor] = None
          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The control branch at this step: x (B, h, w, C) the latents the UNet
    sees, hint (B, 8h, 8w, 3) in [0, 1] or its ``hint_features``
    (encode_hint's output). Returns (skip residuals, middle residual),
    shaped as the UNet's skip stack, each times ``scale``: feed them as
    ``unet.apply(..., control=...)``."""
    cfg = model.cfg
    inp, mid, _ = unet_model.build_plan(cfg)
    t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
    emb = model.time_embed.fc2(ops.silu(model.time_embed.fc1(t_emb)))
    guided = (hint_features if hint_features is not None
              else encode_hint(model, hint)).to(x.dtype)
    residuals = []
    for i, (mods, block) in enumerate(zip(model.input, inp)):
        x = unet_model._run_block(mods, block, x, emb, context, cfg)
        if i == 0:
            x = x + guided  # the hint enters after conv_in (cldm.py)
        residuals.append(scaled(model.zero_convs[i](x), scale))
    x = unet_model._run_block(model.middle, mid, x, emb, context, cfg)
    return residuals, scaled(model.middle_out(x), scale)


def scaled(residual: torch.Tensor, scale) -> torch.Tensor:
    """scale * residual with the scale (a float or a tensor) in the
    residual's dtype first, as the JAX package takes it."""
    s = (scale.to(residual.dtype) if isinstance(scale, torch.Tensor)
         else ops.rounded_to(float(scale), residual.dtype))
    return s * residual
