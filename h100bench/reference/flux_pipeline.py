"""FLUX.1's text-to-image pipeline, plain float32, from token ids and an
initial latent to an image in levels (H, W, 3).

CLIP-L's pooled vector (its final-norm state at the first end-of-text
token, no projection) and T5's final states, unmasked over the padded
sequence, condition the transformer (reference/flux.py). The sampler is
BFL's ``denoise`` on their ``get_schedule``: t from 1 to 0 in n equal
steps, shifted by time_shift(mu, 1, t) = e^mu / (e^mu + 1 / t - 1) with
mu on the line through (256, 0.5) and (4096, 1.15) at the number of
image tokens, each step x += (t_next - t) v, one forward a step with the
distilled guidance embedded (no CFG batch). The VAE decodes z / 0.3611 +
0.1159 (the config's scale and shift) and the levels are truncated as a
uint8 cast truncates. Nothing here imports the program under test.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import clip, flux, nn, t5, vae


def spec(cfg: dict):
    return (clip.spec(cfg["clip"], "clip") + t5.spec(cfg["t5"], "t5")
            + flux.spec(cfg["transformer"], "transformer") + vae.spec(cfg["vae"], "vae"))


def schedule(num_steps: int, image_tokens: int, cfg: dict) -> np.ndarray:
    """BFL's get_schedule, float64: num_steps + 1 times from 1 to 0."""
    x1, y1 = cfg["base_image_seq_len"], cfg["base_shift"]
    x2, y2 = cfg["max_image_seq_len"], cfg["max_shift"]
    mu = y1 + (y2 - y1) / (x2 - x1) * (image_tokens - x1)
    t = np.linspace(1.0, 0.0, num_steps + 1)
    with np.errstate(divide="ignore"):
        return np.where(t > 0, math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0)), 0.0)


class Uncached(nn.Prec):
    """``nn.Prec`` that prepares each weight where it is used and keeps
    none: FLUX.1-dev's 16.9e9 weights in float32 would take 68 GB beside
    their 34 GB bf16 source."""

    def weight(self, W, name: str) -> torch.Tensor:
        w = W[name].float()
        if self.mode == "fp8":
            w = nn._e4m3(w, w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True))
        return w


def _ids(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)[None]


class Reference:
    """FLUX.1's reference: the config dict, the weights W (name -> tensor,
    any float dtype) and the arithmetic ``prec`` ("fp32" or "fp8")."""

    def __init__(self, cfg: dict, W: Dict[str, torch.Tensor], prec: str = "fp32"):
        self.cfg, self.W, self.P = cfg, W, Uncached(prec)

    @torch.no_grad()
    def flux_image(self, clip_ids, t5_ids, latent: torch.Tensor, num_steps: int,
                   guidance: float) -> torch.Tensor:
        """ids (77,) and (T,), latent (1, h, w, C) as served -> levels (H, W, 3)."""
        cfg, W, P = self.cfg, self.W, self.P
        m = cfg["transformer"]
        dev = next(iter(W.values())).device
        with nn.fp32_matmuls():
            pooled = clip.forward(P, W, cfg["clip"], "clip", _ids(clip_ids, dev))[2]
            txt = t5.forward(P, W, cfg["t5"], "t5", _ids(t5_ids, dev))
            x = latent.to(dev).float().permute(0, 3, 1, 2)
            _, _, h, w = x.shape
            img = flux.pack(x)
            pe = flux.rope(flux.ids(txt.shape[1], h // 2, w // 2, dev), m["axes_dims_rope"],
                           m["theta"])
            ts = schedule(num_steps, img.shape[1], cfg)
            g = torch.full((1,), float(guidance), device=dev)
            for i in range(num_steps):
                t = torch.full((1,), float(ts[i]), device=dev)
                v = flux.forward(P, W, m, "transformer", img, txt, pe, t, pooled, g)
                img = img + float(ts[i + 1] - ts[i]) * v
            z = flux.unpack(img, h, w)
            return nn.to_levels(vae.decode(P, W, cfg["vae"], "vae", z).permute(0, 2, 3, 1))[0]
