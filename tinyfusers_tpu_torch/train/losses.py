"""Diffusion training objectives (port of tinyfusers_tpu/train/losses.py).

- ``eps``: DDPM noise prediction (SD1.x). x_t = sqrt(a_t) x0 +
  sqrt(1-a_t) n, target = n, on the sampler's squared-linspace ladder
  (``pipeline/ddim.alphas_cumprod``, bit for bit the JAX package's).
- ``v``: v-prediction (SD2.x): target = sqrt(a_t) n - sqrt(1-a_t) x0.
- ``rf``: rectified flow (SD3): x_t = (1-t) x0 + t n, target = n - x0,
  t logit-normal by default.

All the arithmetic is fp32 whatever the model's dtype; the square roots
are ``samplers._sqrt`` (correctly rounded, as XLA's). Draws come from an
explicit ``torch.Generator`` on the batch's device: the JAX package's
``jax.random`` bits cannot be reproduced, so the parity tests replay its
draws.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..pipeline import ddim, samplers


@dataclasses.dataclass(frozen=True)
class LossConfig:
    objective: str = "eps"          # "eps" | "v" | "rf"
    n_train_timesteps: int = 1000   # eps/v discrete ladder
    snr_gamma: Optional[float] = None  # min-SNR-gamma loss weighting
    # rf timestep density: logit-normal(mean, std) per SD3; "uniform" if None
    rf_t_mean: Optional[float] = 0.0
    rf_t_std: float = 1.0


@functools.lru_cache(maxsize=None)
def _alphas_cumprod(n: int, device: torch.device) -> torch.Tensor:
    return ddim.alphas_cumprod(n_training_steps=n, device=device)


def sample_timesteps(generator: torch.Generator, batch: int, cfg: LossConfig,
                     device=None) -> torch.Tensor:
    """Per-example training timesteps on ``device`` (the generator's): int32
    indices in [0, n_train_timesteps) for eps / v; fp32 t in (0, 1) for
    rf."""
    device = torch.device(device) if device is not None else generator.device
    if cfg.objective == "rf":
        if cfg.rf_t_mean is None:
            return torch.rand(batch, generator=generator, device=device)
        u = cfg.rf_t_mean + cfg.rf_t_std * torch.randn(batch, generator=generator,
                                                        device=device)
        return torch.sigmoid(u)
    return torch.randint(0, cfg.n_train_timesteps, (batch,), generator=generator,
                         device=device, dtype=torch.int32)


def q_sample(x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor, cfg: LossConfig):
    """Forward process: (x_t fp32, regression target fp32).

    x0 / noise: (B, ...) of one shape; t: (B,) int32 (eps / v) or fp32 (rf).
    """
    x0 = x0.float()
    noise = noise.float()
    bshape = (-1,) + (1,) * (x0.dim() - 1)
    if cfg.objective == "rf":
        tt = t.float().reshape(bshape)
        return (1.0 - tt) * x0 + tt * noise, noise - x0
    if cfg.objective not in ("eps", "v"):
        raise ValueError(f"unknown objective {cfg.objective!r}")
    a_t = _alphas_cumprod(cfg.n_train_timesteps, x0.device)[t.long()].reshape(bshape)
    sa, sb = samplers._sqrt(a_t), samplers._sqrt(1.0 - a_t)
    x_t = sa * x0 + sb * noise
    if cfg.objective == "v":
        return x_t, sa * noise - sb * x0
    return x_t, noise


def loss_weights(t: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """Per-example fp32 weights (B,): min-SNR-gamma (Hang et al. 2023) for
    eps / v, ones otherwise (rf shapes its density in sample_timesteps)."""
    if cfg.snr_gamma is None or cfg.objective == "rf":
        return torch.ones(t.shape[:1], dtype=torch.float32, device=t.device)
    a_t = _alphas_cumprod(cfg.n_train_timesteps, t.device)[t.long()]
    snr = a_t / (1.0 - a_t)
    capped = torch.clamp(snr, max=cfg.snr_gamma)
    if cfg.objective == "v":
        return capped / (snr + 1.0)
    return capped / snr


def diffusion_loss(pred: torch.Tensor, target: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted MSE in fp32, the mean over the batch and every feature."""
    err = (pred.float() - target.float()) ** 2
    per_ex = err.reshape(err.shape[0], -1).mean(dim=-1)
    if weights is not None:
        per_ex = per_ex * weights
    return per_ex.mean()
