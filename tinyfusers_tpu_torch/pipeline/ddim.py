"""DDIM schedule and update (port of tinyfusers_tpu/pipeline/ddim.py).

alphas_cumprod: squared-linspace betas 0.00085 -> 0.0120 over 1000 steps,
fp32, then cumprod. Ladder: range(1, 1000, 1000 // steps), run reversed.
DDIM eta=0 update in fp32; classifier-free guidance e_u + g (e_c - e_u).
"""
from __future__ import annotations

import numpy as np
import torch


def alphas_cumprod(beta_start: float = 0.00085, beta_end: float = 0.0120,
                   n_training_steps: int = 1000, device=None) -> torch.Tensor:
    betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5, n_training_steps,
                           dtype=torch.float32, device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def ddim_timesteps_np(num_steps: int, n_training_steps: int = 1000) -> np.ndarray:
    """Ascending ladder as host numpy."""
    return np.arange(1, n_training_steps, n_training_steps // num_steps,
                     dtype=np.int32)


def ddim_alphas(num_steps: int, device=None):
    """(alphas, alphas_prev) fp32, aligned with the ascending ladder."""
    acp = alphas_cumprod(device=device)
    ts = torch.as_tensor(ddim_timesteps_np(num_steps), dtype=torch.long,
                         device=device)
    alphas = acp[ts]
    alphas_prev = torch.cat([torch.ones(1, dtype=torch.float32, device=device),
                             alphas[:-1]])
    return alphas, alphas_prev


def ddim_step(x: torch.Tensor, e_t: torch.Tensor, a_t, a_prev) -> torch.Tensor:
    """One deterministic (eta=0) DDIM update, computed in fp32."""
    a_t = torch.as_tensor(a_t, dtype=torch.float32, device=x.device)
    a_prev = torch.as_tensor(a_prev, dtype=torch.float32, device=x.device)
    xf = x.float()
    ef = e_t.float()
    pred_x0 = (xf - torch.sqrt(1.0 - a_t) * ef) / torch.sqrt(a_t)
    x_prev = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * ef
    return x_prev.to(x.dtype)


def cfg_combine(e_uncond: torch.Tensor, e_cond: torch.Tensor, guidance) -> torch.Tensor:
    """e_u + g (e_c - e_u). The difference is taken in the inputs' dtype and
    the rest in fp32, as JAX promotes it against the fp32 guidance array."""
    return e_uncond.float() + guidance * (e_cond - e_uncond).float()
