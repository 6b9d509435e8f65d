"""Samplers (port of tinyfusers_tpu/pipeline/samplers.py): DDIM only so
far; euler, heun, the DPM-Solver++ family and the Karras schedule come
with a later part of the port.

``model_fn(x_ddpm, t_float) -> eps`` is the UNet + CFG closure; the JAX
package's ``lax.scan`` over the ladder is a Python loop here.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import ddim as ddim_mod

SAMPLERS = ("ddim",)


def sample(model_fn: Callable, latent: torch.Tensor, num_steps: int, *,
           method: str = "ddim") -> torch.Tensor:
    """Run the sampler down the ``num_steps`` ladder; returns the final
    latent."""
    if method != "ddim":
        raise ValueError(f"unknown sampler {method!r}; options: {SAMPLERS}")
    return _sample_ddim(model_fn, latent, num_steps)


def _sample_ddim(model_fn, latent, num_steps):
    # The ladder goes to the device once: the timestep reaches the UNet as
    # float32, and a host scalar per step would be a blocking copy.
    timesteps = torch.tensor(ddim_mod.ddim_timesteps_np(num_steps)[::-1].tolist(),
                             dtype=torch.float32, device=latent.device)
    alphas, alphas_prev = ddim_mod.ddim_alphas(num_steps, device=latent.device)
    alphas, alphas_prev = alphas.flip(0), alphas_prev.flip(0)
    lat = latent
    for i in range(len(timesteps)):
        eps = model_fn(lat, timesteps[i])
        lat = ddim_mod.ddim_step(lat, eps, alphas[i], alphas_prev[i])
    return lat
