"""Rectified-flow (flow matching) sampling, SD3-style (port of
tinyfusers_tpu/pipeline/rectified_flow.py).

Forward process x_t = (1 - t) x0 + t noise; the model predicts the
velocity noise - x0, and integrating dx/dt = v from t = 1 to t = 0
recovers x0. SD3 shifts the ladder: sigma(u) = shift u / (1 + (shift-1) u).
"""
from __future__ import annotations

from typing import Callable

import torch


def timesteps(num_steps: int, shift: float = 3.0) -> torch.Tensor:
    """Descending fp32 t ladder from 1 to 0 (num_steps + 1 points), shifted,
    on the host. Bit for bit the JAX package's: its ``jnp.linspace(1, 0,
    n + 1)`` is computed by XLA as 1 - i * fp32(1/n) (the division by n
    becomes a product with the rounded reciprocal), which differs from
    1 - i/n in the last bit at some rungs, so it is built that way here."""
    recip = torch.tensor(1.0 / num_steps, dtype=torch.float32)
    step = torch.arange(num_steps, dtype=torch.float32) * recip
    u = torch.cat([1.0 - step, torch.zeros(1)])
    return shift * u / (1.0 + (shift - 1.0) * u)


def sample(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    noise: torch.Tensor,
    num_steps: int,
    *,
    shift: float = 3.0,
    method: str = "euler",
) -> torch.Tensor:
    """Integrate the velocity field; model_fn(x, t) -> v with t of shape
    (B,) in [0, 1]. Returns x0 in noise's dtype.

    "euler": one model call per step (SD3's reference sampler). "heun":
    trapezoidal predictor-corrector, two calls per step; the last step
    (t_next = 0) keeps the Euler value, as the JAX package's ``where``
    does, so its second call is skipped. Each update is fp32, cast back
    to the carry's dtype."""
    if method not in ("euler", "heun"):
        raise ValueError(f"unknown flow sampler {method!r}")
    ts_host = timesteps(num_steps, shift)
    ts = ts_host.to(noise.device)  # one copy, not one per step
    b = noise.shape[0]
    x = noise
    for i in range(num_steps):
        t, t_next = ts[i], ts[i + 1]
        v = model_fn(x, t.expand(b)).float()
        dt = t_next - t
        x32 = x.float()
        x_pred = x32 + dt * v
        if method == "heun" and ts_host[i + 1] > 0.0:
            v2 = model_fn(x_pred.to(x.dtype), t_next.expand(b)).float()
            x_pred = x32 + 0.5 * dt * (v + v2)
        x = x_pred.to(x.dtype)
    return x
