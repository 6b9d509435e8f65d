"""DDIM schedule and update (port of tinyfusers_tpu/pipeline/ddim.py).

alphas_cumprod: squared-linspace betas 0.00085 -> 0.0120 over 1000 steps,
fp32, then cumprod, bit for bit as the JAX package's XLA program on the
CPU forms them (see ``_linspace`` and ``_cumprod``), computed on the CPU
and then put on the device. Ladder: range(1, 1000, 1000 // steps), run
reversed.
DDIM eta=0 update in fp32; classifier-free guidance e_u + g (e_c - e_u),
and its rescale.
"""
from __future__ import annotations

import numpy as np
import torch


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one fp32 rounding (the product is exact in fp64), as
    XLA's contracted multiply-add gives it."""
    return (a.double() * b.double() + c.double()).float()


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """fp32 ``jnp.linspace(start, stop, num)`` as XLA compiles it on the
    CPU: the division by num - 1 becomes a product with its fp32
    reciprocal r, stop * r is folded to one constant c, and
    start * (1 - i r) + i c is two fused multiply-adds."""
    start32 = torch.tensor(start, dtype=torch.float32)
    stop32 = torch.tensor(stop, dtype=torch.float32)
    if num == 1:
        return start32.reshape(1)
    i = torch.arange(num - 1, dtype=torch.float32)
    r = torch.tensor(1.0, dtype=torch.float32) / (num - 1)
    one_minus = _fma(-i, r, torch.ones(()))
    out = _fma(i, stop32 * r, start32 * one_minus)
    return torch.cat([out, stop32.reshape(1)])


def _row_prefix_product(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along the last axis, left to right."""
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] * x[..., j])
    return torch.stack(cols, dim=-1)


def _cumprod(x: torch.Tensor, width: int = 16) -> torch.Tensor:
    """fp32 ``jnp.cumprod`` of a 1-D x as XLA computes it on the CPU: its
    reduce-window rewrite scans rows of ``width`` left to right, then the
    rows' totals the same way, one level up for every ``width`` rows, and
    multiplies each row by the product of the rows before it."""
    n = x.shape[0]
    if n <= width:
        return _row_prefix_product(x)
    rows = -(-n // width)
    grid = torch.cat([x, x.new_ones(rows * width - n)]).reshape(rows, width)
    within = _row_prefix_product(grid)
    before = torch.cat([x.new_ones(1), _cumprod(within[:, -1], width)[:-1]])
    return (within * before[:, None]).reshape(-1)[:n]


def alphas_cumprod(beta_start: float = 0.00085, beta_end: float = 0.0120,
                   n_training_steps: int = 1000, device=None) -> torch.Tensor:
    betas = _linspace(beta_start ** 0.5, beta_end ** 0.5, n_training_steps) ** 2
    return _cumprod(1.0 - betas).to(device)


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


def cfg_rescale(e_cfg: torch.Tensor, e_cond: torch.Tensor, phi: float) -> torch.Tensor:
    """Guidance rescale (Lin et al. 2023, §3.4): the CFG output's per-sample
    std renormalized to the conditional prediction's, blended by ``phi``.
    Applied in model-output space (v or eps), before any v -> eps step.
    The std is the population std (``correction=0``, as ``jnp.std``), in
    fp32 with a 1e-8 floor; the result takes e_cfg's dtype."""
    axes = tuple(range(1, e_cfg.ndim))
    x = e_cfg.float()
    std_cond = torch.std(e_cond.float(), dim=axes, keepdim=True, correction=0)
    std_cfg = torch.std(x, dim=axes, keepdim=True, correction=0)
    rescaled = x * (std_cond / torch.clamp(std_cfg, min=1e-8))
    return (phi * rescaled + (1.0 - phi) * x).to(e_cfg.dtype)
