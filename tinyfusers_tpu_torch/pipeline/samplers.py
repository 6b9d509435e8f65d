"""Sampler family (port of tinyfusers_tpu/pipeline/samplers.py).

The samplers work in the k-diffusion sigma parameterization:

    x_t = sqrt(a_t) * x0 + sqrt(1-a_t) * n      (DDPM space)
    X   = x_t / sqrt(a_t) = x0 + sigma * n      (sigma space),
    sigma = sqrt((1-a_t)/a_t)

and consume ``model_fn(x_ddpm, t_float) -> eps`` (the UNet + CFG closure,
called with DDPM-space input). With ``aux_init``, ``model_fn`` takes and
returns an aux state as well, ``(x, t, aux) -> (eps, aux)``, threaded
through every network call in order: that is how cached CFG
(pipeline/sd.py ``uncond_interval``) works under every sampler, the 2-call
ones included.

The JAX package's ``lax.scan`` loops are Python loops here; the ladder
(timesteps and sigmas) is computed once on the CPU in fp32, with the JAX
package's formulas, and goes to the device once. Where the JAX scan makes
a network call whose result it discards (Heun's and DPM++(2S)'s second
call on the terminal step), the port does not make it.

The ancestral samplers draw their noise from an explicit
``torch.Generator``, through ``_normal`` alone, where the JAX package
splits a ``jax.random`` key per step: the same seed gives other noise. On
a mesh (``global_rows``) each data rank keeps its rows of the global
batch's draw, so that the noise is the dense call's, rows for rows.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch

from . import ddim as ddim_mod

SAMPLERS = (
    "ddim", "euler", "euler_ancestral", "heun", "dpmpp_2m",
    "dpmpp_2s_ancestral",
)

SCHEDULES = ("ladder", "karras")

_BIN_EPS = 2.0 ** -46  # np.spacing(np.finfo(np.float32).eps), as jnp.interp takes it


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """fp32 sqrt, correctly rounded (through fp64) as XLA's is; torch's
    vectorized CPU sqrt is off by an ulp on some inputs."""
    return torch.sqrt(x.double()).float()


def _pow(x: torch.Tensor, y: float) -> torch.Tensor:
    """fp32 x ** fp32(y) through fp64: within an ulp of XLA's pow (equal
    on all but ~0.06% of inputs), where torch's fp32 pow drifts further."""
    return torch.pow(x.double(), float(torch.tensor(y, dtype=torch.float32))).float()


def _sigma_table() -> torch.Tensor:
    """sigma(t) for t = 0..999, increasing, fp32 on the CPU."""
    acp = ddim_mod.alphas_cumprod()
    return _sqrt((1.0 - acp) / acp)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` in fp32, its formula step for step:
    clamped to fp[0] / fp[-1] outside [xp[0], xp[-1]]."""
    i = torch.searchsorted(xp, x.reshape(-1), right=True).reshape(x.shape)
    i = i.clamp(1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= _BIN_EPS  # no division by a zero-width bin
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def t_of_sigma(sig: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The continuous timestep of a sigma: the sigma(t) table inverted by
    interpolation."""
    return _interp(sig, table, torch.arange(table.shape[0], dtype=torch.float32,
                                            device=table.device))


def sigma_ladder(num_steps: int, schedule: str = "ladder", *, device=None):
    """Descending sigmas with a terminal 0: (timesteps (num_steps,) fp32,
    sigmas (num_steps + 1,) fp32), computed on the CPU and put on
    ``device``.

    "ladder": the sigmas of the reversed DDIM timestep ladder. "karras":
    Karras et al. 2022's rho = 7 spacing between the model's own sigma_min
    and sigma_max, at interpolated continuous timesteps. fp32 throughout,
    as the JAX package computes it without x64, with ``jnp.linspace`` and
    ``jnp.interp`` formed as XLA forms them."""
    acp = ddim_mod.alphas_cumprod()
    if schedule == "ladder":
        ts = torch.as_tensor(ddim_mod.ddim_timesteps_np(num_steps)[::-1].copy(),
                             dtype=torch.long)
        a = acp[ts]
        sigmas = _sqrt((1.0 - a) / a)
        ts = ts.float()
    elif schedule == "karras":
        table = _sigma_table()
        sigma_min, sigma_max = table[0], table[-1]
        rho = 7.0
        ramp = ddim_mod._linspace(0.0, 1.0, num_steps)
        inv = _pow(sigma_max, 1.0 / rho) + ramp * (
            _pow(sigma_min, 1.0 / rho) - _pow(sigma_max, 1.0 / rho))
        sigmas = _pow(inv, rho)  # descending sigma_max -> sigma_min
        ts = t_of_sigma(sigmas, table)
    else:
        raise ValueError(f"unknown schedule {schedule!r}; options: {SCHEDULES}")
    sigmas = torch.cat([sigmas, torch.zeros(1)])
    return ts.to(device), sigmas.to(device)


_ROWS: contextvars.ContextVar = contextvars.ContextVar("noise_rows", default=(0, 1))


@contextlib.contextmanager
def global_rows(rank: int, parts: int):
    """Inside the block every draw of ``_normal`` is rows ``rank`` of
    ``parts`` equal parts of the global batch's draw: a rank of a mesh's
    data axis draws the noise the dense call draws for its rows."""
    token = _ROWS.set((rank, parts))
    try:
        yield
    finally:
        _ROWS.reset(token)


def _draw(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def _normal(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """Standard-normal fp32 noise shaped like ``like``: every draw of the
    ancestral samplers, the re-noising of the hires fix and img2img's
    noise; under ``global_rows`` this rank's rows of the global draw."""
    r, n = _ROWS.get()
    if n == 1:
        return _draw(generator, like.shape, like.device)
    b = like.shape[0]
    return _draw(generator, (b * n, *like.shape[1:]), like.device)[r * b:(r + 1) * b]


def _ancestral_split(sig, sig_next):
    """(sigma_up, sigma_down): the step's variance split into fresh noise
    and a deterministic step."""
    var_up = sig_next ** 2 * (sig ** 2 - sig_next ** 2) / torch.clamp(sig ** 2, min=1e-12)
    sigma_up = torch.sqrt(torch.clamp(var_up, min=0.0))
    sigma_down = torch.sqrt(torch.clamp(sig_next ** 2 - sigma_up ** 2, min=0.0))
    return sigma_up, sigma_down


def _neg_log(sig):
    return -torch.log(torch.clamp(sig, min=1e-10))


def sample(
    model_fn: Callable,
    latent: torch.Tensor,
    num_steps: int,
    *,
    method: str = "euler",
    generator: Optional[torch.Generator] = None,
    aux_init=None,
    schedule: str = "ladder",
    start_index: int = 0,
) -> torch.Tensor:
    """Run the sampler down the ``num_steps`` ladder from rung
    ``start_index`` (0: from pure noise; k > 0 skips the k noisiest rungs,
    the img2img / hires "strength").

    latent: DDPM-space x_t at rung ``start_index``. Returns the final
    latent in latent's dtype. ``generator`` drives the ancestral
    samplers' noise; ``aux_init`` makes model_fn a 3-argument function (see
    the module docstring). ddim is defined on the discrete ladder and
    refuses "karras"."""
    if not 0 <= start_index < num_steps:
        raise ValueError(f"start_index {start_index} outside [0, {num_steps})")
    if method not in SAMPLERS:
        raise ValueError(f"unknown sampler {method!r}; options: {SAMPLERS}")
    if aux_init is None:
        def mfn(x, t, aux, _raw=model_fn):
            return _raw(x, t), aux
    else:
        mfn = model_fn
    aux = aux_init

    if method == "ddim":
        if schedule != "ladder":
            raise ValueError(
                "ddim is defined on the discrete timestep ladder; use a sigma-space "
                f"sampler (euler/heun/dpmpp_*) with schedule={schedule!r}")
        return _sample_ddim(mfn, aux, latent, num_steps, start_index)
    if "ancestral" in method and generator is None:
        raise ValueError(f"{method} needs a torch.Generator for its noise")

    dev = latent.device
    ts, sigmas = sigma_ladder(num_steps, schedule, device=dev)
    X = latent.float() * torch.sqrt(1.0 + sigmas[start_index] ** 2)
    last = num_steps - 1

    def call(X_in, sig, t, aux):
        x_in = (X_in / torch.sqrt(1.0 + sig ** 2)).to(latent.dtype)  # DDPM space
        eps, aux = mfn(x_in, t, aux)
        return eps.float(), aux

    if method == "dpmpp_2s_ancestral":
        table = _sigma_table().to(dev)
    old_den = None
    for i in range(start_index, num_steps):
        sig, sig_next, t = sigmas[i], sigmas[i + 1], ts[i]
        eps, aux = call(X, sig, t, aux)
        if method == "euler":
            X = X + eps * (sig_next - sig)
        elif method == "euler_ancestral":
            sigma_up, sigma_down = _ancestral_split(sig, sig_next)
            X = X + eps * (sigma_down - sig)
            X = X + sigma_up * _normal(generator, X)
        elif method == "heun":
            # Euler predictor to sig_next, then the trapezoid with the
            # slope there, at the next ladder timestep; the terminal step
            # (sig_next = 0) stays Euler
            dt = sig_next - sig
            X_pred = X + eps * dt
            if i == last:
                X = X_pred
            else:
                eps2, aux = call(X_pred, sig_next, ts[i + 1], aux)
                X = X + 0.5 * (eps + eps2) * dt
        elif method == "dpmpp_2s_ancestral":
            den = X - sig * eps
            sigma_up, sigma_down = _ancestral_split(sig, sig_next)
            if i == last:  # sigma_down = 0: Euler to the denoised latent
                X_det = den
            else:
                # DPM-Solver++(2S): a midpoint in log-sigma time toward
                # sigma_down, evaluated at its own timestep
                lt, lt_down = _neg_log(sig), _neg_log(sigma_down)
                h = lt_down - lt
                s_mid = torch.exp(-(lt + 0.5 * h))
                X_mid = (s_mid / torch.clamp(sig, min=1e-12)) * X - torch.expm1(-0.5 * h) * den
                eps_mid, aux = call(X_mid, s_mid, t_of_sigma(s_mid, table), aux)
                den_mid = X_mid - s_mid * eps_mid
                X_det = (sigma_down / torch.clamp(sig, min=1e-12)) * X - torch.expm1(-h) * den_mid
                X_det = torch.where(sigma_down > 0.0, X_det, den)
            X = X_det + sigma_up * _normal(generator, X)
        else:  # dpmpp_2m
            den = X - sig * eps
            lt, lt_next = _neg_log(sig), _neg_log(sig_next)
            h = lt_next - lt
            if old_den is None:
                den2 = den
            else:
                h_last = lt - _neg_log(sigmas[i - 1])
                r = h_last / torch.clamp(h, min=1e-10)
                den2 = (1.0 + 1.0 / (2.0 * r)) * den - (1.0 / (2.0 * r)) * old_den
            X = (sig_next / torch.clamp(sig, min=1e-12)) * X - torch.expm1(-h) * den2
            old_den = den
    return X.to(latent.dtype)


def _sample_ddim(mfn, aux, latent, num_steps, start_index=0):
    # The ladder goes to the device once: the timestep reaches the UNet as
    # float32, and a host scalar per step would be a blocking copy.
    timesteps = torch.tensor(ddim_mod.ddim_timesteps_np(num_steps)[::-1].tolist(),
                             dtype=torch.float32, device=latent.device)
    alphas, alphas_prev = ddim_mod.ddim_alphas(num_steps, device=latent.device)
    alphas, alphas_prev = alphas.flip(0), alphas_prev.flip(0)
    lat = latent
    for i in range(start_index, num_steps):
        eps, aux = mfn(lat, timesteps[i], aux)
        lat = ddim_mod.ddim_step(lat, eps, alphas[i], alphas_prev[i])
    return lat
