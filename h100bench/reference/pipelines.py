"""The two text-to-image pipelines, plain float32, from token ids and a
seed to an image in levels (H, W, 3).

- ``sd_image``: Stable Diffusion 1.x with classifier-free guidance and the
  deterministic DDIM sampler (Song et al. 2021, eta 0). The betas are the
  squared linspace of sqrt(0.00085) .. sqrt(0.012) over 1000 steps; a run
  of n steps visits t = 1 + k * (1000 // n) for k = n-1 .. 0, each step
  moving to the next lower rung (to alpha_bar = 1 after t = 1). The
  guided noise is e_u + g (e_c - e_u). The initial latent is the standard
  normal draw of a ``torch.Generator`` seeded with the request's seed, of
  shape (1, h, w, C), rounded to the served dtype.
- ``sd3_image``: Stable Diffusion 3 with the rectified-flow Euler sampler
  on the shifted ladder sigma(u) = s u / (1 + (s - 1) u), u from 1 to 0
  in n steps, and guidance v_u + g (v_c - v_u). The conditioning is the
  two CLIP towers' penultimate states side by side, zero-padded to the
  MMDiT's context width, and their pooled vectors side by side.

Both decode with the VAE and return levels truncated as a uint8 cast
truncates. Nothing here imports the program under test.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from . import clip, mmdit, nn, unet, vae

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def sd_spec(cfg: dict):
    return (clip.spec(cfg["clip"], "clip") + unet.spec(cfg["unet"], "unet")
            + vae.spec(cfg["vae"], "vae"))


def sd3_spec(cfg: dict):
    return (clip.spec(cfg["clip_l"], "clip_l") + clip.spec(cfg["clip_g"], "clip_g")
            + mmdit.spec(cfg["mmdit"], "mmdit") + vae.spec(cfg["vae"], "vae"))


def alphas_cumprod(sched: dict) -> np.ndarray:
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5,
                        sched["num_train_timesteps"], dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def ddim_rungs(num_steps: int, n_train: int = 1000) -> np.ndarray:
    """The ascending timesteps a run of num_steps visits."""
    return (1 + np.arange(num_steps) * (n_train // num_steps)).astype(np.int64)


def flow_ladder(num_steps: int, shift: float) -> np.ndarray:
    u = np.linspace(1.0, 0.0, num_steps + 1)
    return shift * u / (1.0 + (shift - 1.0) * u)


def initial_noise(seed: int, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """The standard-normal draw of a Generator on ``device`` seeded with
    ``seed``, in float32, rounded to ``dtype``, back in float32."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype).float()


def _ids(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)[None]


def _levels(x: torch.Tensor) -> torch.Tensor:
    return nn.to_levels(x.permute(0, 2, 3, 1))


class Reference:
    """One configuration's reference: its config dict, the weights W (name
    -> tensor, any float dtype) and the arithmetic ``prec``."""

    def __init__(self, cfg: dict, W: Dict[str, torch.Tensor], prec: str = "fp32"):
        self.cfg, self.W, self.P = cfg, W, nn.Prec(prec)

    @torch.no_grad()
    def sd_image(self, prompt_ids, uncond_ids, num_steps: int, guidance: float,
                 seed: int) -> torch.Tensor:
        """SD1.x: ids (T,) each -> levels (H, W, 3) float32."""
        cfg, W, P = self.cfg, self.W, self.P
        dev = next(iter(W.values())).device
        with nn.fp32_matmuls():
            ids = torch.as_tensor(np.stack([uncond_ids, prompt_ids]), dtype=torch.long, device=dev)
            ctx = clip.forward(P, W, cfg["clip"], "clip", ids)[0]  # [uncond, cond]
            f = 2 ** (len(cfg["vae"]["channel_mult"]) - 2)
            h, w, c = cfg["height"] // f, cfg["width"] // f, cfg["vae"]["latent_channels"]
            x = initial_noise(seed, (1, h, w, c), DTYPES[cfg["dtype"]], dev).permute(0, 3, 1, 2)
            acp = alphas_cumprod(cfg["scheduler"])
            rungs = ddim_rungs(num_steps, cfg["scheduler"]["num_train_timesteps"])
            for i in range(num_steps - 1, -1, -1):
                a_t = float(acp[rungs[i]])
                a_prev = float(acp[rungs[i - 1]]) if i > 0 else 1.0
                t = torch.full((2,), float(rungs[i]), device=dev)
                e = unet.forward(P, W, cfg["unet"], "unet", torch.cat([x, x]), t, ctx)
                e = e[0:1] + guidance * (e[1:2] - e[0:1])
                x0 = (x - (1.0 - a_t) ** 0.5 * e) / a_t ** 0.5
                x = a_prev ** 0.5 * x0 + (1.0 - a_prev) ** 0.5 * e
            return _levels(vae.decode(P, W, cfg["vae"], "vae", x))[0]

    def _sd3_context(self, ids_l, ids_g):
        cfg, W, P = self.cfg, self.W, self.P
        _, hl, pl = clip.forward(P, W, cfg["clip_l"], "clip_l", ids_l)
        _, hg, pg = clip.forward(P, W, cfg["clip_g"], "clip_g", ids_g)
        joint = torch.cat([hl, hg], dim=-1)
        ctx = F.pad(joint, (0, cfg["mmdit"]["context_dim"] - joint.shape[-1]))
        return ctx, torch.cat([pl, pg], dim=-1)

    @torch.no_grad()
    def sd3_image(self, ids_l, ids_g, uids_l, uids_g, latent: torch.Tensor, num_steps: int,
                  guidance: float) -> torch.Tensor:
        """SD3: ids (T,) each, latent (1, h, w, C) as served -> levels (H, W, 3)."""
        cfg, W, P = self.cfg, self.W, self.P
        dev = next(iter(W.values())).device
        with nn.fp32_matmuls():
            cc, pc = self._sd3_context(_ids(ids_l, dev), _ids(ids_g, dev))
            cu, pu = self._sd3_context(_ids(uids_l, dev), _ids(uids_g, dev))
            ctx, pooled = torch.cat([cu, cc]), torch.cat([pu, pc])
            x = latent.to(dev).float().permute(0, 3, 1, 2)
            ts = flow_ladder(num_steps, cfg["shift"])
            for i in range(num_steps):
                t = torch.full((2,), float(ts[i]), device=dev)
                v = mmdit.forward(P, W, cfg["mmdit"], "mmdit", torch.cat([x, x]), t, ctx, pooled)
                v = v[0:1] + guidance * (v[1:2] - v[0:1])
                x = x + float(ts[i + 1] - ts[i]) * v
            return _levels(vae.decode(P, W, cfg["vae"], "vae", x))[0]
