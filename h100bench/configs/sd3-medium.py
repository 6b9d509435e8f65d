"""SD3-medium (configs/sd3-medium.json): the port's model with the
benchmark's seeded weights, the plain reference with the same weights,
and the work of each stage for the analytic counts."""
from __future__ import annotations

from h100bench.counts import flops
from h100bench.lib import weights
from h100bench.reference import pipelines


def spec(cfg):
    return pipelines.sd3_spec(cfg)


def port_config(cfg):
    from tinyfusers_tpu_torch.models import clip, mmdit, vae
    from tinyfusers_tpu_torch.pipeline import sd3

    v = dict(cfg["vae"], channel_mult=tuple(cfg["vae"]["channel_mult"]))
    return sd3.SD3Config(clip_l=clip.CLIPConfig(**cfg["clip_l"]),
                         clip_g=clip.CLIPConfig(**cfg["clip_g"]),
                         mmdit=mmdit.MMDiTConfig(**cfg["mmdit"]), vae=vae.VAEConfig(**v),
                         t5=None, height=cfg["height"], width=cfg["width"], shift=cfg["shift"])


def build(cfg, seed: int, device):
    """The port's pipeline.sd3.StableDiffusion3 with the seeded weights."""
    from tinyfusers_tpu_torch.pipeline import sd3

    dtype = pipelines.DTYPES[cfg["dtype"]]
    model = sd3.StableDiffusion3(port_config(cfg), device=device, dtype=dtype, seed=None)
    model.load_state_dict(weights.make(spec(cfg), seed, device, dtype), strict=True)
    return model


def reference(cfg, seed: int, device, prec: str = "fp32"):
    W = weights.make(spec(cfg), seed, device, pipelines.DTYPES[cfg["dtype"]])
    return pipelines.Reference(cfg, W, prec)


def latent_hw(cfg):
    f = 2 ** (len(cfg["vae"]["channel_mult"]) - 2)
    return cfg["height"] // f, cfg["width"] // f


def work(cfg, kind: str, n: int):
    """(FLOPs, kernel calls) of one stage: "denoise" (one MMDiT call on n
    rows), "decode" (n images), "encode" (n prompts through both towers)."""
    h, w = latent_hw(cfg)
    t, item = cfg["mmdit"]["context_len"], pipelines.DTYPES[cfg["dtype"]].itemsize
    if kind == "denoise":
        return (flops.mmdit_flops(cfg["mmdit"], h, w, n, t),
                flops.mmdit_calls(cfg["mmdit"], h, w, n, t, item))
    if kind == "decode":
        return (flops.vae_decode_flops(cfg["vae"], h, w, n),
                flops.vae_decode_calls(cfg["vae"], h, w, n, item))
    if kind == "encode":
        return flops.clip_flops(cfg["clip_l"], n) + flops.clip_flops(cfg["clip_g"], n), []
    raise ValueError(kind)
