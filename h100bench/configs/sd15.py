"""SD1.5 (configs/sd15.json): the port's model with the benchmark's seeded
weights, the plain reference with the same weights, and the work of each
stage for the analytic counts."""
from __future__ import annotations

from h100bench.counts import flops
from h100bench.lib import weights
from h100bench.reference import pipelines


def spec(cfg):
    return pipelines.sd_spec(cfg)


def port_config(cfg):
    from tinyfusers_tpu_torch.models import clip, unet, vae
    from tinyfusers_tpu_torch.pipeline import sd

    u = dict(cfg["unet"], channel_mult=tuple(cfg["unet"]["channel_mult"]),
             attention_levels=tuple(cfg["unet"]["attention_levels"]))
    v = dict(cfg["vae"], channel_mult=tuple(cfg["vae"]["channel_mult"]))
    return sd.SDConfig(clip=clip.CLIPConfig(**cfg["clip"]), unet=unet.UNetConfig(**u),
                       vae=vae.VAEConfig(**v), height=cfg["height"], width=cfg["width"],
                       prediction_type=cfg["prediction_type"])


def build(cfg, seed: int, device):
    """The port's pipeline.sd.StableDiffusion with the seeded weights."""
    from tinyfusers_tpu_torch.pipeline import sd

    dtype = pipelines.DTYPES[cfg["dtype"]]
    model = sd.StableDiffusion(port_config(cfg), device=device, dtype=dtype, seed=None)
    model.load_state_dict(weights.make(spec(cfg), seed, device, dtype), strict=True)
    return model


def reference(cfg, seed: int, device, prec: str = "fp32"):
    W = weights.make(spec(cfg), seed, device, pipelines.DTYPES[cfg["dtype"]])
    return pipelines.Reference(cfg, W, prec)


def latent_hw(cfg):
    f = 2 ** (len(cfg["vae"]["channel_mult"]) - 2)
    return cfg["height"] // f, cfg["width"] // f


def work(cfg, kind: str, n: int):
    """(FLOPs, kernel calls) of one stage: "denoise" (one UNet call on n
    rows), "decode" (n images), "encode" (n prompts)."""
    h, w = latent_hw(cfg)
    t, item = cfg["clip"]["max_length"], pipelines.DTYPES[cfg["dtype"]].itemsize
    if kind == "denoise":
        return (flops.unet_flops(cfg["unet"], h, w, n, t),
                flops.unet_calls(cfg["unet"], h, w, n, t, item))
    if kind == "decode":
        return (flops.vae_decode_flops(cfg["vae"], h, w, n),
                flops.vae_decode_calls(cfg["vae"], h, w, n, item))
    if kind == "encode":
        return flops.clip_flops(cfg["clip"], n), []
    raise ValueError(kind)
