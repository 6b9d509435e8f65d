"""LoRA fine-tuning CLI of the PyTorch + CUDA port: the counterpart of
examples/train_lora.py (every flag, the same output lines and the same
adapter file: dotted keys ``<weight's path>.a`` / ``.b`` in the JAX
layout, fp32).

    python examples/train_lora_torch.py --preset tiny --cpu --steps 30
    python examples/train_lora_torch.py --preset sd15 --ckpt sd-v1-5.safetensors \\
        --data pairs.npz --steps 1000 --rank 8 --out lora.safetensors

Trains low-rank adapters over a frozen base UNet with the eps (or v)
objective on (latent, text-embedding) pairs: --data is an .npz with
``latents`` (N, H/8, W/8, 4) and ``context`` (N, 77, ctx_dim), or a .tfls
shard (train.write_shard) served by the native prefetching loader;
without it, the JAX CLI's seeded synthetic set. It runs on the GPU unless
--cpu is given. --ema is parsed and unused, as in the JAX CLI.

``build(args)`` gives the job without running it (chip_smoke.py times
its steps); ``main(argv)`` runs it and returns the final TrainState.
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from train_full_torch import Batches, synthetic_pairs  # noqa: E402


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tinyfusers LoRA fine-tune (PyTorch port)")
    p.add_argument("--preset", choices=["sd15", "tiny"], default="sd15")
    p.add_argument("--ckpt", default=None, help="SD1.x base checkpoint")
    p.add_argument("--data", default=None,
                   help=".npz with latents (N,h,w,4) + context (N,77,ctx), "
                        "or a .tfls native shard (train.write_shard)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--objective", choices=["eps", "v"], default="eps")
    p.add_argument("--snr-gamma", type=float, default=None)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="recompute activations in backward (fits bigger batches)")
    p.add_argument("--out", default="lora.safetensors")
    p.add_argument("--resume", default=None, help="train-state checkpoint")
    p.add_argument("--save-state", default=None,
                   help="also save the full train state here (resume later)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    p.add_argument("--log-every", type=int, default=10)
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return _parser().parse_args(argv)


@dataclass
class Job:
    args: argparse.Namespace
    cfg: Any
    unet: Any
    base: dict
    state: Any
    step_fn: Any
    batches: Batches
    generator: Any

    def step(self, batch=None):
        """One optimizer step of the adapters -> metrics."""
        self.state, metrics = self.step_fn(self.state, self.base, batch or self.batches(),
                                           self.generator)
        return metrics


def build(args: argparse.Namespace) -> Job:
    import torch

    from tinyfusers_tpu_torch import train
    from tinyfusers_tpu_torch.device import resolve_device
    from tinyfusers_tpu_torch.models import unet as unet_mod
    from tinyfusers_tpu_torch.models.layers import init_weights
    from tinyfusers_tpu_torch.pipeline import sd

    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = sd.SD15 if args.preset == "sd15" else sd.TINY
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.ckpt:
        from tinyfusers_tpu_torch.io import checkpoints

        unet = checkpoints.load_sd_params(args.ckpt, cfg, device=dev, dtype=dtype).unet
    else:
        print("no --ckpt: training adapters over seeded random base weights (smoke mode)")
        unet = unet_mod.UNet(cfg.unet, device=dev, dtype=dtype)
        init_weights(unet, args.seed)
    base = train.params_of(unet)

    if args.data and str(args.data).endswith(".tfls"):
        ds = train.NativeShardDataset(args.data, batch_size=args.batch, seed=args.seed)
    else:
        if args.data:
            blob = np.load(args.data)
            arrays = (blob["latents"], blob["context"])
        else:
            arrays = synthetic_pairs(cfg, args.batch, args.seed)
        ds = train.LatentDataset(*arrays, batch_size=args.batch, seed=args.seed)

    loss_cfg = train.LossConfig(objective=args.objective, snr_gamma=args.snr_gamma)
    opt = train.default_optimizer(args.lr, warmup_steps=min(100, args.steps // 10))
    step_fn = train.make_lora_train_step(train.module_apply(unet), opt, loss_cfg,
                                         remat=args.remat)
    lora = train.init_lora(torch.Generator(device=dev).manual_seed(args.seed + 1), base,
                           rank=args.rank)
    state = train.TrainState.create(lora, opt)
    if args.resume:
        state = train.load_train_state(state, args.resume)
        print(f"resumed at step {state.step}")
    generator = torch.Generator(device=dev).manual_seed(args.seed + 2)
    return Job(args, cfg, unet, base, state, step_fn, Batches(ds, dev, dtype), generator)


def main(argv: Optional[List[str]] = None):
    import torch

    from tinyfusers_tpu_torch import train
    from tinyfusers_tpu_torch.io import safetensors_io

    args = parse_args(argv)
    job = build(args)
    dev = job.generator.device
    t0 = time.perf_counter()
    done = job.state.step
    while done < args.steps:
        metrics = job.step()
        done = job.state.step
        if done == 1 and dev.type == "cuda":
            print(f"device memory in use after step 1: "
                  f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
                  f"(peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB)")
        if done % args.log_every == 0 or done == args.steps:
            print(f"step {done:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{done / (time.perf_counter() - t0):.2f} steps/s", flush=True)

    safetensors_io.save_state_dict(dict(job.state.params), args.out)
    print(f"saved {len(job.state.params)} adapter tensors (rank {args.rank}) -> {args.out}")
    if args.save_state:
        train.save_train_state(job.state, args.save_state)
        print(f"saved train state -> {args.save_state}")
    return job.state


if __name__ == "__main__":
    main()
