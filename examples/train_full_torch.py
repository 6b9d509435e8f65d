"""Full-parameter fine-tune CLI of the PyTorch + CUDA port: the
counterpart of examples/train_full.py (every flag, the same output lines
and the same saved file).

    python examples/train_full_torch.py --preset tiny --cpu --steps 60 --lr 3e-4
    python examples/train_full_torch.py --preset sd15 --steps 60 --batch 4 \\
        --optimizer adamw --remat

Drives all of the UNet's parameters (~860M at sd15) through
train.make_train_step on one device, the GPU unless --cpu is given.
Optimizer options, as the JAX CLI's: adamw (moments in the parameters'
dtype), adamw-f32 (an fp32 first moment), sgdm (SGD with momentum 0.9),
adafactor (factored second moment). Where the JAX CLI prints the
compiled step's memory reservation, this one prints the card's held and
peak memory after step 1 and the optimizer state's bytes. Data: seeded
synthetic (latent, context) pairs, the JAX CLI's numbers; --ckpt loads an
SD1.x checkpoint's UNet.

``build(args)`` gives the job (model, state, step) without running it,
so a caller in the same process (chip_smoke.py, the tests) can time its
steps and read the kernels' launch counts; ``main(argv)`` runs it and
returns the final TrainState.
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


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tinyfusers full fine-tune (PyTorch port)")
    p.add_argument("--preset", choices=["sd15", "tiny"], default="sd15")
    p.add_argument("--ckpt", default=None, help="SD1.x base checkpoint")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--objective", choices=["eps", "v"], default="eps")
    p.add_argument("--optimizer", choices=["adamw", "adamw-f32", "sgdm", "adafactor"],
                   default="adamw")
    p.add_argument("--remat", action="store_true", default=True)
    p.add_argument("--no-remat", dest="remat", action="store_false")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--out", default=None,
                   help="save fine-tuned UNet weights here (safetensors)")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def synthetic_pairs(cfg, batch: int, seed: int):
    """The JAX CLIs' seeded (latents, context) arrays, numpy fp32."""
    lat_hw = cfg.height // 8
    rng = np.random.default_rng(seed)
    n = max(batch * 4, 16)
    latents = rng.standard_normal((n, lat_hw, lat_hw, cfg.unet.in_channels), np.float32)
    context = rng.standard_normal((n, cfg.clip.max_length, cfg.unet.context_dim), np.float32)
    return latents, context


@dataclass
class Batches:
    """Endless batches of a dataset's epochs, moved to the device."""
    dataset: Any
    device: Any
    dtype: Any
    _it: Any = None

    def __call__(self):
        import torch

        batch = next(self._it, None) if self._it is not None else None
        if batch is None:
            self._it = self.dataset.epoch()
            batch = next(self._it)
        return tuple(torch.as_tensor(b).to(self.device, self.dtype) for b in batch)


@dataclass
class Job:
    args: argparse.Namespace
    cfg: Any
    unet: Any
    state: Any
    step_fn: Any
    batches: Batches
    generator: Any
    layouts: dict
    opt_bytes: int

    def step(self, batch=None):
        """One optimizer step on the next batch (or ``batch``) -> metrics."""
        self.state, metrics = self.step_fn(self.state, batch or self.batches(),
                                           self.generator)
        return metrics


def make_optimizer(name: str, lr: float, layouts):
    import torch

    from tinyfusers_tpu_torch import train
    from tinyfusers_tpu_torch.train import optim

    if name == "adamw":
        return train.default_optimizer(lr)
    if name == "adamw-f32":
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(lr, mu_dtype=torch.float32))
    if name == "sgdm":
        return optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(lr, momentum=0.9))
    return optim.adafactor(lr, layouts=layouts)


def build(args: argparse.Namespace) -> Job:
    import torch

    from tinyfusers_tpu_torch import train
    from tinyfusers_tpu_torch.device import resolve_device
    from tinyfusers_tpu_torch.models import unet as unet_mod
    from tinyfusers_tpu_torch.models.layers import init_weights, set_trainable
    from tinyfusers_tpu_torch.pipeline import sd
    from tinyfusers_tpu_torch.train import optim

    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = sd.SD15 if args.preset == "sd15" else sd.TINY
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.ckpt:
        from tinyfusers_tpu_torch.io import checkpoints

        unet = checkpoints.load_sd_params(args.ckpt, cfg, device=dev, dtype=dtype).unet
    else:
        print("no --ckpt: fine-tuning seeded random weights (boundary probe)")
        unet = unet_mod.UNet(cfg.unet, device=dev, dtype=dtype)
        init_weights(unet, args.seed)
    params = train.params_of(set_trainable(unet), trainable_only=True)
    n_params = sum(p.numel() for p in params.values())
    print(f"UNet params: {n_params / 1e6:.0f}M ({args.dtype})", flush=True)

    ds = train.LatentDataset(*synthetic_pairs(cfg, args.batch, args.seed),
                             batch_size=args.batch, seed=args.seed)
    layouts = train.param_layouts(unet)
    opt = make_optimizer(args.optimizer, args.lr, layouts)
    step_fn = train.make_train_step(train.module_apply(unet), opt,
                                    train.LossConfig(objective=args.objective),
                                    remat=args.remat)
    state = train.TrainState.create(params, opt)
    opt_bytes = optim.state_bytes(state.opt_state)
    print(f"optimizer state: {opt_bytes / 1e9:.2f} GB ({args.optimizer})", flush=True)
    generator = torch.Generator(device=dev).manual_seed(args.seed + 2)
    return Job(args, cfg, unet, state, step_fn, Batches(ds, dev, dtype), generator, layouts,
               opt_bytes)


def memory_line(device, opt_bytes: int) -> str:
    """The card's held and peak memory (after step 1) and the optimizer
    state's bytes: what the JAX CLI's AOT reservation line stands for."""
    import torch

    if device.type != "cuda":
        return (f"device memory: not measured on the CPU; optimizer state "
                f"{opt_bytes / 1e9:.2f} GB")
    return (f"device memory after step 1: held {torch.cuda.memory_allocated(device) / 1e9:.2f}"
            f" GB, peak {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB; optimizer "
            f"state {opt_bytes / 1e9:.2f} GB")


def save_unet(job: Job, path) -> None:
    """The fine-tuned UNet as an SD-format fp16 safetensors file (the JAX
    CLI's state_map.unet_to_state)."""
    import torch

    from tinyfusers_tpu_torch.io import safetensors_io, state_map

    with torch.no_grad():
        for name, p in job.unet.named_parameters():
            if name in job.state.params:
                p.copy_(job.state.params[name])
    sdict = state_map.unet_to_state(job.unet)
    safetensors_io.save_state_dict({k: v.to(torch.float16) for k, v in sdict.items()}, path)


def main(argv: Optional[List[str]] = None):
    import torch

    args = parse_args(argv)
    job = build(args)
    dev = job.generator.device
    t0 = time.perf_counter()
    t_mark, s_mark = t0, 0
    done = 0
    while done < args.steps:
        metrics = job.step()
        done = job.state.step
        if done == 1:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            print(f"first step: {time.perf_counter() - t0:.1f}s", flush=True)
            print(memory_line(dev, job.opt_bytes), flush=True)
            t_mark, s_mark = time.perf_counter(), 1
        if done % args.log_every == 0 or done == args.steps:
            loss = float(metrics["loss"])  # waits for the step
            rate = (done - s_mark) / max(time.perf_counter() - t_mark, 1e-9)
            print(f"step {done:5d}  loss {loss:.4f}  gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{rate:.2f} steps/s", flush=True)
    if args.out:
        save_unet(job, args.out)
        print(f"saved {args.out}")
    return job.state


if __name__ == "__main__":
    main()
