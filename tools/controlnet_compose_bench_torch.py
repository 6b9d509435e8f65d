"""ControlNet composed with cached CFG and DeepCache: fidelity and speed
(the port's counterpart of benchmarks/controlnet_compose_bench.py).

    python3 tools/controlnet_compose_bench_torch.py [--steps 20]
        [--preset sd15|tiny] [--cpu]

The JAX tool's measurement on the port's SD1.5 (or TINY), bf16: one
``--steps``-step DDIM CFG 7.5 image in each of four modes (exact +
control, cached CFG u = 2, DeepCache k = 2, both), each with the
ControlNet's residuals (pipeline/sd.py refreshes them on full passes and
reuses them on shallow ones); per mode the best of 3 timed images (after
one untimed) as images/s, and the PSNR of the image against the exact
controlled image.

As in the JAX tool: the ControlNet's zero convs and middle output start
at 0.02 (weights; biases as the init leaves them) so that control
contributes, the hint is a 32-pixel checkerboard at the image's size,
the ids are 3s and the negative ids 0s, the scale 1.0. The weights are
the port's seeded init (``StableDiffusion(seed=0)``, ``ControlNet(seed=1)``:
the JAX init's distributions drawn by a torch.Generator on the device),
since the JAX tool's fill lives in bench.py, which imports jax; the latent
is ``sd.initial_latent(2, ...)``. Runs on the GPU unless ``--cpu`` is
given.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tinyfusers_tpu_torch.models import controlnet  # noqa: E402
from tinyfusers_tpu_torch.pipeline import sd  # noqa: E402

GUIDANCE = 7.5
GATE = 0.02
# (mode, generate's options): the JAX tool's four
MODES = [
    ("exact+control", {}),
    ("cached_cfg u=2", {"uncond_interval": 2}),
    ("deepcache k=2", {"deepcache_interval": 2}),
    ("dc k=2 + u=2", {"deepcache_interval": 2, "uncond_interval": 2}),
]


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * math.log10(peak * peak / mse)


def open_gates(cn: controlnet.ControlNet, value: float = GATE) -> controlnet.ControlNet:
    """Every zero conv's weight and the middle output's set to ``value``."""
    with torch.no_grad():
        for conv in [*cn.zero_convs, cn.middle_out]:
            conv.weight.fill_(value)
    return cn


def checkerboard(cfg: sd.SDConfig, device) -> torch.Tensor:
    """(1, 8h, 8w, 3) fp32: 32-pixel squares of 0 and 1 over the image."""
    hh, ww = cfg.latent_shape[0] * 8, cfg.latent_shape[1] * 8
    yy, xx = np.mgrid[0:hh, 0:ww]
    board = np.stack([(yy // 32 + xx // 32) % 2] * 3, -1)[None].astype(np.float32)
    return torch.from_numpy(board).to(device)


def build(preset: str, device) -> dict:
    """The tool's inputs: model, control (ControlNet, hint, scale), ids,
    negative ids, latent."""
    cfg = sd.SD15 if preset == "sd15" else sd.TINY
    dtype = torch.bfloat16
    model = sd.StableDiffusion(cfg, device=device, dtype=dtype, seed=0)
    dev = next(model.parameters()).device
    cn = open_gates(controlnet.ControlNet(cfg.unet, device=dev, dtype=dtype, seed=1))
    ids = torch.full((1, cfg.clip.max_length), 3, dtype=torch.long, device=dev)
    return dict(model=model, control=(cn, checkerboard(cfg, dev), 1.0), ids=ids,
                uids=torch.zeros_like(ids),
                latent=sd.initial_latent(2, 1, cfg, device=dev, dtype=dtype))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_modes(model, control, ids, uids, latent, steps: int, *, repeats: int = 3,
              counted: Optional[Callable[[str], contextlib.AbstractContextManager]] = None,
              report: Callable[[str], None] = print) -> List[Dict[str, object]]:
    """Each mode's image: one untimed, then ``repeats`` timed (the first of
    them inside ``counted(mode)`` when given); rows of mode, images/s of
    the best, its seconds, every timed image's seconds, PSNR against the
    exact controlled image (None for it) and the image (uint8 numpy)."""
    rows, exact = [], None
    for name, kw in MODES:
        def image():
            return sd.generate(model, ids, uids, latent, GUIDANCE, num_steps=steps,
                               control=control, **kw)

        img = image().cpu().numpy()
        secs = []
        for i in range(repeats):
            with counted(name) if counted is not None and i == 0 else contextlib.nullcontext():
                _sync(latent.device)
                t0 = time.perf_counter()
                image()
                _sync(latent.device)
                secs.append(time.perf_counter() - t0)
        best = min(secs)
        row = {"mode": name, "images_per_s": 1.0 / best, "best_s": best, "seconds": secs,
               "psnr": None if exact is None else psnr(img, exact), "image": img}
        line = f"{name:16s} {1.0 / best:6.3f} img/s  ({best:.3f} s)"
        if exact is None:
            exact = img
        else:
            line += f"  PSNR vs exact: {row['psnr']:.1f} dB"
        report(line)
        rows.append(row)
    return rows


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    p.add_argument("--preset", choices=["tiny", "sd15"], default="sd15")
    return p.parse_args(argv)


@torch.inference_mode()
def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    """Runs every mode and prints a row each; returns the rows."""
    args = parse_args(argv)
    job = build(args.preset, "cpu" if args.cpu else "cuda")
    return run_modes(job["model"], job["control"], job["ids"], job["uids"], job["latent"],
                     args.steps)


if __name__ == "__main__":
    main()
