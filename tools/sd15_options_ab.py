"""Time SD1.5 images with the CLI's options against the plain image, in
turns, in one process on one NVIDIA GPU.

    python3 tools/sd15_options_ab.py [--rounds 5]

Builds the SD1.5 job of examples/txt2img_torch.py (seeded random weights,
bf16, 512x512, 20-step DDIM, CFG 7.5) and an SD1.5 ControlNet (seeded; its
zero convs stay zero, which changes no work), makes one warm-up image of
each option, then ``--rounds`` rounds of one image per option, each round
in a rotated order: plain, FreeU (1.5, 1.6, 0.9, 0.2), ControlNet,
DeepCache interval 3 split 3, and DeepCache with cached CFG interval 2.
Each image is timed by the host clock after synchronize, with a
gc.collect() before it. Prints the card's name and power limit, then one
JSON line: per option the seconds of each image, their median and the
median over the plain image's.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    sys.path[:0] = [str(ROOT), str(ROOT / "examples")]
    import txt2img_torch

    from tinyfusers_tpu_torch.models import controlnet

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    base = txt2img_torch.build(txt2img_torch.parse_args(
        ["--preset", "sd15", "--fallback-tokenizer", "--seed", "5"]))
    dev = base.latent.device
    cn = controlnet.ControlNet(base.model.cfg.unet, device=dev, dtype=torch.bfloat16, seed=21)
    hint = torch.rand((1, 512, 512, 3), generator=torch.Generator(device=dev).manual_seed(27),
                      device=dev)

    def option(control=None, **kw):
        return dataclasses.replace(base, control=control, args=argparse.Namespace(
            **dict(vars(base.args), **kw)))

    jobs = {"plain": base, "freeu": option(freeu=(1.5, 1.6, 0.9, 0.2)),
            "controlnet": option(control=(cn, hint, 1.0)),
            "deepcache": option(deepcache_interval=3, deepcache_split=3),
            "deepcache_cached_cfg": option(deepcache_interval=3, deepcache_split=3,
                                           uncond_interval=2)}
    for job in jobs.values():
        job.image()
    names = list(jobs)
    secs = {name: [] for name in names}
    for r in range(args.rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            gc.collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            jobs[name].image()
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
    median = {name: statistics.median(v) for name, v in secs.items()}
    print(card)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "rounds": args.rounds, "s_per_image": secs, "median_s": median,
                      "median_over_plain": {k: v / median["plain"] for k, v in median.items()}}))


if __name__ == "__main__":
    main()
