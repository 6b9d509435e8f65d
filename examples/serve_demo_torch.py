"""Continuous-batching serving demo of the PyTorch + CUDA port: the
counterpart of examples/serve_demo.py.

    python examples/serve_demo_torch.py --cpu --preset tiny --requests 5 --slots 2
    python examples/serve_demo_torch.py --preset sd15 --slots 4 --requests 12

Submits a stream of prompts with mixed step counts to the port's Engine,
one tick between submissions, so requests join and leave the running batch
at step boundaries, and logs key=value lines (submit, done, summary). It
runs on the GPU unless --cpu is given. Weights: --ckpt loads an SD1.x
checkpoint (bf16); without it, seeded random fp32 weights are made on the
device (their images are noise). ``main(argv)`` returns the results.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PROMPTS = [
    "a horse sized cat eating a bagel",
    "an astronaut riding a horse",
    "a watercolor fox in the snow",
    "macro photo of a clockwork bee",
    "isometric tiny city at night",
]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="tinyfusers serving demo (PyTorch port)")
    p.add_argument("--preset", choices=["sd15", "tiny"], default="tiny")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--requests", type=int, default=5)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from tinyfusers_tpu_torch.pipeline import sd
    from tinyfusers_tpu_torch.serve import Engine
    from tinyfusers_tpu_torch.tokenizer import bpe
    from tinyfusers_tpu_torch.utils.logging import get_logger, kv

    log = get_logger("serve_demo")
    dev = torch.device("cpu" if args.cpu else "cuda")
    cfg = sd.SD15 if args.preset == "sd15" else sd.TINY
    if args.ckpt:
        from tinyfusers_tpu_torch.io import checkpoints
        model = checkpoints.load_sd_params(args.ckpt, cfg, device=dev)
    else:
        model = sd.StableDiffusion(cfg, device=dev, dtype=torch.float32, seed=0)

    eng = Engine(model, cfg, num_slots=args.slots)
    tok = bpe.ClipTokenizer.load_default()

    results = []

    def done(batch):
        for r in batch:
            results.append(r)
            log.info(kv(event="done", rid=r.request_id, shape=r.image.shape))

    t0 = time.monotonic()
    for i in range(args.requests):
        text = PROMPTS[i % len(PROMPTS)]
        ids = np.asarray(tok.encode(text, cfg.clip.max_length), np.int32)
        uids = np.asarray(tok.encode("", cfg.clip.max_length), np.int32)
        steps = [4, 6, 8][i % 3] if args.preset == "tiny" else [20, 30, 25][i % 3]
        req = eng.make_request(ids, uids, num_steps=steps, seed=i)
        eng.submit(req)
        log.info(kv(event="submit", rid=req.request_id, steps=steps))
        done(eng.step())  # a tick between submissions: requests join mid-flight

    done(eng.run_until_idle())
    dt = time.monotonic() - t0
    log.info(kv(event="summary", completed=len(results), wall_s=round(dt, 2),
                req_per_s=round(len(results) / dt, 3)))
    if len(results) != args.requests:
        raise RuntimeError(f"{len(results)} of {args.requests} requests completed")
    return results


if __name__ == "__main__":
    main()
