"""Full-geometry checkpoint drill (the port's counterpart of
benchmarks/ckpt_drill.py).

    python3 tools/ckpt_drill_torch.py [--steps 4] [--preset sd15|sd15-quarter]
        [--dir DIR] [--keep] [--cpu]

Writes a synthetic SD1.5-layout checkpoint at the preset's full geometry
(sd15: 1.066 B parameters, about 2.1 GB in fp16, the size of the
fp16-pruned SD1.5 files) in both containers, .safetensors and a torch-zip
.ckpt; reads each back through the port's loader
(``io.checkpoints.load_sd_params``, bf16) and checks every parameter
against the written state bit for bit, after the same fp16 -> bf16
rounding; then runs the port's CLI (``examples/txt2img_torch.py --ckpt``)
on each file in a child under a ``RUSAGE_CHILDREN`` wrapper and reports
its wall seconds, the CLI's load seconds and the child's peak host RSS;
the last line, ``drill: {...}``, gives these numbers as JSON.
The files (in a new directory under the temporary directory unless
``--dir``) are deleted unless ``--keep``.

The state is the JAX tool's: the preset's model in fp16, each JAX leaf
(a stacked one over its whole stack) filled with a seeded pool of 2^20
normals times 0.02 tiled over it, in the JAX layout, mapped by the port's
``io.state_map.sd_state_from_params``. Runs on the GPU unless ``--cpu``
is given (the loader's check and the CLI alike).
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tinyfusers_tpu_torch.io import checkpoints, safetensors_io, state_map  # noqa: E402
from tinyfusers_tpu_torch.pipeline import sd  # noqa: E402
from tinyfusers_tpu_torch.train import Leaf, param_layouts  # noqa: E402

PRESETS = {"sd15": sd.SD15, "sd15-quarter": sd.SD15_QUARTER}
POOL = 1 << 20


def filled_model(cfg: sd.SDConfig) -> sd.StableDiffusion:
    """The model of ``cfg`` in fp16 on the CPU, every JAX leaf the pool
    tiled over it from its first element (a block of a stacked leaf the
    slice its place in the stack takes)."""
    rng = np.random.default_rng(0)
    pool = torch.from_numpy((rng.standard_normal(POOL) * 0.02).astype(np.float16))
    model = sd.StableDiffusion(cfg, device="cpu", dtype=torch.float16, seed=None)
    layouts = param_layouts(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            lay = layouts.get(name, Leaf())
            start = (lay.stack[1] * p.numel() if lay.stack else 0) % POOL
            reps = -(-(start + p.numel()) // POOL)
            values = pool.repeat(reps)[start:start + p.numel()]
            p.copy_(lay.from_jax(values.reshape(lay.to_jax(p).shape)))
    return model


def build_state(cfg: sd.SDConfig) -> Tuple[sd.StableDiffusion, Dict[str, torch.Tensor]]:
    """(the filled fp16 model, its checkpoint-layout state dict)."""
    model = filled_model(cfg)
    return model, state_map.sd_state_from_params(model)


def write_ckpts(state: Dict[str, torch.Tensor], out_dir: Path) -> Tuple[Path, Path]:
    out_dir.mkdir(parents=True, exist_ok=True)
    total = sum(v.numel() * v.element_size() for v in state.values())
    print(f"state: {len(state)} tensors, {total / 1e9:.2f} GB fp16")
    t0 = time.monotonic()
    st_path = out_dir / "sd15_synth.safetensors"
    safetensors_io.save_state_dict(state, st_path)
    print(f"wrote {st_path.name}: {st_path.stat().st_size / 1e9:.2f} GB "
          f"in {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    pt_path = out_dir / "sd15_synth.ckpt"
    torch.save({"state_dict": {k: v.contiguous() for k, v in state.items()}}, pt_path)
    print(f"wrote {pt_path.name}: {pt_path.stat().st_size / 1e9:.2f} GB "
          f"in {time.monotonic() - t0:.1f}s")
    return st_path, pt_path


def check_loaded(path: Path, model: sd.StableDiffusion, cfg: sd.SDConfig,
                 device) -> Dict[str, object]:
    """``path`` through load_sd_params in bf16 on ``device``: its seconds
    and the parameters that differ from ``model``'s (the written fp16
    values) rounded to bf16."""
    t0 = time.monotonic()
    loaded = checkpoints.load_sd_params(path, cfg, device=device, dtype=torch.bfloat16)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    want = dict(model.named_parameters())
    got = dict(loaded.named_parameters())
    differ = [k for k, v in got.items()
              if not torch.equal(v, want[k].to(v.device).to(torch.bfloat16))]
    out = {"load_s": load_s, "tensors": len(got), "differ": differ,
           "equal": got.keys() == want.keys() and not differ}
    print(f"[{path.suffix}] load_sd_params {load_s:.1f}s: {len(got)} parameters, "
          f"{len(differ)} differ from the written state after fp16 -> bf16", flush=True)
    return out


_RUNNER = r"""
import resource, subprocess, sys
r = subprocess.run(sys.argv[1:])
peak_kb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
print(f"CHILD_PEAK_RSS_KB={peak_kb}", flush=True)
sys.exit(r.returncode)
"""


def drive_cli(ckpt: Path, steps: int, preset: str, cpu: bool, out_dir: Path
              ) -> Dict[str, object]:
    """The port's CLI on ``ckpt`` in a child under a peak-RSS-recording
    wrapper: ok, wall seconds, the CLI's load seconds, peak RSS in GB."""
    cmd = [sys.executable, "-c", _RUNNER, sys.executable, "examples/txt2img_torch.py",
           "--preset", preset, "--ckpt", str(ckpt), "--steps", str(steps), "--timing",
           "--fallback-tokenizer",  # synthetic weights: CLIP ids irrelevant
           "--out", str(out_dir / f"drill_{ckpt.suffix.lstrip('.')}.png")]
    if cpu:
        cmd.append("--cpu")
    t0 = time.monotonic()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    wall = time.monotonic() - t0
    out = r.stdout + r.stderr
    load = re.search(r"weights ready in ([0-9.]+)s", out)
    rss = re.search(r"CHILD_PEAK_RSS_KB=(\d+)", out)
    res = {"ok": r.returncode == 0 and "saved" in out, "wall_s": wall,
           "load_s": float(load.group(1)) if load else None,
           "peak_rss_gb": int(rss.group(1)) / 1e6 if rss else None}
    msg = (f"[{ckpt.suffix}] ok={res['ok']} wall={wall:.1f}s "
           f"load={load.group(1) if load else '?'}s")
    if rss:
        msg += f" peak_rss={res['peak_rss_gb']:.2f}GB"
    print(msg, flush=True)
    if not res["ok"]:
        print(out[-3000:])
    return res


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dir", default=None, help="where the files go (default: a new "
                   "directory under the temporary directory)")
    p.add_argument("--keep", action="store_true")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--preset", choices=list(PRESETS), default="sd15")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, object]]:
    """The drill; returns {container suffix: its load check and CLI run}
    and exits non-zero from the command line when one fails."""
    args = parse_args(argv)
    cfg = PRESETS[args.preset]
    device = "cpu" if args.cpu else "cuda"
    out_dir = Path(args.dir) if args.dir else Path(tempfile.mkdtemp(prefix="ckpt_drill_"))
    t0 = time.monotonic()
    model, state = build_state(cfg)
    print(f"built the {args.preset} state in {time.monotonic() - t0:.1f}s: "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} G parameters")
    paths = write_ckpts(state, out_dir)
    del state
    results = {}
    try:
        for path in paths:
            res = check_loaded(path, model, cfg, device)
            res.update(cli=drive_cli(path, args.steps, args.preset, args.cpu, out_dir))
            results[path.suffix] = res
        print("drill: " + json.dumps({k: {"params_equal": r["equal"], "load_s": r["load_s"],
                                           "cli": r["cli"]} for k, r in results.items()}))
    finally:
        if not args.keep:
            for path in paths:
                path.unlink(missing_ok=True)
            for image in out_dir.glob("drill_*"):
                image.unlink()
            if not args.dir:
                shutil.rmtree(out_dir, ignore_errors=True)
    return results


if __name__ == "__main__":
    sys.exit(0 if all(r["equal"] and r["cli"]["ok"] for r in main().values()) else 1)
