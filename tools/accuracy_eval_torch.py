"""Accuracy harness: CLIP score and CLIP-FID of approximated pipelines
against the bf16 baseline (the port's counterpart of
benchmarks/accuracy_eval.py).

    python3 tools/accuracy_eval_torch.py [--preset tiny|sd15-quarter|sd15]
        [--cpu] [--steps 20] [--prompts 16]
        [--variants int8,fp8,int4,cached_cfg,deepcache]
        [--ckpt SD.safetensors] [--scorer-ckpt CLIP.safetensors]
        [--fid-tower clip] [--json out.json]

A fixed prompt set (the JAX harness's 16) is generated, one image a prompt
(512² at sd15, 20-step DDIM, CFG 7.5, bf16, latent seeds 100 + i), with the
exact pipeline (the row the JAX harness names ``fp16``; here bf16) and
with each approximation: the UNet quantized by io/quantize_tree.py to int8,
fp8 (e4m3) or int4, cached CFG (uncond every 3rd step) or DeepCache
(interval 3). Every image is scored against its prompt by the CLIP scorer
(eval/clip_score.py: ViT-L/14 and its text tower; TINY_VISION at
``--preset tiny``), and each variant's image set gets its CLIP-FID against
the baseline's (eval/fid.py) and its mean image PSNR. The report has the
JAX harness's keys and rows: ``clip_score_mean``, ``clip_score_std``,
``gen_s``, ``delta_clip_score``, ``fid_vs_fp16``, ``psnr_vs_fp16_db``,
``fid_tower``.

Without ``--ckpt`` the pipeline's weights are the port's seeded init
(``StableDiffusion(seed=0)``: the JAX init's distributions drawn by a
torch.Generator; the JAX harness's sd15 fill lives in bench.py, which
imports jax), and without ``--scorer-ckpt`` the scorer's are seeded too
(text tower seed 10, vision seed 11). Scores on seeded weights prove the
path and mean nothing else; real weights are the two flags. Without real
weights the ids are the JAX harness's proof-mode ids (``proof_ids``: from
each prompt's sha256 digest, in the towers' vocabularies).

``--fid-tower inception`` is refused: without ``--inception-ckpt`` as the
JAX harness refuses it, and with one too, because the Inception-V3 tower
is not ported (the JAX harness then reports CLIP-FID under that name).

On the GPU (the default; ``--cpu`` for the CPU) the scorer's fp32 numbers
are exact fp32: TF32 is switched off for matmuls and cuDNN convolutions.
``main(argv)`` returns the report and each variant's uint8 images.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tinyfusers_tpu_torch.eval import clip_score as cs  # noqa: E402
from tinyfusers_tpu_torch.eval import fid as fid_mod  # noqa: E402
from tinyfusers_tpu_torch.io.quantize_tree import QDTYPES, quantized_copy  # noqa: E402
from tinyfusers_tpu_torch.models import clip as clip_model  # noqa: E402
from tinyfusers_tpu_torch.models import clip_vision  # noqa: E402
from tinyfusers_tpu_torch.pipeline import sd  # noqa: E402
from tinyfusers_tpu_torch.tokenizer import bpe  # noqa: E402

PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "a red sports car parked on a mountain road at sunset",
    "an oil painting of a lighthouse in a storm",
    "a bowl of ramen with chopsticks, studio lighting",
    "a golden retriever puppy playing in autumn leaves",
    "a futuristic city skyline at night, neon lights",
    "a watercolor sketch of a sailboat on a calm lake",
    "an ancient stone bridge over a forest river",
    "a chef plating a dessert in a professional kitchen",
    "a snow-covered cabin with warm light in the windows",
    "macro photo of a honeybee on a sunflower",
    "a medieval castle on a cliff above the sea",
    "a cup of coffee and an open book on a wooden table",
    "a surfer riding a large wave at dawn",
    "a hot air balloon festival over desert canyons",
    "a robot tending a rooftop vegetable garden",
]
PRESETS = {"tiny": sd.TINY, "sd15-quarter": sd.SD15_QUARTER, "sd15": sd.SD15}
# variant -> sd.generate's options; "quant" names the UNet's format
VARIANTS = {"int8": {"quant": "int8"}, "fp8": {"quant": "fp8"}, "int4": {"quant": "int4"},
            "cached_cfg": {"uncond_interval": 3}, "deepcache": {"deepcache_interval": 3}}
GUIDANCE = 7.5
DTYPE = torch.bfloat16


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * math.log10(peak * peak / mse)


def proof_ids(prompts: Sequence[str], vocab: int, length: int) -> np.ndarray:
    """Proof-mode ids (N, length) int32 in a tower's small vocabulary: SOT
    (vocab - 2), up to 8 ids drawn from [1, vocab - 2) by a generator seeded
    with the first 4 bytes of the prompt's sha256 digest (little-endian;
    stable across processes, unlike hash()), then EOT (vocab - 1) padding."""
    rows = []
    for t in prompts:
        seed = int.from_bytes(hashlib.sha256(t.encode()).digest()[:4], "little")
        rng = np.random.default_rng(seed)
        n = min(length - 2, 8)
        row = np.full((length,), vocab - 1, np.int32)
        row[0] = vocab - 2
        row[1:1 + n] = rng.integers(1, vocab - 2, size=n)
        rows.append(row)
    return np.stack(rows)


def ids_for(tok: bpe.ClipTokenizer, prompts: Sequence[str], vocab: int,
            length: int) -> np.ndarray:
    """The prompts' CLIP ids padded with EOT where the tower's vocabulary
    holds CLIP's, else their proof-mode ids."""
    if vocab >= bpe.EOT + 1:
        return np.array([tok.encode(t, length, pad_token=bpe.EOT) for t in prompts], np.int32)
    return proof_ids(prompts, vocab, length)


def empty_ids(tok: bpe.ClipTokenizer, n: int, vocab: int, length: int) -> np.ndarray:
    """The empty prompt's ids (N, length): SOT then EOT padding."""
    if vocab >= bpe.EOT + 1:
        return np.array([tok.encode("", length, pad_token=bpe.EOT)] * n, np.int32)
    return np.array([[vocab - 2] + [vocab - 1] * (length - 1)] * n, np.int32)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", choices=list(PRESETS), default="sd15")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--prompts", type=int, default=len(PROMPTS))
    p.add_argument("--variants", default="int8,fp8,int4,cached_cfg,deepcache")
    p.add_argument("--ckpt", default=None, help="SD1.x checkpoint; seeded weights otherwise")
    p.add_argument("--scorer-ckpt", default=None,
                   help="HF CLIPModel checkpoint for the scorer "
                        "(openai/clip-vit-large-patch14); seeded weights otherwise")
    p.add_argument("--fid-tower", choices=["clip", "inception"], default="clip",
                   help="feature tower for FID: 'clip' (CLIP-FID through the scorer's ViT)")
    p.add_argument("--inception-ckpt", default=None,
                   help="torchvision InceptionV3 (pt_inception-2015) checkpoint")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    if args.fid_tower == "inception":
        if not args.inception_ckpt:
            p.error("--fid-tower inception needs --inception-ckpt (canonical InceptionV3 "
                    "weights are an external asset; the CLIP tower is the default)")
        p.error("--fid-tower inception: the Inception-V3 tower is not ported; use the CLIP "
                "tower (the JAX harness would report CLIP-FID under the name inception)")
    unknown = [v for v in args.variants.split(",") if v and v not in VARIANTS]
    if unknown:
        p.error(f"--variants: unknown {unknown}; choose from {list(VARIANTS)}")
    return args


@dataclass
class Job:
    args: argparse.Namespace
    cfg: sd.SDConfig
    model: sd.StableDiffusion
    scorer: cs.CLIPScorer
    prompts: List[str]
    ids: torch.Tensor        # (N, T) the pipeline's prompt ids, on the device
    uids: torch.Tensor       # (N, T) the empty prompt's
    sids: np.ndarray         # (N, T') the scorer's text ids


def build(args: argparse.Namespace) -> Job:
    """The pipeline, the scorer and the ids, on the GPU unless args.cpu."""
    device = "cpu" if args.cpu else "cuda"
    if not args.cpu:  # the scorer's fp32 convs and matmuls in exact fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = PRESETS[args.preset]
    if args.ckpt:
        from tinyfusers_tpu_torch.io import checkpoints

        model = checkpoints.load_sd_params(args.ckpt, cfg, device=device, dtype=DTYPE)
    else:
        print("no --ckpt: seeded pipeline weights (pipeline proof)")
        model = sd.StableDiffusion(cfg, device=device, dtype=DTYPE, seed=0)
    if args.scorer_ckpt:
        scorer = cs.load_scorer_params(args.scorer_ckpt, device=device)
    else:
        print("no --scorer-ckpt: seeded scorer weights (pipeline proof)")
        vcfg = clip_vision.TINY_VISION if args.preset == "tiny" else clip_vision.VIT_L_14
        tcfg = (clip_model.CLIPConfig(vocab_size=128, max_length=16, dim=64, num_layers=2,
                                      num_heads=4, mlp_dim=128,
                                      projection_dim=vcfg.projection_dim)
                if args.preset == "tiny" else clip_model.CLIPConfig(projection_dim=768))
        scorer = cs.CLIPScorer(tcfg, vcfg, device=device, seed=10)
    prompts = PROMPTS[: args.prompts]
    real_assets = args.ckpt is not None or args.scorer_ckpt is not None
    tok = bpe.ClipTokenizer.load_default(allow_fallback=not real_assets)
    dev = next(model.parameters()).device
    vocab, length = cfg.clip.vocab_size, cfg.clip.max_length
    ids = torch.from_numpy(ids_for(tok, prompts, vocab, length)).long().to(dev)
    uids = torch.from_numpy(empty_ids(tok, len(prompts), vocab, length)).long().to(dev)
    sids = ids_for(tok, prompts, scorer.text_cfg.vocab_size, scorer.text_cfg.max_length)
    return Job(args, cfg, model, scorer, prompts, ids, uids, sids)


def generate(job: Job, model: sd.StableDiffusion, **kw) -> np.ndarray:
    """One image a prompt, batch 1, latent seed 100 + i -> (N, H, W, 3) uint8."""
    imgs = []
    for i in range(len(job.prompts)):
        lat = sd.initial_latent(100 + i, 1, job.cfg, device=job.ids.device, dtype=DTYPE)
        img = sd.generate(model, job.ids[i:i + 1], job.uids[i:i + 1], lat, GUIDANCE,
                          num_steps=job.args.steps, **kw)
        imgs.append(img[0].cpu().numpy())
    return np.stack(imgs)


def run(job: Job, around: Optional[Callable[[str], contextlib.AbstractContextManager]] = None
        ) -> Tuple[Dict[str, object], Dict[str, np.ndarray]]:
    """Every variant's images, scores and FID -> (report, uint8 images by
    variant). ``around(name)``, when given, is a context manager entered
    around each variant's image generation alone."""
    args = job.args
    variants = {"fp16": {}}
    variants.update((v, VARIANTS[v]) for v in args.variants.split(",") if v)
    rows, images = [], {}
    base_imgs = base_feats = base_score = None
    for name, spec in variants.items():
        kw = dict(spec)
        model = quantized_copy(job.model, QDTYPES[kw.pop("quant")]) if "quant" in kw else job.model
        with around(name) if around else contextlib.nullcontext():
            t0 = time.monotonic()
            imgs = generate(job, model, **kw)
            gen_s = time.monotonic() - t0
        del model
        scores = cs.clip_score(job.scorer, imgs, job.sids)
        feats = fid_mod.clip_features(job.scorer, imgs)
        row = {"variant": name,
               "clip_score_mean": round(float(np.mean(scores)), 4),
               "clip_score_std": round(float(np.std(scores)), 4),
               "gen_s": round(gen_s, 1)}
        if name == "fp16":
            base_imgs, base_feats, base_score = imgs, feats, row["clip_score_mean"]
        else:
            row["delta_clip_score"] = round(row["clip_score_mean"] - base_score, 4)
            # CLIP-FID against the baseline's set: at a few prompts the
            # absolute value is biased, the same-N comparison is the readout
            row["fid_vs_fp16"] = round(fid_mod.fid_from_features(feats, base_feats), 4)
            row["psnr_vs_fp16_db"] = round(
                float(np.mean([psnr(a, b) for a, b in zip(imgs, base_imgs)])), 2)
        rows.append(row)
        images[name] = imgs
        print(json.dumps(row), flush=True)
    cfg = job.cfg
    report = {
        "config": f"{args.preset} {cfg.height}x{cfg.width} {args.steps}-step CFG7.5, "
                  f"{len(job.prompts)} prompts",
        "weights": "real" if args.ckpt else "seeded-random (pipeline proof)",
        "scorer": "clip-vit-l14" if args.scorer_ckpt else "random (pipeline proof)",
        "rows": rows,
        "fid_tower": args.fid_tower,
    }
    return report, images


def print_report(report: Dict[str, object]) -> None:
    print("\n== accuracy report ==")
    print(f"{'variant':12s} {'CLIP':>8s} {'dCLIP':>8s} {'FID':>8s} {'PSNR(dB)':>9s}")
    for r in report["rows"]:
        print(f"{r['variant']:12s} {r['clip_score_mean']:8.3f} "
              f"{r.get('delta_clip_score', 0.0):8.3f} "
              f"{r.get('fid_vs_fp16', float('nan')):8.3f} "
              f"{r.get('psnr_vs_fp16_db', float('nan')):9.2f}")


def main(argv: Optional[Sequence[str]] = None):
    """Runs the harness and prints its report; returns (report, images)."""
    args = parse_args(argv)
    report, images = run(build(args))
    print_report(report)
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=2))
        print(f"wrote {args.json}")
    return report, images


if __name__ == "__main__":
    main()
