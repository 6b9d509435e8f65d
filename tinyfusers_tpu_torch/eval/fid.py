"""FID: the Fréchet distance between two image feature distributions (port
of tinyfusers_tpu/eval/fid.py).

- ``frechet_distance``: ||mu1 - mu2||^2 + tr(S1 + S2 - 2 (S1 S2)^{1/2})
  (Heusel et al. 2017) in float64 numpy through symmetric
  eigendecompositions, no scipy: with A = S1^{1/2} from eigh of S1,
  tr((S1 S2)^{1/2}) = sum(sqrt(eigvals(A S2 A))). The port keeps its own
  copy of the JAX module's numpy, which gives the same float64 result bit
  for bit.
- ``clip_features``: the CLIP scorer's ViT embeddings (models/
  clip_vision.py), projected and not normalized: "CLIP-FID" (Kynkäänniemi
  et al. 2022), which needs no Inception weights. Canonical Inception-V3
  FID needs torchvision's pool3 checkpoint, which is not in the
  repository.

With N samples below the feature width the covariances are rank-deficient
and FID is biased upward, by the same bias for two sets of the same N: the
accuracy harness compares FIDs at a fixed N.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models import clip_vision


def feature_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean (D,), covariance (D, D)) in float64."""
    f = np.asarray(feats, np.float64)
    if f.ndim != 2:
        raise ValueError(f"features must be (N, D), got {f.shape}")
    mu = f.mean(axis=0)
    c = f - mu
    # unbiased (N-1) normalization, as pytorch-fid and np.cov
    sigma = c.T @ c / max(f.shape[0] - 1, 1)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-12) -> float:
    """Fréchet distance between N(mu1, S1) and N(mu2, S2)."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    diff = mu1 - mu2
    # S1^{1/2} by a symmetric eigendecomposition (PSD: clip the tiny
    # negatives of finite-sample noise)
    w1, v1 = np.linalg.eigh(np.asarray(sigma1, np.float64))
    a = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    m = a @ np.asarray(sigma2, np.float64) @ a
    wm = np.linalg.eigvalsh((m + m.T) / 2.0)
    tr_sqrt = float(np.sqrt(np.clip(wm, 0.0, None)).sum())
    fid = (float(diff @ diff) + float(np.trace(sigma1))
           + float(np.trace(sigma2)) - 2.0 * tr_sqrt)
    # the same distribution's round-off can land epsilon below zero
    return max(fid, 0.0) if fid < eps else fid


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    mu1, s1 = feature_stats(feats1)
    mu2, s2 = feature_stats(feats2)
    return frechet_distance(mu1, s1, mu2, s2)


@torch.inference_mode()
def clip_features(scorer, images, batch_size: int = 16) -> np.ndarray:
    """(B, H, W, 3) uint8 or float images -> (B, P) float64 features: the
    unnormalized projected embeddings of the scorer's vision tower (an
    eval.clip_score.CLIPScorer), ``batch_size`` images a call."""
    cfg = scorer.vision_cfg
    images = torch.as_tensor(images)
    out = []
    for i in range(0, images.shape[0], batch_size):
        px = clip_vision.preprocess(images[i:i + batch_size].to(scorer.device), cfg)
        out.append(clip_vision.apply(scorer.vision, px).cpu().numpy().astype(np.float64))
    return np.concatenate(out, axis=0)


def clip_fid(scorer, images1, images2) -> float:
    """CLIP-FID between two image sets."""
    return fid_from_features(clip_features(scorer, images1), clip_features(scorer, images2))
