"""Plain building blocks of the reference models.

Everything is computed in float32 with TF32 off (the caller switches it
off, see ``fp32_matmuls``), on weights given as a dict of tensors keyed
by parameter name in torch layouts: linear (out, in), conv (out, in, kh,
kw). Activations are NCHW for the convolutional models and (B, T, D) for
the transformers.

``Prec`` says where the reference rounds. ``"fp32"`` rounds nowhere
beyond float32. ``"fp8"`` is the control: every linear and convolution
takes its input rounded to float8 e4m3 with one scale per tensor and its
weight rounded to e4m3 with one scale per output channel, as fp8
inference with dynamic per-tensor activation scales computes them; the
products, attention, norms and everything else stay float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _e4m3(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    scale = (amax / E4M3_MAX).clamp_min(1e-12)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Prec:
    """The reference's arithmetic: "fp32" or "fp8" (the control)."""

    MODES = ("fp32", "fp8")

    def __init__(self, mode: str = "fp32"):
        if mode not in self.MODES:
            raise ValueError(f"unknown reference precision {mode!r}")
        self.mode = mode
        self._weights: Dict[str, torch.Tensor] = {}

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32":
            return x
        return _e4m3(x, x.abs().amax())

    def weight(self, W: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
        """W[name] as float32, rounded per output channel in fp8 mode;
        prepared once per name."""
        w = self._weights.get(name)
        if w is None:
            w = W[name].float()
            if self.mode == "fp8":
                w = _e4m3(w, w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True))
            self._weights[name] = w
        return w


@contextlib.contextmanager
def fp32_matmuls():
    """TF32 off for the block: on the H100 a float32 matmul or convolution
    may otherwise run in TF32, a lower precision."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def bias(W, name: str) -> Optional[torch.Tensor]:
    b = W.get(name + ".bias")
    return None if b is None else b.float()


def linear(P: Prec, W, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(P.act(x), P.weight(W, name + ".weight"), bias(W, name))


def conv(P: Prec, W, name: str, x: torch.Tensor, stride: int = 1, padding=0) -> torch.Tensor:
    """x (N, C, H, W); padding an int or (left, right, top, bottom)."""
    if not isinstance(padding, int):
        x = F.pad(x, padding)
        padding = 0
    return F.conv2d(P.act(x), P.weight(W, name + ".weight"), bias(W, name),
                    stride=stride, padding=padding)


def group_norm(W, name: str, x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    return F.group_norm(x, groups, W[name + ".weight"].float(), W[name + ".bias"].float(),
                        eps)


def layer_norm(W, name: Optional[str], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Over the last axis; name None: no affine."""
    if name is None:
        return F.layer_norm(x, x.shape[-1:], eps=eps)
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"].float(),
                        W[name + ".bias"].float(), eps)


def attention(q, k, v, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + mask) v over (B, H, S, d)."""
    logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        logits = logits + mask
    return torch.matmul(torch.softmax(logits, dim=-1), v)


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T, H*d) -> (B, H, T, d)."""
    b, t, c = x.shape
    return x.reshape(b, t, n, c // n).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def silu(x):
    return x * torch.sigmoid(x)


def gelu_erf(x):
    return F.gelu(x)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding of float timesteps (B,), cos half then sin half."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def to_levels(x: torch.Tensor) -> torch.Tensor:
    """Image in [-1, 1], (..., 3) -> levels 0..255 as float32, truncated as
    a cast to uint8 truncates."""
    return torch.floor(torch.clamp((x + 1.0) / 2.0, 0.0, 1.0) * 255.0)
