"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``. Without a GPU that raises: the
port never moves to the CPU on its own. Tests and tools that want the CPU
pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tinyfusers_tpu_torch: device 'cuda' requested but no CUDA GPU "
            "is available; pass device='cpu' to run on the CPU")
    return dev
