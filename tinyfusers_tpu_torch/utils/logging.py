"""Structured logging (port of tinyfusers_tpu/utils/logging.py).

Plain stdlib logging with a key=value formatter; the process rank is
prefixed when a torch.distributed process group is initialised.
"""
from __future__ import annotations

import logging
import sys
from typing import Any


def get_logger(name: str = "tinyfusers") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s] %(message)s",
            datefmt="%H:%M:%S",
        ))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def kv(**fields: Any) -> str:
    """Format fields as 'k=v' pairs for structured grep-able lines."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        fields = {"proc": dist.get_rank(), **fields}
    return " ".join(f"{k}={v}" for k, v in fields.items())

