"""Inputs drawn from a run's seed, shared by the drivers."""
from __future__ import annotations

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of draws of a run (1: the traffic, 2:
    the warm-up, 3: the sample checked against the reference)."""
    return np.random.default_rng([abs(int(seed)), stream])


def prompt(rng, n_tokens: int, length: int, vocab: int) -> np.ndarray:
    """Start of text (vocab - 2), n_tokens random ids below it, then end
    of text (vocab - 1) to ``length``."""
    ids = np.full((length,), vocab - 1, np.int64)
    ids[0] = vocab - 2
    if n_tokens:
        ids[1:1 + n_tokens] = rng.integers(0, vocab - 2, size=n_tokens)
    return ids
