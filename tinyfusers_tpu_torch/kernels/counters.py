"""The kernel wrappers' call counters taken together: ``.launches``,
``.shapes`` and ``.variants`` of ``flash_packed``, ``flash_bhsd``,
``geglu_matmul``, ``quant_matmul`` and ``quant_matmul_int4``.

The wrappers count their Python calls. A CUDA graph replays the kernels
it captured without calling a wrapper, so its owner takes what the
capture counted back out (``take``) and adds it again at every replay
(``add``): the counters then read what eager calls would have read."""
from __future__ import annotations

import collections
from typing import List, Tuple

from .flash_attention import flash_bhsd, flash_packed
from .geglu_ff import geglu_matmul
from .quant_matmul import quant_matmul, quant_matmul_int4

COUNTED = (flash_packed, flash_bhsd, geglu_matmul, quant_matmul, quant_matmul_int4)

Counts = List[Tuple[int, collections.Counter, collections.Counter]]


def snapshot() -> Counts:
    """Every wrapper's (launches, shapes, variants), copied."""
    return [(w.launches, collections.Counter(w.shapes), collections.Counter(w.variants))
            for w in COUNTED]


def take(since: Counts) -> Counts:
    """What each wrapper counted after ``since`` (a ``snapshot()``); the
    counters are set back to ``since``, in place."""
    grown = []
    for w, (n, shapes, variants) in zip(COUNTED, since):
        grown.append((w.launches - n, w.shapes - shapes, w.variants - variants))
        w.launches = n
        w.shapes.clear()
        w.shapes.update(shapes)
        w.variants.clear()
        w.variants.update(variants)
    return grown


def add(counts: Counts) -> None:
    """Adds ``counts`` (a ``take()``) to the wrappers' counters."""
    for w, (n, shapes, variants) in zip(COUNTED, counts):
        w.launches += n
        w.shapes.update(shapes)
        w.variants.update(variants)
