"""Helpers for the parity tests of tinyfusers_tpu_torch against
tinyfusers_tpu (tests/test_torch_*.py).

``random_tree`` makes a JAX-layout param tree of numpy arrays from a
numpy seed, with the structure and shapes of the JAX package's ``init``
(traced with ``jax.eval_shape``, never run): tracing is quick where
running jax.random's init eagerly on the CPU takes seconds per model.
Both packages then load the same numbers.
"""
import numpy as np
import pytest
import torch

import jax


def random_tree(init_fn, seed: int):
    """init_fn(key) -> JAX param tree; returns the same structure filled
    with seeded numpy values: linear and conv weights normal / sqrt(fan_in),
    norm scales 1 + 0.1 N, biases 0.1 N, embeddings 0.02 N."""
    shapes = jax.eval_shape(init_fn, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, parent = str(path[-1]), str(path[-2])
        x = rng.standard_normal(s.shape).astype(np.float32)
        if "embedding" in parent:
            return x * 0.02
        if "bias" in name:
            return x * 0.1
        if "norm" in parent:
            return 1.0 + 0.1 * x
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) == 4 else s.shape[-2]
        return x / np.sqrt(fan_in)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The suite runs under several xdist workers: keep torch at 2 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
