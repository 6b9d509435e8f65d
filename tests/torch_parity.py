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


def tiny_sd(jsd, tsd, jcfg, tcfg, seed: int = 0):
    """(JAX params, the port's StableDiffusion loaded from them, prompt ids,
    negative ids, initial latent) at a TINY config, on the CPU."""
    from tinyfusers_tpu_torch.io.from_jax import load_sd

    params = random_tree(lambda k: jsd.init(k, jcfg), seed)
    model = tsd.StableDiffusion(tcfg, device="cpu", seed=None)
    load_sd(model, params)
    rng = np.random.default_rng(seed + 1)
    n = tcfg.clip.max_length
    ids = rng.integers(0, tcfg.clip.vocab_size - 1, (1, n)).astype(np.int32)
    uids = np.full((1, n), tcfg.clip.vocab_size - 1, np.int32)
    uids[0, 0] = 0
    lat = rng.standard_normal((1, *tcfg.latent_shape)).astype(np.float32)
    return params, model, ids, uids, lat


def jax_noises(key, start: int, steps: int, shape):
    """The normals a JAX ancestral sampler draws: one split of the key per
    step, from rung ``start``."""
    import jax.numpy as jnp

    out = []
    for _ in range(start, steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, shape, jnp.float32)))
    return out


def replay_noise(monkeypatch, noises):
    """Make the port's ancestral draws (pipeline/samplers.py::_normal)
    return ``noises`` in order; returns the list of those not drawn yet."""
    from tinyfusers_tpu_torch.pipeline import samplers

    queue = list(noises)

    def draw(generator, like):
        return torch.from_numpy(queue.pop(0)).to(like.device)

    monkeypatch.setattr(samplers, "_normal", draw)
    return queue


def every_finite_bf16() -> torch.Tensor:
    """All 65,280 finite bf16 values (both zeros included)."""
    x = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return x[torch.isfinite(x)]


def bf16_against_jax_jit(got: torch.Tensor, jax_fn, x: torch.Tensor):
    """(values where ``got`` differs from ``jax.jit(jax_fn)`` at x, the
    number of values not compared). XLA on the CPU flushes subnormal
    inputs and results to zero, so where the input is subnormal, or either
    side's result is subnormal or zero against a normal other, the value
    is counted, not compared."""
    import jax.numpy as jnp

    want = torch.from_numpy(np.asarray(
        jax.jit(jax_fn)(jnp.asarray(x.float().numpy(), jnp.bfloat16)), np.float32))
    tiny = torch.finfo(torch.bfloat16).tiny
    a, g, w = x.float().abs(), got.float(), want.to(torch.bfloat16).float()
    compared = (a == 0) | (a >= tiny)
    compared &= (g == w) | ((g.abs() >= tiny) & (w.abs() >= tiny))
    return x[(g != w) & compared], int((~compared).sum())
