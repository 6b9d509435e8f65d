"""The port's DiT (models/dit.py) against the JAX package's on the CPU:
the configs, the module tree against ``dit.init``'s (its zero leaves
included), ``apply`` at TINY_DIT plain, class-conditional (the null
class included) and with a pooled ``cond`` vector, in fp32 and bf16, one
bf16 block against ``jax.jit`` of the JAX block, ``load_dit`` of a
stacked tree, and the attention's layout choice.

JAX params come from ``random_tree`` (every leaf non-zero, so the
adaLN-Zero gates let every path reach the output). Tolerances: fp32
rtol / atol 1e-5 (the same arithmetic through two blocks, summed in
another order); bf16 against the JAX ops run one by one (eager, each op
its own XLA computation, rounding to bf16 after each as the port does):
equal bit for bit on an x86 CPU, held at 2^-5 (one bf16 ulp at the
outputs' magnitude of ~4) since the sums' order in the convs and matmuls
is the libraries' choice; one bf16 block against ``jax.jit``:
2^-4, as tests/test_torch_sd3.py holds the MMDiT block (XLA's fusions on
the CPU keep some fp32 sums unrounded).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.models import dit as jdit
from tinyfusers_tpu_torch import ops as tops
from tinyfusers_tpu_torch.io.from_jax import load_dit, load_params
from tinyfusers_tpu_torch.models import dit as tdit
from tinyfusers_tpu_torch.models.layers import ZeroLinear, init_weights

from torch_parity import few_torch_threads, random_tree  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-5)
VARIANTS = {"plain": {}, "classes": dict(num_classes=10), "cond": dict(cond_dim=12),
            "classes+cond": dict(num_classes=10, cond_dim=12)}


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def configs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(jdit.TINY_DIT, **kw), dataclasses.replace(tdit.TINY_DIT, **kw))


def inputs(cfg, seed=1):
    """x, t and the conditioning of the config: label 10 is the null class."""
    x = rand(seed, 2, cfg.input_size, cfg.input_size, cfg.in_channels)
    extra = {}
    if cfg.num_classes:
        extra["labels"] = np.array([3, cfg.num_classes], np.int32)
    if cfg.cond_dim:
        extra["cond"] = rand(seed + 1, 2, cfg.cond_dim)
    return x, np.array([981.0, 5.0], np.float32), extra


def port_model(tcfg, params, dtype=torch.float32):
    model = tdit.DiT(tcfg, device="cpu", dtype=dtype, seed=None)
    load_dit(model, params)
    return model


def run_port(model, x, t, extra, dtype=torch.float32):
    kw = {k: torch.from_numpy(v) for k, v in extra.items()}
    if "cond" in kw:
        kw["cond"] = kw["cond"].to(dtype)
    with torch.no_grad():
        return tdit.apply(model, torch.from_numpy(x).to(dtype), torch.from_numpy(t), **kw)


def test_configs_match_jax():
    for a, b in [(tdit.DIT_XL_2, jdit.DIT_XL_2), (tdit.TINY_DIT, jdit.TINY_DIT)]:
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.num_tokens == b.num_tokens
    assert tdit.DIT_XL_2.num_tokens == 256


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_module_tree_is_the_jax_init_tree(variant):
    """One parameter per JAX leaf (the stacked blocks split), the shapes in
    torch's layout, and the JAX init's zero leaves (adaLN-Zero: every
    block's mod, the final mod and proj) zero in the seeded model."""
    jcfg, tcfg = configs(variant)
    shapes = jax.eval_shape(lambda: jdit.init(jax.random.key(0), jcfg))
    model = tdit.DiT(tcfg, device="cpu", seed=None)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    load_dit(model, random_tree(lambda k: jdit.init(k, jcfg), 0))  # every leaf written once
    model = tdit.DiT(tcfg, device="cpu")  # seed 0: init_weights
    zero = {n for n, m in model.named_modules() if isinstance(m, ZeroLinear)}
    assert zero == {f"blocks.{i}.mod" for i in range(tcfg.depth)} | {"final.mod", "final.proj"}
    params = jdit.init(jax.random.key(0), jcfg)
    assert not np.asarray(params["blocks"]["mod"]["weight"]).any()
    assert not np.asarray(params["final"]["proj"]["weight"]).any()
    for n in zero:
        assert not model.get_submodule(n).weight.any()
    assert hasattr(model, "label_embed") == bool(jcfg.num_classes)
    assert hasattr(model, "cond_proj") == bool(jcfg.cond_dim)
    if jcfg.num_classes:  # + 1: the null class
        assert tuple(model.label_embed.weight.shape) == (jcfg.num_classes + 1, jcfg.dim)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_apply_matches_jax_fp32(variant):
    jcfg, tcfg = configs(variant)
    params = random_tree(lambda k: jdit.init(k, jcfg), 2)
    x, t, extra = inputs(jcfg)
    want = jdit.apply(params, jnp.asarray(x), jnp.asarray(t), jcfg,
                      **{k: jnp.asarray(v) for k, v in extra.items()})
    got = run_port(port_model(tcfg, params), x, t, extra)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("variant", ["plain", "classes+cond"])
def test_apply_bf16_matches_the_jax_ops_one_by_one(variant):
    jcfg, tcfg = configs(variant)
    params = random_tree(lambda k: jdit.init(k, jcfg), 3)
    x, t, extra = inputs(jcfg, seed=4)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    pb = jax.tree.map(bf, params)
    jextra = {k: (bf(v) if k == "cond" else jnp.asarray(v)) for k, v in extra.items()}
    with jax.disable_jit():
        want = np.asarray(jdit.apply(pb, bf(x), jnp.asarray(t), jcfg, **jextra), np.float32)
    got = run_port(port_model(tcfg, params, torch.bfloat16), x, t, extra, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - want)
    print(f"bf16 DiT vs the JAX ops one by one: worst |diff| {d.max():.4g} at |out| max "
          f"{np.abs(want).max():.3g}; {np.mean(d > 0):.3f} of the outputs differ")
    assert d.max() <= 2 ** -5


def test_block_bf16_against_jax_jit():
    kw = dict(input_size=8, patch_size=2, dim=128, depth=1, num_heads=2)
    cfg_j, cfg_t = jdit.DiTConfig(**kw), tdit.DiTConfig(**kw)
    params = random_tree(lambda k: jdit._block_init(k, cfg_j, jnp.float32), 5)
    block = tdit._Block(cfg_t, device="cpu", dtype=torch.bfloat16)
    load_params(block, params)
    x, c = rand(6, 2, 16, 128), rand(7, 2, 128)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    pb = jax.tree.map(bf, params)
    want = np.asarray(jax.jit(lambda p, a, cc: jdit._block(p, a, cc, cfg_j))(pb, bf(x), bf(c)),
                      np.float32)
    with torch.no_grad():
        got = tdit._block(block, torch.from_numpy(x).bfloat16(), torch.from_numpy(c).bfloat16(),
                          cfg_t)
    d = np.abs(got.float().numpy() - want)
    print(f"bf16 DiT block vs jax.jit: worst |diff| {d.max():.4g} at |out| max "
          f"{np.abs(want).max():.3g}; {np.mean(d > 0):.3f} of the outputs differ")
    assert got.dtype == torch.bfloat16 and d.max() <= 2 ** -4


def test_dit_runs_on_the_gpu_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tdit.DiT(tdit.TINY_DIT)


def test_dit_seed_fills_the_weights_as_init_weights_does():
    """seed=s is init_weights(model, s) on the device; seed=None leaves the
    parameters to a loader."""
    seeded = tdit.DiT(tdit.TINY_DIT, device="cpu", seed=7)
    model = tdit.DiT(tdit.TINY_DIT, device="cpu", seed=None)
    init_weights(model, 7)
    for (name, a), (_, b) in zip(seeded.named_parameters(), model.named_parameters()):
        assert torch.equal(a, b), name
    assert not torch.equal(seeded.blocks[0].attn.qkv.weight,
                           tdit.DiT(tdit.TINY_DIT, device="cpu", seed=8).blocks[0].attn.qkv.weight)


def test_load_dit_refuses_a_tree_of_another_config():
    params = random_tree(lambda k: jdit.init(k, jdit.TINY_DIT), 8)
    wider = tdit.DiT(dataclasses.replace(tdit.TINY_DIT, dim=32), device="cpu", seed=None)
    with pytest.raises(ValueError, match="shape"):
        load_dit(wider, params)
    classes = tdit.DiT(dataclasses.replace(tdit.TINY_DIT, num_classes=10), device="cpu",
                       seed=None)
    with pytest.raises(ValueError, match="label_embed"):
        load_dit(classes, params)


def test_conditioning_is_required_where_the_config_has_it():
    jcfg, tcfg = configs("classes+cond")
    model = port_model(tcfg, random_tree(lambda k: jdit.init(k, jcfg), 9))
    x, t, extra = inputs(jcfg)
    with pytest.raises(ValueError, match="labels"):
        run_port(model, x, t, {"cond": extra["cond"]})
    with pytest.raises(ValueError, match="cond"):
        run_port(model, x, t, {"labels": extra["labels"]})


def test_attention_layout_is_packed_on_cuda_from_1024_tokens():
    """DiT-XL/2 at 512x512 (1024 tokens, 16 heads of 72) takes the packed
    flash kernel on CUDA; at 256x256 (256 tokens) and on the CPU the math
    route, as the JAX package's packed_beneficial is false off the TPU."""
    cfg = tdit.DIT_XL_2
    big = dataclasses.replace(cfg, input_size=64)
    assert big.num_tokens == 1024 and cfg.dim // cfg.num_heads == 72
    assert tops.packed_beneficial(big.num_tokens, big.num_tokens, cfg.dim, cfg.num_heads, 2,
                                  device="cuda")
    assert not tops.packed_beneficial(cfg.num_tokens, cfg.num_tokens, cfg.dim, cfg.num_heads, 2,
                                      device="cuda")
    assert not tops.packed_beneficial(big.num_tokens, big.num_tokens, cfg.dim, cfg.num_heads, 2,
                                      device="cpu")
