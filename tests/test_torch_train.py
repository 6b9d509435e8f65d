"""The port's training (tinyfusers_tpu_torch/train/) against the JAX
package's (tinyfusers_tpu/train/ and optax) on the CPU, with inputs made
from numpy seeds.

- Losses: q_sample, loss_weights and diffusion_loss of every objective on
  the same x0, noise and t, within 1e-6 (fp32; the ladder is the JAX
  package's bit for bit, sums are taken in another order).
- Optimizers: three steps of each optimizer the JAX package's training
  uses against optax, run op by op, on the same tree and gradients: fp32
  within 1e-6, bf16 equal or within one bf16 ulp.
- The train step: three steps on the JAX tests' tiny UNet in fp32 against
  the jitted JAX ``make_train_step`` with its t and noise replayed
  (params, loss, grad_norm, EMA) within the tolerances stated there; remat
  equal to no remat bit for bit.
- LoRA, checkpoints in both directions, data feeding.

One JAX reference per model (a module-scoped fixture): each JAX train-step
compile costs seconds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tinyfusers_tpu import train as jtrain
from tinyfusers_tpu.models import unet as junet
from tinyfusers_tpu.train.checkpoint import _flatten as jflatten
from tinyfusers_tpu_torch import train as ttrain
from tinyfusers_tpu_torch.io.from_jax import load_params
from tinyfusers_tpu_torch.models import unet as tunet
from tinyfusers_tpu_torch.models.layers import Conv, Linear, set_trainable
from tinyfusers_tpu_torch.train import losses as tlosses
from tinyfusers_tpu_torch.train import optim as toptim
from tinyfusers_tpu_torch.train.step import jax_order

from torch_parity import few_torch_threads, random_tree, replay_noise  # noqa: F401

F32 = dict(rtol=1e-6, atol=1e-6)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# -- losses -------------------------------------------------------------------

OBJECTIVES = [dict(objective="eps"), dict(objective="v"), dict(objective="rf"),
              dict(objective="eps", snr_gamma=5.0), dict(objective="v", snr_gamma=5.0)]


@pytest.mark.parametrize("kw", OBJECTIVES)
def test_objectives_match_jax(kw):
    jcfg, tcfg = jtrain.LossConfig(**kw), ttrain.LossConfig(**kw)
    x0, noise = rand(0, 3, 4, 4, 2), rand(1, 3, 4, 4, 2)
    pred = rand(2, 3, 4, 4, 2)
    t = (np.array([0.1, 0.5, 0.93], np.float32) if kw["objective"] == "rf"
         else np.array([0, 421, 999], np.int32))
    jx, jtarget = jtrain.q_sample(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t), jcfg)
    tx, ttarget = ttrain.q_sample(torch.tensor(x0), torch.tensor(noise), torch.tensor(t), tcfg)
    np.testing.assert_allclose(np_of(tx), np_of(jx), **F32)
    np.testing.assert_allclose(np_of(ttarget), np_of(jtarget), **F32)
    jw = jtrain.loss_weights(jnp.asarray(t), jcfg)
    tw = ttrain.loss_weights(torch.tensor(t), tcfg)
    np.testing.assert_allclose(np_of(tw), np_of(jw), rtol=1e-6)
    jl = jtrain.diffusion_loss(jnp.asarray(pred), jtarget, jw)
    tl = ttrain.diffusion_loss(torch.tensor(pred), ttarget, tw)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


@pytest.mark.parametrize("kw,dtype", [(dict(objective="eps"), torch.int32),
                                      (dict(objective="rf"), torch.float32),
                                      (dict(objective="rf", rf_t_mean=None), torch.float32)])
def test_sample_timesteps_dtype_and_range(kw, dtype):
    cfg = ttrain.LossConfig(**kw)
    t = ttrain.sample_timesteps(torch.Generator().manual_seed(0), 512, cfg)
    assert t.dtype == dtype and t.shape == (512,)
    if dtype == torch.int32:
        assert 0 <= int(t.min()) and int(t.max()) < cfg.n_train_timesteps
    else:
        assert 0.0 < float(t.min()) and float(t.max()) < 1.0


# -- optimizers against optax -----------------------------------------------------

# One tree in both layouts: a linear (in 160, out 192), a 3x3 conv 128 -> 160,
# a bias and a norm gain; the linear and conv are wide enough for Adafactor to
# factor them, the conv in its HWIO layout.
_TREE = {"conv.weight": (3, 3, 128, 160), "lin.bias": (192,), "lin.weight": (160, 192),
         "norm.weight": (64,)}
_LAYOUTS = {"lin.weight": Linear, "conv.weight": Conv}


def _jax_tree(flat):
    out = {}
    for name, v in flat.items():
        mod, leaf = name.split(".")
        out.setdefault(mod, {})[leaf] = v
    return out


def _trees(seed, dtype, scale=1.0):
    """(JAX tree, port tree) of the same numbers."""
    rng = np.random.default_rng(seed)
    flat = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in _TREE.items()}
    jtree = _jax_tree({k: jnp.asarray(v).astype(dtype[0]) for k, v in flat.items()})
    ttree = {}
    for k in jax_order(flat):
        t = torch.from_numpy(flat[k]).to(dtype[1])
        ttree[k] = _LAYOUTS[k].from_jax(t).contiguous() if k in _LAYOUTS else t
    return jtree, ttree


def _port_in_jax_layout(ttree):
    return {k: (_LAYOUTS[k].to_jax(v) if k in _LAYOUTS else v) for k, v in ttree.items()}


def _assert_within_ulp(got: torch.Tensor, want, what: str):
    """Equal, or within one bf16 ulp of want."""
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
    bad = np.abs(g - w) > ulp
    assert not bad.any(), f"{what}: {bad.sum()} values beyond one bf16 ulp"


OPTIMIZERS = {
    "default": (lambda: jtrain.default_optimizer(1e-3), lambda: ttrain.default_optimizer(1e-3)),
    "default_warmup": (lambda: jtrain.default_optimizer(1e-3, warmup_steps=2),
                       lambda: ttrain.default_optimizer(1e-3, warmup_steps=2)),
    "adamw_f32_mu": (lambda: optax.chain(optax.clip_by_global_norm(1.0),
                                         optax.adamw(1e-3, mu_dtype=jnp.float32)),
                     lambda: toptim.chain(toptim.clip_by_global_norm(1.0),
                                          toptim.adamw(1e-3, mu_dtype=torch.float32))),
    "sgdm": (lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(1e-2, momentum=0.9)),
             lambda: toptim.chain(toptim.clip_by_global_norm(1.0),
                                  toptim.sgd(1e-2, momentum=0.9))),
    "adafactor": (lambda: optax.adafactor(1e-2),
                  lambda: toptim.adafactor(1e-2, layouts=_LAYOUTS)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_three_steps_match_optax(name, dtype):
    """Three steps, gradients below and above the clip threshold; the
    checkpoint flattening of both states gives the same keys and values."""
    dt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jopt, topt = OPTIMIZERS[name][0](), OPTIMIZERS[name][1]()
    jp, tp = _trees(0, dt)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for i, scale in enumerate((1e-3, 1.0, 0.05)):
        jg, tg = _trees(10 + i, dt, scale)
        ju, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = topt.update(tg, tstate, tp)
        tp = toptim.apply_updates(tp, tu)
        got = _port_in_jax_layout(tp)
        for mod, leaves in jp.items():
            for leaf, want in leaves.items():
                g = got[f"{mod}.{leaf}"]
                assert g.dtype == tp[f"{mod}.{leaf}"].dtype
                if dtype == "float32":
                    np.testing.assert_allclose(np_of(g), np_of(want), **F32)
                else:
                    _assert_within_ulp(g, want, f"step {i + 1} {mod}.{leaf}")
    jflat = jflatten(jstate, "opt")
    tflat = {}
    from tinyfusers_tpu_torch.train.checkpoint import _flatten
    _flatten(tstate, "opt", {k: tuple(v.shape) for k, v in tp.items()}, _LAYOUTS, tflat)
    assert set(tflat) == set(jflat)
    for k, want in jflat.items():
        assert tuple(tflat[k].shape) == want.shape, k
        if dtype == "float32" or want.dtype.kind == "i":
            np.testing.assert_allclose(np_of(tflat[k]), want.astype(np.float32),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        else:
            _assert_within_ulp(tflat[k], want, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_clip_by_global_norm_below_and_above(dtype, scale):
    """The norm rounds as optax's (each leaf's squares summed in its dtype,
    the sums added in turn); below the threshold nothing changes. Clipped
    values: bf16 bit for bit, fp32 within 1e-6 (the fp32 norm's sums run in
    another order)."""
    dt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jg, tg = _trees(3, dt, scale)
    jn, tn = optax.global_norm(jg), toptim.global_norm(tg)
    assert tn.dtype == dt[1]
    np.testing.assert_allclose(np_of(tn), np_of(jn), rtol=1e-6)
    ju, _ = optax.clip_by_global_norm(1.0).update(jg, optax.EmptyState())
    tu, _ = toptim.clip_by_global_norm(1.0).update(tg, toptim.EmptyState())
    if scale < 1e-2:
        assert all(tu[k] is tg[k] for k in tg)
    got = _port_in_jax_layout(tu)
    for mod, leaves in ju.items():
        for leaf, want in leaves.items():
            tol = F32 if dtype == "float32" else dict(rtol=0, atol=0)
            np.testing.assert_allclose(np_of(got[f"{mod}.{leaf}"]), np_of(want), **tol)


def test_warmup_first_step_is_zero():
    """linear_schedule(0, lr, warmup): lr is 0 at count 0, then rises."""
    sched, jsched = toptim.linear_schedule(0.0, 1e-3, 4), optax.linear_schedule(0.0, 1e-3, 4)
    assert sched(0) == 0.0
    assert [sched(c) for c in range(7)] == [float(jsched(c)) for c in range(7)]
    opt = ttrain.default_optimizer(1e-3, warmup_steps=4)
    _, tp = _trees(0, (jnp.float32, torch.float32))
    _, tg = _trees(1, (jnp.float32, torch.float32))
    u, _ = opt.update(tg, opt.init(tp), tp)
    assert all(not v.any() for v in u.values())


# -- the train step on the JAX tests' tiny UNet -----------------------------------

TINY_KW = dict(in_channels=4, out_channels=4, model_channels=8, channel_mult=(1, 2),
               num_res_blocks=1, attention_levels=(0,), context_dim=16, num_groups=4,
               num_heads=2)
# three steps of AdamW (lr 1e-3, clipped) in fp32: both sides exact fp32,
# summed in other orders (XLA's fusions against eager ops)
STEP_PARAMS = dict(rtol=1e-4, atol=1e-5)


def _port_unet(params):
    model = tunet.UNet(tunet.UNetConfig(**TINY_KW), device="cpu", dtype=torch.float32)
    load_params(model, params)
    return model


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, port model, x0, ctx): random_tree values, numpy batch."""
    cfg = junet.UNetConfig(**TINY_KW)
    params = random_tree(lambda k: junet.init(k, cfg), 0)
    return params, cfg, _port_unet(params), rand(1, 2, 8, 8, 4), rand(2, 2, 7, 16)


def _draws(rng, x0, cfg):
    """The JAX loss's t and noise for ``rng`` (its key split, in order)."""
    rt, rn = jax.random.split(rng)
    t = jtrain.sample_timesteps(rt, x0.shape[0], cfg)
    return np.asarray(t), np.asarray(jax.random.normal(rn, x0.shape, jnp.float32))


def _replay(monkeypatch, draws):
    """The port's draws in the step become ``draws`` [(t, noise), ...]."""
    ts = [torch.from_numpy(np.array(t)) for t, _ in draws]
    monkeypatch.setattr(tlosses, "sample_timesteps", lambda *a, **k: ts.pop(0))
    return replay_noise(monkeypatch, [n for _, n in draws])


@pytest.fixture(scope="module")
def jax_run(tiny):
    """Three steps of the JAX step (default optimizer, EMA 0.9): the
    states, metrics and draws after each."""
    params, cfg, _, x0, ctx = tiny
    jparams = jax.tree.map(jnp.asarray, params)
    opt = jtrain.default_optimizer(1e-3)
    step = jtrain.make_train_step(lambda p, x, t, c: junet.apply(p, x, t, c, cfg), opt,
                                  ema_decay=0.9, donate=False)
    state = jtrain.TrainState.create(jparams, opt, ema=True)
    out = []
    for i in range(3):
        rng = jax.random.key(10 + i)
        state, m = step(state, (jnp.asarray(x0), jnp.asarray(ctx)), rng)
        out.append((state, {k: float(v) for k, v in m.items()},
                    _draws(rng, x0, jtrain.LossConfig())))
    return out


def _port_state(model, ema=True):
    params = ttrain.params_of(set_trainable(model), trainable_only=True)
    return ttrain.TrainState.create(params, ttrain.default_optimizer(1e-3), ema=ema)


def _assert_tree_close(ttree, jtree, layouts, tol):
    flat = {k: np.asarray(v) for k, v in jflatten(jtree, "p").items()}
    assert set(flat) == {f"p.{k}" for k in ttree}
    for k, v in ttree.items():
        got = layouts[k].to_jax(v) if k in layouts else v
        np.testing.assert_allclose(np_of(got), flat[f"p.{k}"], err_msg=k, **tol)


def test_train_step_three_steps_match_jax(tiny, jax_run, monkeypatch):
    _, _, model, x0, ctx = tiny
    _replay(monkeypatch, [d for _, _, d in jax_run])
    step = ttrain.make_train_step(ttrain.module_apply(model), ttrain.default_optimizer(1e-3),
                                  ema_decay=0.9)
    state = _port_state(model)
    layouts = ttrain.param_layouts(model)
    assert list(state.params) == jax_order(state.params)
    batch = (torch.from_numpy(x0), torch.from_numpy(ctx))
    for jstate, jm, _ in jax_run:
        state, m = step(state, batch, torch.Generator())
        np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"], rtol=1e-5)
        _assert_tree_close(state.params, jstate.params, layouts, STEP_PARAMS)
        _assert_tree_close(state.ema_params, jstate.ema_params, layouts, STEP_PARAMS)
    assert state.step == 3


def test_remat_equals_no_remat_bit_for_bit(tiny):
    """The selective checkpoint recomputes on the CPU exactly what it
    dropped, so one step is the same bits with and without it."""
    _, _, model, x0, ctx = tiny
    batch = (torch.from_numpy(x0), torch.from_numpy(ctx))
    outs = []
    for remat in (False, True):
        step = ttrain.make_train_step(ttrain.module_apply(model),
                                      ttrain.default_optimizer(1e-3), remat=remat)
        state, m = step(_port_state(model, ema=False), batch,
                        torch.Generator().manual_seed(3))
        outs.append((m, state.params))
    assert torch.equal(outs[0][0]["loss"], outs[1][0]["loss"])
    for k, v in outs[0][1].items():
        assert torch.equal(v, outs[1][1][k]), k


def test_model_parameters_are_frozen_until_set_trainable(tiny):
    model = _port_unet(tiny[0])
    assert not any(p.requires_grad for p in model.parameters())
    assert ttrain.params_of(model, trainable_only=True) == {}
    set_trainable(model)
    assert all(p.requires_grad for p in model.parameters())
    assert set(ttrain.params_of(model, trainable_only=True)) == {
        n for n, _ in model.named_parameters()}


# -- LoRA ---------------------------------------------------------------------

def _jax_lora(params, rank=2):
    return jtrain.init_lora(jax.random.key(0), jax.tree.map(jnp.asarray, params), rank=rank)


def _port_lora(jlora):
    """The JAX adapter tree's values as the port's adapter dict."""
    return {k[2:]: torch.from_numpy(np.asarray(v)) for k, v in jflatten(jlora, "l").items()}


def test_init_lora_matches_the_jax_tree(tiny):
    params, _, model, _, _ = tiny
    jflat = jflatten(_jax_lora(params), "l")
    tl = ttrain.init_lora(torch.Generator().manual_seed(0), ttrain.params_of(model), rank=2)
    assert list(tl) == [k[2:] for k in jflat]
    for k, v in tl.items():
        assert tuple(v.shape) == jflat[f"l.{k}"].shape and v.dtype == torch.float32
        if k.endswith(".b"):
            assert not v.any()
    assert any(".to_q." in k for k in tl) and not any("norm" in k for k in tl)


@pytest.mark.parametrize("rank,dtype", [(1, "float32"), (1, "bfloat16"), (2, "float32")])
def test_lora_merge_matches_jax(tiny, rank, dtype):
    """W + scale * a @ b summed in fp32 and rounded once to W's dtype,
    against JAX's merge run op by op (under jit XLA fuses the sum). At rank 1
    the delta is one product, so the merge is JAX's bit for bit (an fp32 or
    a bf16 base); at rank 2 XLA's dot rounds its two products' sum
    otherwise than torch's, so within an fp32 ulp of the delta's terms."""
    params, _, model, _, _ = tiny
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    jparams = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), params)
    jlora = jax.tree_util.tree_map_with_path(  # a non-zero b: a real delta
        lambda p, x: x + 0.1 if str(getattr(p[-1], "key", "")) == "b" else x,
        _jax_lora(params, rank))
    want = jtrain.merge(jparams, jlora, 0.7)
    base = {k: v.to(tdt) for k, v in ttrain.params_of(model).items()}
    got = ttrain.merge(base, _port_lora(jlora), 0.7)
    layouts = ttrain.param_layouts(model)
    flat = jflatten(want, "p")
    tol = dict(rtol=0, atol=0) if rank == 1 else dict(rtol=2.5e-7, atol=1e-8)
    for k, v in got.items():
        assert v.dtype == tdt
        g = layouts[k].to_jax(v) if k in layouts else v
        np.testing.assert_allclose(np_of(g), np.asarray(flat[f"p.{k}"], np.float32),
                                   err_msg=k, **tol)


def test_lora_train_step_matches_jax(tiny, monkeypatch):
    """One LoRA step (adam 1e-2) against the jitted JAX step; only the
    adapters change."""
    params, cfg, model, x0, ctx = tiny
    jparams = jax.tree.map(jnp.asarray, params)
    jlora = _jax_lora(params)
    lora = _port_lora(jlora)  # before the JAX step, which donates the adapters
    jopt = optax.adam(1e-2)
    jstep = jtrain.make_lora_train_step(lambda p, x, t, c: junet.apply(p, x, t, c, cfg), jopt)
    rng = jax.random.key(5)
    jstate, jm = jstep(jtrain.TrainState.create(jlora, jopt), jparams,
                       (jnp.asarray(x0), jnp.asarray(ctx)), rng)
    _replay(monkeypatch, [_draws(rng, x0, jtrain.LossConfig())])
    topt = toptim.chain(toptim.scale_by_adam(), toptim.scale_by_learning_rate(1e-2))
    base = ttrain.params_of(model)
    before = {k: v.clone() for k, v in base.items()}
    tstep = ttrain.make_lora_train_step(ttrain.module_apply(model), topt)
    tstate, tm = tstep(ttrain.TrainState.create(lora, topt), base,
                       (torch.from_numpy(x0), torch.from_numpy(ctx)), torch.Generator())
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    flat = jflatten(jstate.params, "l")
    for k, v in tstate.params.items():
        np.testing.assert_allclose(np_of(v), np.asarray(flat[f"l.{k}"]), err_msg=k,
                                   **STEP_PARAMS)
    assert any(v.any() for k, v in tstate.params.items() if k.endswith(".b"))
    assert all(torch.equal(before[k], v) for k, v in base.items())


# -- checkpoints ----------------------------------------------------------------

def test_checkpoint_written_by_jax_resumes_in_the_port(tiny, jax_run, tmp_path):
    _, _, model, _, _ = tiny
    jstate = jax_run[0][0]
    path = tmp_path / "jax.safetensors"
    jtrain.save_train_state(jstate, path)
    layouts = ttrain.param_layouts(model)
    got = ttrain.load_train_state(_port_state(model), path, layouts)
    assert got.step == 1
    _assert_tree_close(got.params, jstate.params, layouts, dict(rtol=0, atol=0))
    _assert_tree_close(got.ema_params, jstate.ema_params, layouts, dict(rtol=0, atol=0))
    adam = got.opt_state[1][0]
    assert int(adam.count) == 1
    _assert_tree_close(adam.mu, jstate.opt_state[1][0].mu, layouts, dict(rtol=0, atol=0))
    _assert_tree_close(adam.nu, jstate.opt_state[1][0].nu, layouts, dict(rtol=0, atol=0))


def test_checkpoint_written_by_the_port_resumes_in_jax(tiny, tmp_path):
    params, cfg, model, x0, ctx = tiny
    step = ttrain.make_train_step(ttrain.module_apply(model),
                                  ttrain.default_optimizer(1e-3, warmup_steps=3),
                                  ema_decay=0.9)
    state = ttrain.TrainState.create(ttrain.params_of(model), ttrain.default_optimizer(
        1e-3, warmup_steps=3), ema=True)
    batch = (torch.from_numpy(x0), torch.from_numpy(ctx))
    for i in range(2):
        state, _ = step(state, batch, torch.Generator().manual_seed(i))
    path = tmp_path / "port.safetensors"
    layouts = ttrain.param_layouts(model)
    ttrain.save_train_state(state, path, layouts)
    jopt = jtrain.default_optimizer(1e-3, warmup_steps=3)
    template = jtrain.TrainState.create(jax.tree.map(jnp.asarray, params), jopt, ema=True)
    got = jtrain.load_train_state(template, path)
    assert int(got.step) == 2 and int(got.opt_state[1][2].count) == 2
    exact = dict(rtol=0, atol=0)
    _assert_tree_close(state.params, got.params, layouts, exact)
    _assert_tree_close(state.ema_params, got.ema_params, layouts, exact)
    _assert_tree_close(state.opt_state[1][0].mu, got.opt_state[1][0].mu, layouts, exact)
    _assert_tree_close(state.opt_state[1][0].nu, got.opt_state[1][0].nu, layouts, exact)


def test_resumed_run_equals_an_unbroken_one(tiny, tmp_path):
    _, _, model, x0, ctx = tiny
    batch = (torch.from_numpy(x0), torch.from_numpy(ctx))
    step = ttrain.make_train_step(ttrain.module_apply(model), ttrain.default_optimizer(1e-3),
                                  ema_decay=0.9)
    layouts = ttrain.param_layouts(model)
    whole = _port_state(model)
    for i in range(2):
        whole, _ = step(whole, batch, torch.Generator().manual_seed(i))
    half, _ = step(_port_state(model), batch, torch.Generator().manual_seed(0))
    ttrain.save_train_state(half, tmp_path / "s.safetensors", layouts)
    resumed = ttrain.load_train_state(_port_state(model), tmp_path / "s.safetensors", layouts)
    resumed, _ = step(resumed, batch, torch.Generator().manual_seed(1))
    assert resumed.step == whole.step == 2
    for a, b in ((resumed.params, whole.params), (resumed.ema_params, whole.ema_params),
                 (resumed.opt_state[1][0].mu, whole.opt_state[1][0].mu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# -- data -------------------------------------------------------------------------

def test_latent_dataset_batches_equal_jax():
    lat = np.arange(10 * 2, dtype=np.float32).reshape(10, 2)
    ctx = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    for shuffle in (True, False):
        jds = jtrain.LatentDataset(lat, ctx, batch_size=4, seed=7, shuffle=shuffle)
        tds = ttrain.LatentDataset(lat, ctx, batch_size=4, seed=7, shuffle=shuffle)
        assert len(tds) == len(jds) == 2
        for _ in range(2):  # two epochs: the generator state carries over
            for jb, tb in zip(jds.epoch(), tds.epoch()):
                for a, b in zip(jb, tb):
                    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        ttrain.LatentDataset(lat, ctx[:9], batch_size=4)


def test_write_shard_bytes_equal_jax(tmp_path):
    import ml_dtypes

    arrays = [np.arange(24, dtype=np.float32).reshape(6, 2, 2), np.arange(6, dtype=np.int32),
              rand(3, 6, 5).astype(np.float16), rand(4, 6, 3).astype(ml_dtypes.bfloat16)]
    jtrain.write_shard(tmp_path / "j.tfls", *arrays)
    ttrain.write_shard(tmp_path / "t.tfls", *arrays)
    ttrain.write_shard(tmp_path / "tt.tfls", *arrays[:3],
                       torch.from_numpy(arrays[3].astype(np.float32)).to(torch.bfloat16))
    want = (tmp_path / "j.tfls").read_bytes()
    assert (tmp_path / "t.tfls").read_bytes() == want
    assert (tmp_path / "tt.tfls").read_bytes() == want


def test_native_shard_dataset_reads_a_jax_shard(tmp_path):
    import ml_dtypes

    from tinyfusers_tpu_torch.native import get_lib

    if get_lib() is None:
        pytest.skip("libtfnative could not be built (no g++)")
    n = 10
    lat = np.arange(n * 4, dtype=np.float32).reshape(n, 2, 2, 1)
    ids = np.arange(n, dtype=np.int32)
    half = rand(5, n, 3).astype(ml_dtypes.bfloat16)
    jtrain.write_shard(tmp_path / "d.tfls", lat, ids, half)
    ds = ttrain.NativeShardDataset(tmp_path / "d.tfls", batch_size=4, shuffle=False)
    assert len(ds) == 2
    batches = list(ds.epoch())
    ds.close()
    np.testing.assert_array_equal(batches[0][0].numpy(), lat[:4])
    np.testing.assert_array_equal(batches[1][1].numpy(), ids[4:8])
    assert batches[0][2].dtype == torch.bfloat16
    np.testing.assert_array_equal(batches[0][2].float().numpy(), half[:4].astype(np.float32))
    ds = ttrain.NativeShardDataset(tmp_path / "d.tfls", batch_size=5, seed=3)
    e1 = np.concatenate([b[1].numpy() for b in ds.epoch()])
    ds.close()
    assert sorted(e1.tolist()) == list(range(n))
