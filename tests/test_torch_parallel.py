"""The port's parallel package (tinyfusers_tpu_torch/parallel/) on the CPU:
four gloo ranks on a (data 2, model 2) mesh against the JAX package's
dense results (the JAX tests use data 4 x model 2 on 8 virtual devices).

The ranks are spawned once for the module (``ranks``): each runs every
case of ``torch_parallel_worker`` on numpy inputs made here from seeds (the
JAX params as numpy trees, ``random_tree``: every leaf non-zero, the
adaLN-Zero ones included) and returns its results; each case is its own
test below. While they run, this process computes the JAX references.

Tolerances, the JAX tests' own: sharded forwards within atol 2e-4, rtol
2e-3 (fp32; TP sums each row-parallel product in another order); images
within 1 of 255 (as tests/test_torch_pipeline.py's generate; every
generation entry point on the mesh, its generator's draws replayed from
the JAX dense call's global normals); a train
step's loss within rtol 2e-4 and every parameter leaf within rtol 2e-3,
atol 2e-5; ring attention alone within atol 2e-5, rtol 2e-4 of the JAX
``sdpa_xla``; the pipelined linear stack within 1e-6 and the pipelined
MMDiT within 1e-5 of the JAX ``lax.scan``; the sharded engine's images
within 1 level of the JAX one-device engine's on under 2% of the pixels
(tests/test_serve.py's TestShardedEngine bound), and bit-equal across the
ranks (tests/test_multihost.py). The JAX pipeline test's (8 stages, 4
microbatches) needs 8 ranks: the four here run (2, 2), (4, 2) and (4, 4).

The traps of an explicit sharding each have a test that fails when the
trap is back: the GEGLU halves (a plain column cut of ``ff.proj`` gives
other numbers), local heads (every sharded forward), the T5 bias table cut
to the rank's heads, heads that do not divide (SD2-style 5-head level), the
global noise draw (rank r's t and noise are rows r of the global draw;
train steps replay the JAX draws by row), the global norm (AdamW with
clipping at 1.0 against the JAX step's grad_norm), Adafactor's statistics
over whole leaves (factored from 8 wide, the GEGLU halves among the split
leaves; the MMDiT's block RMS over its whole stack).
"""
import dataclasses
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from tinyfusers_tpu import parallel as jparallel
from tinyfusers_tpu import train as jtrain
from tinyfusers_tpu.io.quantize_tree import quantize_params
from tinyfusers_tpu.models import clip as jclip
from tinyfusers_tpu.models import controlnet as jcn
from tinyfusers_tpu.models import dit as jdit
from tinyfusers_tpu.models import mmdit as jmmdit
from tinyfusers_tpu.models import t5 as jt5
from tinyfusers_tpu.models import unet as junet
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu.pipeline import sd3 as jsd3
from tinyfusers_tpu.pipeline import sdxl as jsdxl
from tinyfusers_tpu.ops.attention import sdpa_xla
from tinyfusers_tpu.serve import engine as jengine
from tinyfusers_tpu_torch import parallel as tparallel
from tinyfusers_tpu_torch import train as ttrain
from tinyfusers_tpu_torch.io.from_jax import load_params
from tinyfusers_tpu_torch.io.quantize_tree import quantize_params as tquantize_params
from tinyfusers_tpu_torch.models import controlnet as tcn
from tinyfusers_tpu_torch.models import dit as tdit
from tinyfusers_tpu_torch.models import mmdit as tmmdit
from tinyfusers_tpu_torch.models import t5 as tt5
from tinyfusers_tpu_torch.models import unet as tunet
from tinyfusers_tpu_torch.pipeline import samplers as tsamplers
from tinyfusers_tpu_torch.pipeline import sd as tsd
from tinyfusers_tpu_torch.pipeline import sd3 as tsd3
from tinyfusers_tpu_torch.pipeline import sdxl as tsdxl
from tinyfusers_tpu_torch.serve import engine as tengine

import torch_parallel_worker as worker
from torch_parity import few_torch_threads, jax_noises, random_tree  # noqa: F401

WORLD = 4
OUT = dict(atol=2e-4, rtol=2e-3)
LOSS_RTOL = 2e-4
PARAMS = dict(rtol=2e-3, atol=2e-5)
RANKS_TIMEOUT = 300  # seconds for every case on every rank
# the MMDiT step's SGD rate: at 1e-2 a qk gain's missing gradient share
# moves one element of 32 past the tolerance, at 1.0 most of them
QKN_LR = 1.0
# Adafactor's steps: the rate, and the smallest dim it factors (optax's 128
# would factor no leaf of these widths)
ADA = ("adafactor", 1e-2, 8)
GEN_STEPS = 2  # the mesh generate cases' steps

# tests/test_train.py's tiny UNet, for the train steps
TRAIN_KW = dict(in_channels=4, out_channels=4, model_channels=8, channel_mult=(1, 2),
                num_res_blocks=1, attention_levels=(0,), context_dim=16, num_groups=4,
                num_heads=2)
# SD2-style 64... here 8-wide heads: 5 at level 0 (no split at model 2), 10 at level 1
NONDIV_KW = dict(model_channels=40, channel_mult=(1, 2), attention_levels=(0, 1),
                 context_dim=16, num_heads=-1, head_dim=8, num_groups=8)
RING = "ring:model,data"  # the JAX ring wiring tests' impl
RING_OUT = dict(atol=2e-5, rtol=2e-4)
PIPE_STACK = [(2, 2), (4, 2), (4, 4)]  # (stages, microbatches)
SERVE_STEPS = (2, 3, 2)  # tests/multihost_worker.py's requests


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def perturbed(tree, seed):
    """tree + 0.03 N, as the JAX tests perturb the adaLN-Zero init."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x + 0.03 * rng.standard_normal(x.shape).astype(np.float32),
                        tree)


def _names(path):
    return [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]


def flat_specs(specs) -> dict:
    """A JAX spec tree -> {dotted path: spec}."""
    leaves = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {".".join(_names(p)): s for p, s in leaves}


def flat_tree(tree) -> dict:
    return {".".join(_names(p)): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def unstacked(name: str, stacked=("blocks", "layers")) -> str:
    """A port parameter name -> its JAX path (the stacked block index dropped)."""
    parts = name.split(".")
    return ".".join(p for i, p in enumerate(parts)
                    if not (p.isdigit() and i and parts[i - 1] in stacked))


def jitted_unet(cfg):
    """The JAX UNet's apply under jit: seconds where the op-by-op first run
    of a new shape takes over ten."""
    return jax.jit(lambda p, a, b, c: junet.apply(p, a, b, c, cfg))


# -- inputs ---------------------------------------------------------------------

def _inputs():
    """{case: (worker kwargs, reference fn)}: the reference computes the JAX
    dense result in this process."""
    c = {}
    ucfg = junet.TINY_CONFIG
    up = random_tree(lambda k: junet.init(k, ucfg), 0)
    x, t, ctx = rand(1, 4, 16, 16, 4), np.full((4,), 500.0, np.float32), rand(2, 4, 8, 16)
    unet_ref = lambda: np.asarray(jitted_unet(ucfg)(up, x, t, ctx))  # noqa: E731
    c["unet"] = (dict(case="unet_forward", cfg=tunet.TINY_CONFIG, params=up, x=x, t=t, ctx=ctx),
                 unet_ref)
    c["unet_ring"] = (dict(case="unet_forward", cfg=dataclasses.replace(
        tunet.TINY_CONFIG, self_attn_impl=RING), params=up, x=x, t=t, ctx=ctx), unet_ref)
    c["unet_plain_column"] = (dict(case="unet_forward", cfg=tunet.TINY_CONFIG, params=up, x=x,
                                   t=t, ctx=ctx, plain_geglu_column=True), unet_ref)

    ncfg = junet.UNetConfig(**NONDIV_KW)
    nparams = random_tree(lambda k: junet.init(k, ncfg), 3)
    nctx = rand(4, 4, 8, 16)
    c["nondiv"] = (dict(case="unet_forward", cfg=tunet.UNetConfig(**NONDIV_KW), params=nparams,
                        x=x, t=t, ctx=nctx),
                   lambda: np.asarray(jitted_unet(ncfg)(nparams, x, t, nctx)))

    xcfg = jsdxl.TINY_XL.unet
    xp = random_tree(lambda k: junet.init(k, xcfg), 5)
    xctx, adm = rand(6, 4, 8, xcfg.context_dim), rand(7, 4, xcfg.adm_in_channels)
    c["sdxl_unet"] = (dict(case="unet_forward", cfg=tsdxl.TINY_XL.unet, params=xp, x=x, t=t,
                           ctx=xctx, adm=adm),
                      lambda: np.asarray(junet.apply(xp, x, t, xctx, xcfg, adm_cond=adm)))

    dp = perturbed(random_tree(lambda k: jdit.init(k, jdit.TINY_DIT), 8), 9)
    dx = rand(10, 4, 8, 8, 4)
    c["dit"] = (dict(case="dit_forward", cfg=tdit.TINY_DIT, params=dp, x=dx, t=t),
                lambda: np.asarray(jdit.apply(dp, dx, t, jdit.TINY_DIT)))

    mcfg = jmmdit.TINY_MMDIT
    mp_ = perturbed(random_tree(lambda k: jmmdit.init(k, mcfg), 11), 9)
    mt, mctx, pooled = np.full((4,), 0.5, np.float32), rand(12, 4, 8, 32), rand(13, 4, 16)
    c["mmdit"] = (dict(case="mmdit_forward", cfg=tmmdit.TINY_MMDIT, params=mp_, x=dx, t=mt,
                       ctx=mctx, pooled=pooled),
                  lambda: np.asarray(jmmdit.apply(mp_, dx, mt, mctx, pooled, mcfg)))
    # the joint attention over 16 + 7 = 23 tokens, which do not divide over
    # the ring's 2 ranks
    rcfg = dataclasses.replace(mcfg, context_len=7)
    rctx = rand(30, 4, 7, 32)
    c["mmdit_ring"] = (dict(case="mmdit_forward", cfg=dataclasses.replace(
        tmmdit.TINY_MMDIT, context_len=7, attn_impl=RING), params=mp_, x=dx, t=mt, ctx=rctx,
        pooled=pooled), lambda: np.asarray(jmmdit.apply(mp_, dx, mt, rctx, pooled, rcfg)))
    c["mmdit_pipe"] = (dict(case="pipe_mmdit", cfg=tmmdit.TINY_MMDIT, params=mp_, x=dx, t=mt,
                            ctx=mctx, pooled=pooled), c["mmdit"][1])
    # SD3.5's per-head RMS q / k gains, replicated over the model ranks
    qcfg = jmmdit.TINY_MMDIT_QKN
    qp = perturbed(random_tree(lambda k: jmmdit.init(k, qcfg), 25), 26)
    c["mmdit_qkn"] = (dict(case="mmdit_forward", cfg=tmmdit.TINY_MMDIT_QKN, params=qp, x=dx,
                           t=mt, ctx=mctx, pooled=pooled),
                      lambda: np.asarray(jmmdit.apply(qp, dx, mt, mctx, pooled, qcfg)))
    # __graft_entry__.dryrun_multichip's MMDiT: zero context and pooled vectors
    mp0 = random_tree(lambda k: jmmdit.init(k, mcfg), 14)
    zc, zp = np.zeros((4, 8, 32), np.float32), np.zeros((4, 16), np.float32)
    c["mmdit_dryrun"] = (dict(case="mmdit_forward", cfg=tmmdit.TINY_MMDIT, params=mp0, x=dx,
                              t=mt, ctx=zc, pooled=zp),
                         lambda: np.asarray(jmmdit.apply(mp0, dx, mt, zc, zp, mcfg)))

    scfg = jsd.TINY
    sp = random_tree(lambda k: jsd.init(k, scfg), 15)
    rng = np.random.default_rng(16)
    n = scfg.clip.max_length
    ids = rng.integers(0, scfg.clip.vocab_size - 1, (4, n)).astype(np.int32)
    uids = np.full((4, n), scfg.clip.vocab_size - 1, np.int32)
    uids[:, 0] = 0
    lat = rng.standard_normal((4, *tsd.TINY.latent_shape)).astype(np.float32)
    gen_ref = lambda: np.asarray(jsd.generate(sp, ids, uids, lat, jnp.float32(7.5),  # noqa: E731
                                              num_steps=2, cfg=scfg))
    c["generate"] = (dict(case="sd_generate", cfg=tsd.TINY, params=sp, ids=ids, uids=uids,
                          latent=lat, steps=2), gen_ref)
    rsd = dataclasses.replace(tsd.TINY, unet=dataclasses.replace(tsd.TINY.unet,
                                                                 self_attn_impl=RING))
    c["generate_ring"] = (dict(case="sd_generate", cfg=rsd, params=sp, ids=ids, uids=uids,
                               latent=lat, steps=2), gen_ref)

    # every entry point on the mesh, against the JAX dense call whose
    # normals each rank's generator draws replay (the global batch's, the
    # rank keeping its rows)
    g = jnp.float32(7.5)
    gkey = jax.random.key(41)
    on_mesh = dict(case="sd_mesh", cfg=tsd.TINY, params=sp, ids=ids, uids=uids)
    c["gen_ancestral"] = (
        dict(on_mesh, kind="generate", latent=lat,
             noises=jax_noises(gkey, 0, GEN_STEPS, lat.shape),
             kw=dict(num_steps=GEN_STEPS, method="euler_ancestral")),
        lambda: np.asarray(jsd.generate(sp, ids, uids, lat, g, num_steps=GEN_STEPS, cfg=scfg,
                                        method="euler_ancestral", key=gkey)))
    cnp = random_tree(lambda k: jcn.init(k, scfg.unet), 42)
    hint = np.random.default_rng(43).random((1, 128, 128, 3)).astype(np.float32)  # 8x latents
    c["gen_control"] = (
        dict(on_mesh, kind="generate", latent=lat, control=(cnp, hint, 0.9),
             kw=dict(num_steps=GEN_STEPS)),
        lambda: np.asarray(jsd.generate(sp, ids, uids, lat, g, num_steps=GEN_STEPS, cfg=scfg,
                                        control=(cnp, jnp.asarray(hint), 0.9))))
    src = rng.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    c["img2img_mesh"] = (
        dict(on_mesh, kind="img2img", image=src,
             noises=[np.asarray(jax.random.normal(gkey, lat.shape, jnp.float32))],
             kw=dict(num_steps=4, start_step=3)),
        lambda: np.asarray(jsd.img2img(sp, src, ids, uids, gkey, g, num_steps=4, start_step=3,
                                       cfg=scfg)))
    icfg = dataclasses.replace(scfg, unet=dataclasses.replace(scfg.unet, in_channels=9))
    ip = random_tree(lambda k: jsd.init(k, icfg), 44)
    mask = np.zeros((4, 32, 32, 1), np.float32)
    mask[:, :, 16:] = 1.0
    mask[1, 4:9, 3:7] = 1.0
    c["inpaint_mesh"] = (
        dict(on_mesh, kind="inpaint", cfg=dataclasses.replace(
            tsd.TINY, unet=dataclasses.replace(tsd.TINY.unet, in_channels=9)), params=ip,
             image=src, mask=mask, latent=lat, kw=dict(num_steps=GEN_STEPS)),
        lambda: np.asarray(jsd.inpaint(ip, src, mask, ids, uids, lat, g, num_steps=GEN_STEPS,
                                       cfg=icfg)))
    hs = GEN_STEPS + 1
    k_base, k_noise, k_hi = jax.random.split(gkey, 3)
    hi_shape = (4, 2 * lat.shape[1], 2 * lat.shape[2], lat.shape[3])
    c["hires_mesh"] = (
        dict(on_mesh, kind="hires", latent=lat,
             noises=(jax_noises(k_base, 0, GEN_STEPS, lat.shape)
                     + [np.asarray(jax.random.normal(k_noise, hi_shape, jnp.float32))]
                     + jax_noises(k_hi, tsd.hires_tail_start(hs, 0.6), hs, hi_shape)),
             kw=dict(num_steps=GEN_STEPS, method="euler_ancestral", hires_steps=hs,
                     hires_strength=0.6)),
        lambda: np.asarray(jsd.generate_hires(sp, ids, uids, lat, gkey, g, num_steps=GEN_STEPS,
                                              cfg=scfg, method="euler_ancestral",
                                              hires_steps=hs, hires_strength=0.6)))
    xlp = random_tree(lambda k: jsdxl.init(k, jsdxl.TINY_XL), 45)
    xids = rng.integers(0, 127, (2, 4, 16)).astype(np.int32)
    xids[:, :, 9:] = 127
    xuids = np.full((2, 4, 16), 127, np.int32)
    xuids[:, :, 0] = 0
    xlat = rng.standard_normal((4, *tsdxl.TINY_XL.latent_shape)).astype(np.float32)
    c["sdxl_mesh"] = (
        dict(case="sdxl_mesh", cfg=tsdxl.TINY_XL, params=xlp, ids=xids, uids=xuids,
             latent=xlat, noises=jax_noises(gkey, 0, GEN_STEPS, xlat.shape), steps=GEN_STEPS),
        lambda: np.asarray(jsdxl.generate(xlp, *xids, *xuids, xlat, g, num_steps=GEN_STEPS,
                                          cfg=jsdxl.TINY_XL, method="euler_ancestral",
                                          key=gkey)))
    s3p = random_tree(lambda k: jsd3.init(k, jsd3.TINY_SD3), 46)
    s3ids = rng.integers(0, 127, (4, 4, 8)).astype(np.int32)
    s3ids[:2, :, 5:] = 127
    s3ids[2:] = 127
    s3ids[2:, :, 0] = 0
    s3lat = rng.standard_normal((4, *tsd3.TINY_SD3.latent_shape)).astype(np.float32)
    c["sd3_mesh"] = (
        dict(case="sd3_mesh", cfg=tsd3.TINY_SD3, params=s3p, ids=s3ids, latent=s3lat,
             steps=GEN_STEPS),
        lambda: np.asarray(jsd3.generate(s3p, *s3ids, s3lat, jnp.float32(5.0),
                                         num_steps=GEN_STEPS, cfg=jsd3.TINY_SD3)))

    ccfg = scfg.clip
    cp = sp["clip"]
    c["clip"] = (dict(case="clip_forward", cfg=tsd.TINY.clip, params=cp, ids=ids),
                 lambda: (np.asarray(jclip.apply(cp, ids, ccfg)),
                          np.asarray(jclip.apply_pooled(cp, ids, ccfg))))
    tp_ = random_tree(lambda k: jt5.init(k, jt5.TINY_T5), 17)
    tids = np.random.default_rng(18).integers(0, 255, (4, 12)).astype(np.int32)
    c["t5"] = (dict(case="t5_forward", cfg=tt5.TINY_T5, params=tp_, ids=tids),
               lambda: np.asarray(jt5.apply(tp_, tids, jt5.TINY_T5)))

    # ring attention alone: (2, 64, 16) over 4 ranks, a remote key moved on
    # the last shard, 61 tokens (which do not divide) at 2 heads
    q, k, v = rand(31, 2, 64, 16), rand(32, 2, 64, 16), rand(33, 2, 64, 16)
    k_remote = k.copy()
    k_remote[0, -1] += 10.0
    odd = [rand(34 + i, 1, 2, 61, 8) for i in range(3)]
    c["ring"] = (dict(case="ring_cases", q=q, k=k, v=v, k_remote=k_remote, q_odd=odd[0],
                      k_odd=odd[1], v_odd=odd[2]),
                 lambda: {"out": np.asarray(sdpa_xla(q, k, v)),
                          "odd": np.asarray(sdpa_xla(*odd)),
                          "two": np.asarray(sdpa_xla(*(a[..., :2, :] for a in odd)))})

    # GPipe: the JAX test's linear stack (L 8, batch 4, width 16) and carry
    ws, bs, px = rand(40, 8, 16, 16) * 0.1, rand(41, 8, 16) * 0.1, rand(42, 4, 16)

    def stack_ref():
        def blk(lp, c):
            return jnp.tanh(c @ lp["w"] + lp["b"])
        y, _ = jax.lax.scan(lambda cc, lp: (blk(lp, cc), None), px, {"w": ws, "b": bs})
        return np.asarray(y)

    for stages, mbs in PIPE_STACK:
        c[f"pipe_{stages}_{mbs}"] = (dict(case="pipe_linear", ws=ws, bs=bs, x=px, stages=stages,
                                          microbatches=mbs), stack_ref)
    cw, cx, cc = rand(43, 4, 8, 8) * 0.1, rand(44, 4, 8), rand(45, 4, 8)

    def carry_ref():
        (y, _), _ = jax.lax.scan(lambda carry, lp: ((jnp.tanh(carry[0] @ lp + carry[1]),
                                                     carry[1]), None), (cx, cc), cw)
        return np.asarray(y)

    c["pipe_carry"] = (dict(case="pipe_carry", ws=cw, x=cx, cond=cc), carry_ref)
    c["pipe_raises"] = (dict(case="pipe_raises", x=px), None)

    # the serving engine: tests/multihost_worker.py's requests, each with the
    # JAX engine's initial latent (jax.random.normal of its seed) replayed
    sids = np.full((n,), 3, np.int32)
    suids = np.zeros_like(sids)
    slat = {seed: np.asarray(jax.random.normal(jax.random.key(seed), scfg.latent_shape,
                                               jnp.float32)) for seed in range(3)}

    def engine_ref():
        eng = jengine.Engine(sp, scfg, num_slots=4)
        for i, steps in enumerate(SERVE_STEPS):
            eng.submit(eng.make_request(sids, suids, num_steps=steps, guidance=5.0, seed=i))
        return {r.request_id: r.image for r in eng.run_until_idle()}

    serve_kw = dict(cfg=tsd.TINY, params=sp, latents=slat, ids=sids, uids=suids,
                    steps=SERVE_STEPS)
    c["serve_mesh"] = (dict(case="serve_mesh", **serve_kw), engine_ref)
    c["serve_subgroup"] = (dict(case="serve_subgroup", **serve_kw), engine_ref)

    c["mesh"] = (dict(case="mesh_axes"), None)
    c["sync"] = (dict(case="sync_decision"), None)
    c["batch"] = (dict(case="batch_rows", x=np.arange(4 * 3, dtype=np.float32).reshape(4, 3)),
                  None)
    c["noise_rows"] = (dict(case="noise_rows", shape=(4, 8, 8, 4), seed=21), None)

    tcfg = junet.UNetConfig(**TRAIN_KW)
    trp = random_tree(lambda k: junet.init(k, tcfg), 22)
    x0, tctx = rand(23, 4, 8, 8, 4), rand(24, 4, 7, 16)
    key = jax.random.key(3)
    rt, rn = jax.random.split(key)
    draws = (np.asarray(jtrain.sample_timesteps(rt, 4, jtrain.LossConfig())),
             np.asarray(jax.random.normal(rn, x0.shape, jnp.float32)))
    port_cfg = tunet.UNetConfig(**TRAIN_KW)

    def jax_step(opt, apply=lambda p, a, b, cc: junet.apply(p, a, b, cc, tcfg), params=trp,
                 batch=(x0, tctx), loss_cfg=jtrain.LossConfig(), steps=1):
        def run():  # ``steps`` steps on the same batch and draws
            step = jtrain.make_train_step(apply, opt, loss_cfg, donate=False)
            state = jtrain.TrainState.create(jax.tree.map(jnp.asarray, params), opt)
            for _ in range(steps):
                state, m = step(state, tuple(jnp.asarray(a) for a in batch), key)
            return flat_tree(state.params), {k: float(v) for k, v in m.items()}
        return run

    sgd_ref = jax_step(optax.sgd(1e-2))
    common = dict(case="train_step", cfg=port_cfg, params=trp, x0=x0, cond=(tctx,), draws=draws)
    c["train_dp_tp_sgd"] = (dict(common, opt="sgd"), sgd_ref)
    c["train_fsdp_sgd"] = (dict(common, opt="sgd", fsdp_min_size=1), sgd_ref)
    c["train_fsdp_adamw"] = (dict(common, opt="adamw", fsdp_min_size=1),
                             jax_step(jtrain.default_optimizer(1e-3)))
    # the MMDiT's replicated ln_q / ln_k gains, which each model rank applies
    # to its own heads: their gradients must be summed over the model group.
    # The rectified-flow objective SD3 trains with (t in (0, 1)).
    qx0, qctx, qpooled = rand(27, 4, 8, 8, 4), rand(28, 4, 8, 32), rand(29, 4, 16)
    rf = jtrain.LossConfig(objective="rf")
    rf_draws = (np.asarray(jtrain.sample_timesteps(rt, 4, rf)), draws[1])
    c["train_mmdit_qkn_sgd"] = (
        dict(case="train_step", cfg=tmmdit.TINY_MMDIT_QKN, params=qp, x0=qx0,
             cond=(qctx, qpooled), draws=rf_draws, opt=("sgd", QKN_LR), objective="rf"),
        jax_step(optax.sgd(QKN_LR), lambda p, a, b, cc, pp: jmmdit.apply(p, a, b, cc, pp, qcfg),
                 qp, (qx0, qctx, qpooled), rf))
    # Adafactor: two steps, so that the second reads the statistics each
    # rank holds from the first
    ada_ref = jax_step(optax.adafactor(ADA[1], min_dim_size_to_factor=ADA[2]), steps=2)
    ada = dict(common, opt=ADA, steps=2)
    c["train_dp_tp_adafactor"] = (ada, ada_ref)
    c["train_fsdp_adafactor"] = (dict(ada, fsdp_min_size=1), ada_ref)
    c["train_fsdp4_adafactor"] = (dict(ada, fsdp_min_size=1, mesh_shape=(4, 1)), ada_ref)
    c["train_mmdit_qkn_adafactor"] = (
        dict(case="train_step", cfg=tmmdit.TINY_MMDIT_QKN, params=qp, x0=qx0,
             cond=(qctx, qpooled), draws=rf_draws, opt=ADA, objective="rf", steps=2),
        jax_step(optax.adafactor(ADA[1], min_dim_size_to_factor=ADA[2]),
                 lambda p, a, b, cc, pp: jmmdit.apply(p, a, b, cc, pp, qcfg),
                 qp, (qx0, qctx, qpooled), rf, steps=2))
    c["train_unplaced"] = (dict(case="train_unplaced", cfg=port_cfg, params=trp, x0=x0,
                                ctx=tctx), None)
    def fsdp_specs_ref():
        mesh = jparallel.make_mesh(data=2, model=2, devices=jax.devices()[:4])
        stats = optax.adafactor(ADA[1], min_dim_size_to_factor=ADA[2]).init(trp)[0]
        specs = {"params": trp, "v_row": stats.v_row, "v_col": stats.v_col, "v": stats.v}
        return {k: flat_specs(jparallel.fsdp_spec_tree(t, mesh, min_size=1))
                for k, t in specs.items()}

    c["fsdp_specs"] = (dict(case="fsdp_specs", cfg=port_cfg, params=trp), fsdp_specs_ref)
    return c


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(per-rank results {case: result}, JAX references {case: value},
    the inputs {case: (worker kwargs, reference)})."""
    inputs = _inputs()
    cases = [(name, kw) for name, (kw, _) in inputs.items()]
    out = tmp_path_factory.mktemp("ranks")
    procs = tmp_mp.start_processes(worker.run, args=(WORLD, str(out / "store"), cases, str(out)),
                                   nprocs=WORLD, join=False, start_method="spawn")
    refs, done = {}, {}
    try:
        for name, (_, ref) in inputs.items():
            if ref is not None:
                if id(ref) not in done:  # cases sharing a reference compute it once
                    done[id(ref)] = ref()
                refs[name] = done[id(ref)]
        deadline = time.monotonic() + RANKS_TIMEOUT
        while not procs.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD} ranks did not finish in {RANKS_TIMEOUT} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
    results = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results, refs, inputs


def result(ranks, name, rank=0):
    got = ranks[0][rank][name]
    if isinstance(got, tuple) and got and got[0] == "error":
        pytest.fail(f"rank {rank} raised in case {name}:\n{got[1]}")
    return got


# -- the mesh and the process group -----------------------------------------------

def test_mesh_axes(ranks):
    got = result(ranks, "mesh")
    assert got["mesh"] == {"data": 2, "model": 2}
    assert got["initialize_again"] is True  # a second initialize is harmless


def test_hybrid_mesh(ranks):
    assert result(ranks, "mesh")["hybrid"] == {"data": 2, "model": 2}


def test_sync_decision_gives_rank0_value(ranks):
    for r in range(WORLD):
        got = result(ranks, "sync", r)
        assert float(got["admit"][0]) == 7.0 and got["seed"] == 100 and got["ids"] == [0, 0]


def test_make_mesh_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tparallel.make_mesh()
    assert tparallel.distributed.initialize() is False  # nothing configured: a no-op


# -- the partition rules ------------------------------------------------------------

def _port_unet(cfg):
    return tunet.UNet(cfg, device="cpu")


def test_tp_specs_cover_attention():
    specs = tparallel.tp_spec_tree(_port_unet(tunet.TINY_CONFIG))
    assert sum(s == (None, "model") for s in specs.values()) > 0
    assert sum(s == ("model", None) for s in specs.values()) > 0


@pytest.mark.parametrize("model", ["unet", "dit", "mmdit", "t5", "controlnet"])
def test_specs_equal_jax_tp_spec_tree(model):
    """Every leaf's spec is the JAX tp_spec_tree's (stacked leaves with
    their leading layer axis)."""
    jinit, tmodel = {
        "unet": (lambda k: junet.init(k, junet.TINY_CONFIG), lambda: _port_unet(tunet.TINY_CONFIG)),
        "dit": (lambda k: jdit.init(k, jdit.TINY_DIT),
                lambda: tdit.DiT(tdit.TINY_DIT, device="cpu", seed=None)),
        "mmdit": (lambda k: jmmdit.init(k, jmmdit.TINY_MMDIT_QKN),
                  lambda: tmmdit.MMDiT(tmmdit.TINY_MMDIT_QKN, device="cpu")),
        "t5": (lambda k: jt5.init(k, jt5.TINY_T5), lambda: tt5.T5Encoder(tt5.TINY_T5, device="cpu")),
        "controlnet": (lambda k: jcn.init(k, junet.TINY_CONFIG),
                       lambda: tcn.ControlNet(tunet.TINY_CONFIG, device="cpu", seed=None)),
    }[model]
    want = flat_specs(jparallel.tp_spec_tree(jax.eval_shape(jinit, jax.random.key(0))))
    got = {unstacked(k, () if model in ("unet", "controlnet") else ("blocks", "layers")): v
           for k, v in tparallel.tp_spec_tree(tmodel()).items()}
    assert set(got) == set(want)
    for k, s in want.items():
        assert got[k] == tuple(s), k


def test_qkv_and_proj_specs():
    specs = {unstacked(k): v for k, v in
             tparallel.tp_spec_tree(tdit.DiT(tdit.TINY_DIT, device="cpu", seed=None)).items()}
    assert specs["blocks.attn.qkv.weight"] == P(None, None, "model")
    assert specs["blocks.attn.qkv.bias"] == P(None, "model")
    assert specs["blocks.attn.proj.weight"] == P(None, "model", None)
    assert specs["blocks.attn.proj.bias"] == P()
    assert specs["blocks.mlp.fc1.weight"] == P(None, None, "model")
    assert specs["blocks.mlp.fc2.weight"] == P(None, "model", None)
    assert specs["final.proj.weight"] == P()


def test_unet_geglu_specs_unchanged():
    specs = tparallel.tp_spec_tree(_port_unet(tunet.TINY_CONFIG))
    ff = {k.split(".")[-2]: s for k, s in specs.items() if ".ff." in k and k.endswith("weight")}
    assert ff["proj"] == P(None, "model")
    assert ff["out"] == P("model", None)


@pytest.mark.parametrize("qdtype", ["int8", "int4"])
def test_quantized_specs_equal_jax(qdtype):
    """Quantized values and scales: replicated, as the JAX rule places them."""
    cfg = junet.TINY_CONFIG
    params = random_tree(lambda k: junet.init(k, cfg), 0)
    jq = jax.jit(lambda p: quantize_params(p, jnp.int8 if qdtype == "int8" else "int4"))(
        params)
    want = {k.replace(".weight.values", ".weight_values").replace(".weight.scales",
                                                                  ".weight_scales"): s
            for k, s in flat_specs(jparallel.tp_spec_tree(jq)).items()}
    model = _port_unet(tunet.TINY_CONFIG)
    load_params(model, params)
    tquantize_params(model, torch.int8 if qdtype == "int8" else "int4")
    got = tparallel.tp_spec_tree(model)
    quant = [k for k in got if "weight_" in k]
    assert quant and all(got[k] == () for k in quant)
    for k, s in got.items():
        if k in want:
            assert s == tuple(want[k]), k


def test_fsdp_specs_equal_jax(ranks):
    """The params' specs and an Adafactor state's (v_row, v_col and v, the
    rule on each statistic's own shape) against the JAX fsdp_spec_tree."""
    got = result(ranks, "fsdp_specs")
    want = ranks[1]["fsdp_specs"]
    assert set(got) == set(want)
    for tree, specs in want.items():
        assert set(got[tree]) == set(specs), tree
        for k, s in specs.items():
            assert got[tree][k] == tuple(s), (tree, k)
        assert any("data" in s for s in got[tree].values()), tree


# -- sharded forwards against the JAX dense ones ------------------------------------

@pytest.mark.parametrize("name", ["unet", "sdxl_unet", "dit", "mmdit", "mmdit_qkn",
                                  "mmdit_dryrun", "nondiv"])
def test_sharded_forward_matches_jax_dense(ranks, name):
    want = ranks[1][name]
    for r in range(WORLD):
        np.testing.assert_allclose(result(ranks, name, r)["out"], want, err_msg=f"rank {r}",
                                   **OUT)


def test_sharded_forwards_split_the_attention(ranks):
    split = result(ranks, "unet")["split"]
    roles = {k.split(".")[-1]: v[0] for k, v in split.items()}
    assert roles["to_q"] == "column" and roles["to_out"] == "row"
    assert roles["proj"] == "column" and roles["out"] == "row"
    assert all(parts == 2 for _, parts, _ in split.values())


def test_geglu_halves(ranks):
    """Rank r holds columns r I/2 ... (r+1) I/2 of gx and of gate."""
    up = ranks[2]["unet"][0]["params"]
    ff = up["input"][1][1]["blocks"][0]["ff"]["proj"]
    jw, jb = (np.asarray(ff[k], np.float32) for k in ("weight", "bias"))  # (C, 2I), (2I,)
    inner = jw.shape[1] // 2
    for r in range(WORLD):
        m = r % 2  # the model rank
        cols = np.r_[m * inner // 2:(m + 1) * inner // 2,
                     inner + m * inner // 2:inner + (m + 1) * inner // 2]
        got = result(ranks, "unet", r)
        np.testing.assert_array_equal(got["ff_proj"], jw[:, cols].T)
        np.testing.assert_array_equal(got["ff_proj_bias"], jb[cols])


def test_plain_column_geglu_cut_is_wrong(ranks):
    """The trap: cutting [gx | gate] as one column block gives rank 0 only
    gx columns; the result then leaves the dense one."""
    got = result(ranks, "unet_plain_column")["out"]
    assert not np.allclose(got, ranks[1]["unet_plain_column"], **OUT)


def test_nondividing_heads_stay_whole(ranks):
    """5 heads at level 0 (not split at model 2), 10 at level 1 (split)."""
    split = result(ranks, "nondiv")["split"]
    level0 = [k for k in split if k.startswith("input.1.1.") and ".attn" in k]
    level1 = [k for k in split if k.startswith("input.4.1.") and ".attn" in k]
    assert not level0 and level1
    assert any(k.startswith("input.1.1.") and ".ff." in k for k in split)


def test_text_towers(ranks):
    want, want_pooled = ranks[1]["clip"]
    got = result(ranks, "clip", 3)
    np.testing.assert_allclose(got["out"], want, **OUT)
    np.testing.assert_allclose(got["pooled"], want_pooled, **OUT)
    np.testing.assert_allclose(result(ranks, "t5", 3)["out"], ranks[1]["t5"], **OUT)


def test_t5_bias_cut_to_the_ranks_heads(ranks):
    table = np.asarray(ranks[2]["t5"][0]["params"]["rel_bias"]["weight"],
                       np.float32)  # (buckets, H)
    h = table.shape[1] // 2
    for r in range(WORLD):
        m = r % 2
        np.testing.assert_array_equal(result(ranks, "t5", r)["rel_bias"],
                                      table[:, m * h:(m + 1) * h])


def test_sharded_generate_matches_jax_dense(ranks):
    want = ranks[1]["generate"]
    for r in range(WORLD):
        got = result(ranks, "generate", r)["image"]
        assert got.dtype == np.uint8 and got.shape == want.shape == (4, 32, 32, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, r


# -- batches --------------------------------------------------------------------------

def test_shard_batch_rows(ranks):
    x = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    for r in range(WORLD):
        got = result(ranks, "batch", r)
        d = got["data_rank"]
        assert d == r // 2  # the model axis is innermost
        np.testing.assert_array_equal(got["rows"], x[2 * d:2 * d + 2])
        np.testing.assert_array_equal(got["mine"], got["rows"])


def test_make_global_batch_checks_sizes(ranks):
    for r in range(WORLD):
        assert "unequal" in result(ranks, "batch", r)["unequal"]


def test_shard_batch_without_mesh():
    got = ttrain.shard_batch([np.ones((4, 2), np.float32)])
    assert isinstance(got[0], torch.Tensor) and got[0].shape == (4, 2)


# -- train steps --------------------------------------------------------------------------

def test_noise_is_the_global_draw(ranks):
    """Each data rank's t and noise are its rows of the global batch's draw."""
    seen = {}

    def apply_fn(params, x_t, t, *cond):
        seen["t"], seen["x_t"] = t, x_t
        return x_t

    ttrain.step.diffusion_objective(apply_fn, ttrain.LossConfig(), {}, torch.zeros(4, 8, 8, 4),
                                    (), torch.Generator().manual_seed(21))
    got = result(ranks, "noise_rows")
    np.testing.assert_array_equal(got["t"], seen["t"].numpy())
    np.testing.assert_array_equal(got["x_t"], seen["x_t"].numpy())


def as_jax_leaves(params: dict, module) -> dict:
    """A port params dict -> {JAX path: array in the JAX layout}, the blocks
    of a container the JAX package stacks stacked on a leading axis."""
    layouts = ttrain.param_layouts(module)
    stacked = getattr(module, "STACKED", ())
    blocks: dict = {}
    for k, v in params.items():
        v = torch.from_numpy(v)
        v = (layouts[k].to_jax(v) if k in layouts else v).numpy()
        parts = k.split(".")
        i = next((int(p) for j, p in enumerate(parts) if j and parts[j - 1] in stacked), None)
        blocks.setdefault(unstacked(k, stacked), {})[i] = v
    return {k: b[None] if None in b else np.stack([b[i] for i in sorted(b)])
            for k, b in blocks.items()}


@pytest.mark.parametrize("name", ["train_dp_tp_sgd", "train_fsdp_sgd", "train_fsdp_adamw",
                                  "train_mmdit_qkn_sgd", "train_dp_tp_adafactor",
                                  "train_fsdp_adafactor", "train_fsdp4_adafactor",
                                  "train_mmdit_qkn_adafactor"])
def test_sharded_train_step_matches_jax_dense(ranks, name):
    """Every leaf on every rank, the replicated ones' copies included."""
    want_params, want_m = ranks[1][name]
    module = (tmmdit.MMDiT(tmmdit.TINY_MMDIT_QKN, device="cpu") if "mmdit" in name
              else _port_unet(tunet.UNetConfig(**TRAIN_KW)))
    for r in range(WORLD):
        got = result(ranks, name, r)
        np.testing.assert_allclose(got["loss"], want_m["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], want_m["grad_norm"], rtol=LOSS_RTOL)
        leaves = as_jax_leaves(got["params"], module)
        assert set(leaves) == set(want_params)
        for k, v in leaves.items():
            np.testing.assert_allclose(v, want_params[k], err_msg=f"{k} rank {r}", **PARAMS)


def test_tensor_parallel_step_needs_placements(ranks):
    """A step of a model shard_params split, on a state without placements,
    raises: it would clip by each rank's own norm of its slices."""
    for r in range(WORLD):
        got = result(ranks, "train_unplaced", r)["raised"]
        assert got and "placements" in got


def test_fsdp_splits_the_state(ranks):
    dp = result(ranks, "train_dp_tp_sgd")
    fsdp = result(ranks, "train_fsdp_sgd")
    assert fsdp["local_numel"] < dp["local_numel"]
    convs = [k for k, (_, d) in fsdp["split"].items() if "conv" in k and d is not None]
    assert convs  # the TP rules alone leave convs whole


def test_fsdp_splits_adafactor_statistics(ranks):
    """FSDP holds a rank's share of the Adafactor state over the data axis
    too (each statistic cut with its leaf), less than the TP step's."""
    dp = result(ranks, "train_dp_tp_adafactor")
    for name in ("train_fsdp_adafactor", "train_fsdp4_adafactor"):
        assert result(ranks, name)["state_bytes"] < dp["state_bytes"], name


def test_the_ranks_draw_their_rows_of_the_global_noise():
    """Under global_rows(r, n) a draw is rows r of the global batch's."""
    like = torch.zeros((2, 3, 3, 4))
    whole = tsamplers._normal(torch.Generator().manual_seed(5), torch.zeros((6, 3, 3, 4)))
    for r in range(3):
        with tsamplers.global_rows(r, 3):
            got = tsamplers._normal(torch.Generator().manual_seed(5), like)
        assert torch.equal(got, whole[2 * r:2 * r + 2])
    outside = tsamplers._normal(torch.Generator().manual_seed(5), like)
    assert outside.shape == like.shape  # outside: a draw of like's own shape


@pytest.mark.parametrize("name", ["gen_ancestral", "gen_control", "img2img_mesh",
                                  "inpaint_mesh", "hires_mesh", "sdxl_mesh", "sd3_mesh"])
def test_entry_points_on_a_mesh_match_jax_dense(ranks, name):
    """sd.generate with an ancestral sampler and with a ControlNet hint,
    img2img, inpaint, generate_hires, sdxl.generate and sd3.generate on
    (data 2, model 2), every draw replayed from the JAX dense call's
    global normals and drawn, within 1 of 255 of its images on every rank."""
    want = ranks[1][name]
    for r in range(WORLD):
        got = result(ranks, name, r)
        assert got["left"] == 0, (r, got["left"])
        img = got["image"]
        assert img.dtype == np.uint8 and img.shape == want.shape and img.shape[0] == 4
        assert np.abs(img.astype(int) - want.astype(int)).max() <= 1, r
    if name == "gen_control":  # the ControlNet's attention and FF split like the UNet's
        split = result(ranks, name)["cn_split"]
        assert any(k.endswith("attn1.to_q") for k in split)
        assert any(k.endswith("ff.proj") for k in split)
    if name == "inpaint_mesh":  # the kept pixels are the source's on every rank
        src = ranks[2][name][0]["image"]
        keep = np.broadcast_to(ranks[2][name][0]["mask"] <= 0.5, src.shape)
        np.testing.assert_array_equal(result(ranks, name)["image"][keep], src[keep])


# -- ring attention -------------------------------------------------------------------

def test_ring_attention_matches_full_attention(ranks):
    """(2, 64, 16) over a 4-way axis against the JAX sdpa_xla, on every rank;
    the ops.sdpa ring impl on the ambient mesh is the same call."""
    want = ranks[1]["ring"]["out"]
    for r in range(WORLD):
        got = result(ranks, "ring", r)
        np.testing.assert_allclose(got["out"], want, err_msg=f"rank {r}", **RING_OUT)
        np.testing.assert_array_equal(got["sdpa"], got["out"])


@pytest.mark.parametrize("which", ["odd", "two"])
def test_ring_attention_pads_a_sequence_that_does_not_divide(ranks, which):
    """61 tokens over 4 ranks (3 pad keys), and 2 tokens (two ranks' key
    chunks padding alone: p = 1 over zero values, merged with weight 0)."""
    want = ranks[1]["ring"][which]
    for r in range(WORLD):
        np.testing.assert_allclose(result(ranks, "ring", r)[which], want, **RING_OUT)


def test_ring_sdpa_packed_unpacks_and_packs_back(ranks):
    want = ranks[1]["ring"]["odd"]  # (1, 2, 61, 8)
    got = result(ranks, "ring")["packed"]  # (1, 61, 16)
    np.testing.assert_allclose(got.reshape(1, 61, 2, 8).transpose(0, 2, 1, 3), want,
                               **RING_OUT)


def test_ring_cross_shard_dependency(ranks):
    """A key on the last shard moves the first shard's rows."""
    got = result(ranks, "ring")
    assert not np.allclose(got["out"][0, :16], got["remote"][0, :16])


def test_ring_splits_the_sequence_in_ceil_chunks(ranks):
    """Rank r holds rows [r c, r c + c) of S, c = ceil(S / 4), cut at S: the
    JAX package's zero-pad to a multiple of the axis."""
    want = {64: [(0, 16), (16, 32), (32, 48), (48, 64)],
            61: [(0, 16), (16, 32), (32, 48), (48, 61)], 2: [(0, 1), (1, 2), (2, 2), (2, 2)]}
    for seq, rows in want.items():
        assert [tuple(result(ranks, "ring", r)["rows"][seq]) for r in range(WORLD)] == rows


def test_ring_self_attention_projects_its_own_rows(ranks):
    """Under "ring:model,data" each model rank's attn1 projects k (and q, v)
    for its half of the tokens only, the cross-attention's q all of them;
    without a ring attn1 takes all of them too."""
    for name, parts in (("unet_ring", 2), ("unet", 1)):
        rows = result(ranks, name)["rows"]
        whole = {k.rsplit(".attn2.", 1)[0]: n for k, n in rows.items() if k.endswith("attn2.to_q")}
        own = {k.rsplit(".attn1.", 1)[0]: n for k, n in rows.items() if k.endswith("attn1.to_k")}
        assert own.keys() == whole.keys() and own
        assert all(own[k] == -(-whole[k] // parts) for k in own), (name, own, whole)


def test_ring_refusals_and_the_ambient_mesh(ranks):
    got = result(ranks, "ring")
    assert "no mask and no kv_len" in got["kv_len_raised"]
    assert "no mesh" in got["no_mesh_raised"]
    assert got["ambient_after"]  # use_mesh restored on exit


def test_ambient_mesh_is_restored_after_an_exception():
    assert tparallel.current_mesh() is None
    with pytest.raises(KeyError):
        with tparallel.use_mesh("outer"):
            with tparallel.use_mesh("inner"):
                assert tparallel.current_mesh() == "inner"
                raise KeyError
    assert tparallel.current_mesh() is None


@pytest.mark.parametrize("name", ["unet_ring", "mmdit_ring"])
def test_ring_forward_matches_jax_dense(ranks, name):
    """The TINY UNet with self_attn_impl and the TINY MMDiT at 16 + 7 = 23
    joint tokens with attn_impl "ring:model,data", on (data 2, model 2),
    against the JAX dense forwards."""
    want = ranks[1][name]
    for r in range(WORLD):
        np.testing.assert_allclose(result(ranks, name, r)["out"], want, err_msg=f"rank {r}",
                                   **OUT)


def test_model_axis_ring_keeps_the_self_attention_whole(ranks):
    """Under a ring over the model axis each attn1 (and each MMDiT stream's
    qkv / proj) stays whole while attn2, the FF and the MLPs split; the
    specs stay the JAX ones."""
    split = result(ranks, "unet_ring")["split"]
    assert split and not [k for k in split if ".attn1." in k]
    assert [k for k in split if ".attn2." in k] and [k for k in split if ".ff." in k]
    msplit = result(ranks, "mmdit_ring")["split"]
    assert msplit and all("mlp." in k for k in msplit)
    ring = dataclasses.replace(tunet.TINY_CONFIG, self_attn_impl=RING)
    want = flat_specs(jparallel.tp_spec_tree(jax.eval_shape(
        lambda k: junet.init(k, junet.TINY_CONFIG), jax.random.key(0))))
    got = tparallel.tp_spec_tree(_port_unet(ring))
    assert got.keys() == want.keys()
    for k, s in want.items():
        assert got[k] == tuple(s), k


def test_sharded_generate_with_a_ring_matches_jax_dense(ranks):
    want = ranks[1]["generate_ring"]
    for r in range(WORLD):
        got = result(ranks, "generate_ring", r)["image"]
        assert got.shape == want.shape == (4, 32, 32, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, r


# -- the pipeline -----------------------------------------------------------------------

@pytest.mark.parametrize("stages, microbatches", PIPE_STACK)
def test_pipeline_linear_stack_matches_scan(ranks, stages, microbatches):
    name = f"pipe_{stages}_{microbatches}"
    for r in range(WORLD):
        np.testing.assert_allclose(result(ranks, name, r)["out"], ranks[1][name],
                                   atol=1e-6, rtol=1e-6)


def test_pipeline_carry_pytree_and_passthrough_cond(ranks):
    cond = ranks[2]["pipe_carry"][0]["cond"]
    for r in range(WORLD):
        got = result(ranks, "pipe_carry", r)
        np.testing.assert_allclose(got["out"], ranks[1]["pipe_carry"], atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(got["cond"], cond)


def test_mmdit_pipeline_matches_jax_scan(ranks):
    """The TINY MMDiT (2 blocks) over two two-stage pipes, 2 microbatches."""
    for r in range(WORLD):
        np.testing.assert_allclose(result(ranks, "mmdit_pipe", r)["out"], ranks[1]["mmdit_pipe"],
                                   atol=1e-5, rtol=1e-5)


def test_pipe_mesh_places_one_stage_of_blocks_per_rank(ranks):
    """shard_params over a pipe axis of 2 keeps block s on stage s and frees
    the other: each rank holds half of the stack's parameters."""
    for r in range(WORLD):
        got = result(ranks, "mmdit_pipe", r)
        assert got["held"] == [got["stage"]]
        assert 2 * got["held_params"] == sum(got["block_params"])
    assert sorted(result(ranks, "mmdit_pipe", r)["stage"] for r in range(WORLD)) == [0, 0, 1, 1]


def test_pipeline_refusals(ranks):
    got = result(ranks, "pipe_raises")
    assert "not divisible by microbatches" in got["batch"]
    assert "do not split over 2 pipeline stages" in got["depth"]
    assert "placed on another stage" in got["elsewhere"]


# -- the serving engine on a mesh ----------------------------------------------------------

def _close_to_jax_engine(images, want):
    assert images.keys() == want.keys() == {0, 1, 2}
    for rid in want:
        assert images[rid].shape == (32, 32, 3) and images[rid].dtype == np.uint8
        diff = np.abs(images[rid].astype(np.int16) - want[rid].astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.02, (rid, diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("name", ["serve_mesh", "serve_subgroup"])
def test_sharded_engine_matches_the_jax_engine(ranks, name):
    """(data 2, model 2) over the four ranks, and (data 2, model 1) over two
    ranks (two such engines at once), against the JAX one-device engine."""
    _close_to_jax_engine(result(ranks, name)["images"], ranks[1][name])


@pytest.mark.parametrize("name", ["serve_mesh", "serve_subgroup"])
def test_sharded_engine_images_bit_equal_on_every_rank(ranks, name):
    first = result(ranks, name)["images"]
    for r in range(1, WORLD):
        got = result(ranks, name, r)["images"]
        assert got.keys() == first.keys()
        for rid in first:
            np.testing.assert_array_equal(got[rid], first[rid], err_msg=f"rank {r}")
    if name == "serve_subgroup":
        assert [result(ranks, name, r)["ranks"] for r in range(WORLD)] == [[0, 1]] * 2 + [[2, 3]] * 2


@pytest.mark.parametrize("name", ["serve_mesh", "serve_subgroup"])
def test_sharded_engine_steps_eagerly(ranks, name):
    """A mesh engine's step runs collectives, which no CUDA graph holds: it
    captures none, and runs eagerly construction's probe and each tick in
    which one of the rank's own slots is active."""
    for r in range(WORLD):
        got = result(ranks, name, r)
        core = tengine._PySchedulerCore(4)
        for i, n in enumerate(SERVE_STEPS):
            core.submit(i, n)
        ticks = 0
        while core.active() or core.pending():
            core.assign()
            ticks += any(core.remaining(s) > 0 for s in got["slots"])
            core.tick()
        assert got["steps"] == {"graph_steps": 0, "eager_steps": 1 + ticks}, f"rank {r}"


def test_router_over_a_sharded_and_a_local_engine(ranks):
    first = result(ranks, "serve_mesh")
    assert sorted(first["routed"]) == sorted(first["rids"])
    for r in range(WORLD):
        got = result(ranks, "serve_mesh", r)
        assert got["health"]["big"]["failures"] == got["health"]["small"]["failures"] == 0
        for rid, img in first["routed"].items():
            np.testing.assert_array_equal(got["routed"][rid], img, err_msg=f"rank {r}")


def test_lockstep_only_on_a_mesh_or_beside_one(ranks):
    """A local engine in a process group of four ranks hands decodes out by
    event; a Router beside a sharded engine puts it in step."""
    for r in range(WORLD):
        assert result(ranks, "serve_mesh", r)["lockstep"] == {
            "mesh": True, "local": False, "local_under_router": True}


def test_engine_slots_must_divide_over_the_data_axis(ranks):
    assert "does not divide" in result(ranks, "serve_mesh")["slots_raised"]
