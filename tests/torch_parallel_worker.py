"""One rank of tests/test_torch_parallel.py's gloo group.

``run(rank, world, store, cases, outdir)`` joins a ``world``-rank gloo
group through the file store ``store``, builds the (data, model) mesh on
the CPU and runs every case of ``cases`` [(name, kwargs)] in order, each a
function of this module on numpy inputs made by the test from a seed (the
JAX package's params as numpy trees, loaded through io/from_jax). It
pickles {name: result} to ``<outdir>/rank<rank>.pkl``; a case that raises
gives ("error", traceback) in place of its result, so one case fails its
own test only.

This module imports torch and the port only: the test spawns the ranks,
and a child importing the test module would import JAX.
"""
import datetime
import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tinyfusers_tpu_torch import parallel, train  # noqa: E402
from tinyfusers_tpu_torch.io.from_jax import load_params, load_sd  # noqa: E402
from tinyfusers_tpu_torch.models import clip, dit, mmdit, t5, unet  # noqa: E402
from tinyfusers_tpu_torch.models.layers import set_trainable  # noqa: E402
from tinyfusers_tpu_torch.parallel import sharding  # noqa: E402
from tinyfusers_tpu_torch.pipeline import samplers, sd  # noqa: E402
from tinyfusers_tpu_torch.train import losses, optim  # noqa: E402

MESH = None


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rows(*xs):
    """This rank's rows of global batches, on the mesh's device."""
    return train.shard_batch([np.asarray(x) for x in xs], MESH)


def _global(y: torch.Tensor) -> np.ndarray:
    """Every data rank's rows of y, in order."""
    n, _, group = parallel.mesh.axis(MESH, parallel.DATA_AXIS)
    return parallel.tp.all_gather(y.contiguous(), group, dim=0).numpy()


def _sharded(module):
    return parallel.shard_params(module, MESH)


# -- cases -----------------------------------------------------------------------

def mesh_axes():
    mesh = parallel.distributed.hybrid_mesh(model=2, device_type="cpu")
    return {"mesh": dict(zip(MESH.mesh_dim_names, MESH.shape)),
            "hybrid": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "initialize_again": parallel.distributed.initialize()}


def sync_decision():
    rank = dist.get_rank()
    got = parallel.distributed.sync_decision(
        {"admit": torch.tensor([7.0 + rank]), "seed": 100 + rank, "ids": [rank, rank]})
    return {"admit": got["admit"].numpy(), "seed": got["seed"], "ids": got["ids"]}


def unet_forward(cfg, params, x, t, ctx, adm=None, plain_geglu_column=False):
    model = unet.UNet(cfg, device="cpu")
    load_params(model, params)
    if plain_geglu_column:  # the trap: [gx | gate] cut as one column block
        units = sharding._units

        def plain(module):
            out = units(module)
            for _, members in out.values():
                for m in members:
                    m.halves = False
            return out

        sharding._units = plain
        try:
            _sharded(model)
        finally:
            sharding._units = units
    else:
        _sharded(model)
    args = _rows(x, t, ctx) + (() if adm is None else _rows(adm))
    with torch.no_grad():
        y = unet.apply(model, *args[:3], adm_cond=args[3] if adm is not None else None)
    split = {name: (m.tp_role, dist.get_world_size(m.tp_group), tuple(m.weight.shape))
             for name, m in model.named_modules() if getattr(m, "tp_role", None)}
    ff = next(m for name, m in model.named_modules() if name.endswith("ff.proj"))
    return {"out": _global(y), "split": split, "ff_proj": ff.weight.detach().numpy(),
            "ff_proj_bias": ff.bias.detach().numpy()}


def dit_forward(cfg, params, x, t):
    model = dit.DiT(cfg, device="cpu", seed=None)
    load_params(model, params)
    _sharded(model)
    with torch.no_grad():
        return {"out": _global(dit.apply(model, *_rows(x, t)))}


def mmdit_forward(cfg, params, x, t, ctx, pooled):
    model = mmdit.MMDiT(cfg, device="cpu")
    load_params(model, params)
    _sharded(model)
    with torch.no_grad():
        return {"out": _global(mmdit.apply(model, *_rows(x, t, ctx, pooled)))}


def clip_forward(cfg, params, ids):
    model = clip.CLIPTextModel(cfg, device="cpu")
    load_params(model, params)
    _sharded(model)
    with torch.no_grad():
        return {"out": _global(clip.apply(model, *_rows(ids))),
                "pooled": _global(clip.apply_pooled(model, *_rows(ids)))}


def t5_forward(cfg, params, ids):
    model = t5.T5Encoder(cfg, device="cpu")
    load_params(model, params)
    _sharded(model)
    with torch.no_grad():
        y = t5.apply(model, *_rows(ids))
    return {"out": _global(y), "rel_bias": model.rel_bias.weight.detach().numpy(),
            "q": model.layers[0].attn.q.weight.detach().numpy()}


def sd_generate(cfg, params, ids, uids, latent, steps):
    model = sd.StableDiffusion(cfg, device="cpu", seed=None)
    load_sd(model, params)
    _sharded(model)
    img = sd.generate(model, _t(ids), _t(uids), _t(latent), 7.5, num_steps=steps, mesh=MESH)
    return {"image": img.numpy()}


def batch_rows(x):
    rows = train.shard_batch([x], MESH)[0]
    mine = train.make_global_batch([rows], MESH)[0]
    rank = dist.get_rank()
    try:  # a rank holding one more row
        train.make_global_batch([x[:2 + (rank == 3)]], MESH)
        unequal = None
    except ValueError as e:
        unequal = str(e)
    return {"rows": rows.numpy(), "mine": mine.numpy(), "unequal": unequal,
            "data_rank": MESH.get_local_rank(parallel.DATA_AXIS)}


def noise_rows(shape, seed):
    """The t and noise the loss of this rank's rows draws."""
    seen = {}

    def apply_fn(params, x_t, t, *cond):
        seen["t"], seen["x_t"] = t, x_t
        return x_t

    x0 = torch.zeros(shape)
    n, r, _ = parallel.mesh.axis(MESH, parallel.DATA_AXIS)
    b = shape[0] // n
    train.step.diffusion_objective(apply_fn, losses.LossConfig(), {}, x0[r * b:(r + 1) * b],
                                   (), torch.Generator().manual_seed(seed), rows=(r, n))
    return {"t": _global(seen["t"]), "x_t": _global(seen["x_t"])}


def _optimizer(name):
    if isinstance(name, tuple):  # ("sgd", rate)
        return optim.sgd(name[1])
    if name == "sgd":
        return optim.sgd(1e-2)
    if name == "adamw":
        return train.default_optimizer(1e-3)
    return optim.adafactor(1e-3)


def _trainee(cfg, params):
    """The port's UNet or MMDiT of ``cfg``, loaded with ``params``."""
    if isinstance(cfg, mmdit.MMDiTConfig):
        model = mmdit.MMDiT(cfg, device="cpu")
    else:
        model = unet.UNet(cfg, device="cpu")
    load_params(model, params)
    return model


def train_step(cfg, params, x0, cond, draws, opt, fsdp_min_size=None, objective="eps"):
    """One sharded step with the JAX step's global t and noise replayed:
    the draws of a rank that took its own rows' worth would be rows 0..b.
    cond: the conditioning arrays after x0 (context, and MMDiT's pooled)."""
    t_all, n_all = (_t(d) for d in draws)
    losses_mod, samplers_mod = losses.sample_timesteps, samplers._normal
    losses.sample_timesteps = lambda gen, n, cfg_, device=None: t_all[:n].to(device)
    samplers._normal = lambda gen, like: n_all[:like.shape[0]].to(like.device)
    try:
        model = set_trainable(_sharded(_trainee(cfg, params)))
        tx = _optimizer(opt)
        state = train.TrainState.create(train.params_of(model, trainable_only=True), tx,
                                        placements=parallel.sharding_tree(model, MESH))
        if fsdp_min_size is not None:
            state = parallel.shard_fsdp(state, MESH, min_size=fsdp_min_size)
        step = train.make_train_step(train.module_apply(model), tx,
                                     losses.LossConfig(objective=objective))
        state, m = step(state, _rows(x0, *cond), torch.Generator())
    finally:
        losses.sample_timesteps, samplers._normal = losses_mod, samplers_mod
    whole = parallel.unshard(state.params, state.placements)
    split = {k: (pl.model_dim, pl.data_dim) for k, pl in state.placements.items()}
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": {k: v.numpy() for k, v in whole.items()}, "split": split,
            "local_numel": sum(v.numel() for v in state.params.values())}


def fsdp_specs(cfg, params):
    model = unet.UNet(cfg, device="cpu")
    load_params(model, params)
    _sharded(model)
    return parallel.fsdp_spec_tree(train.params_of(model), MESH,
                                   placements=parallel.sharding_tree(model, MESH), min_size=1)


def train_adafactor(cfg, params, x0, ctx):
    try:
        train_step(cfg, params, x0, (ctx,), (np.zeros(4, np.int32), np.zeros_like(x0)),
                   "adafactor")
    except optim.ShardedLeafError as e:
        return {"raised": str(e)}
    return {"raised": None}


def train_unplaced(cfg, params, x0, ctx):
    """A tensor-parallel model's step on a state made without placements."""
    model = set_trainable(_sharded(_trainee(cfg, params)))
    tx = optim.sgd(1e-2)
    state = train.TrainState.create(train.params_of(model, trainable_only=True), tx)
    step = train.make_train_step(train.module_apply(model), tx)
    try:
        step(state, _rows(x0, ctx), torch.Generator())
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


# -- the rank ---------------------------------------------------------------------

def run(rank, world, store, cases, outdir):
    global MESH
    # the ranks yield the CPU to the suite's other workers (whose JAX tests
    # run collectives between virtual devices under a rendezvous timeout)
    os.nice(10)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    MESH = parallel.make_mesh(model=2, device_type="cpu")
    results = {}
    for name, kw in cases:
        fn = globals()[kw.pop("case", name)]
        try:
            results[name] = fn(**kw)
        except Exception:  # noqa: BLE001  (reported by the case's test)
            results[name] = ("error", traceback.format_exc())
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()
