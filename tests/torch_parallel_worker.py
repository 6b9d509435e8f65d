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
import contextlib
import dataclasses
import datetime
import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tinyfusers_tpu_torch import ops, parallel, train  # noqa: E402
from tinyfusers_tpu_torch.io.from_jax import (load_params, load_sd, load_sd3,  # noqa: E402
                                              load_sdxl)
from tinyfusers_tpu_torch.models import clip, controlnet, dit, mmdit, t5, unet  # noqa: E402
from tinyfusers_tpu_torch.models.layers import set_trainable  # noqa: E402
from tinyfusers_tpu_torch.parallel import sharding  # noqa: E402
from tinyfusers_tpu_torch.pipeline import samplers, sd, sd3, sdxl  # noqa: E402
from tinyfusers_tpu_torch.serve import Engine, Router  # noqa: E402
from tinyfusers_tpu_torch.train import losses, optim  # noqa: E402

MESH = None


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rows(*xs, mesh=None):
    """This rank's rows of global batches, on the mesh's device."""
    return train.shard_batch([np.asarray(x) for x in xs], mesh or MESH)


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
    # the sequence rows each self-attention's k projection and each
    # cross-attention's q projection take
    rows = {}

    def seen(name):
        def hook(mod, inp):
            rows.setdefault(name, inp[0].shape[1])
        return hook

    hooks = [m.register_forward_pre_hook(seen(name)) for name, m in model.named_modules()
             if name.endswith(("attn1.to_k", "attn2.to_q"))]
    with torch.no_grad(), parallel.use_mesh(MESH):  # the mesh of a ring self-attention
        y = unet.apply(model, *args[:3], adm_cond=args[3] if adm is not None else None)
    for h in hooks:
        h.remove()
    split = {name: (m.tp_role, dist.get_world_size(m.tp_group), tuple(m.weight.shape))
             for name, m in model.named_modules() if getattr(m, "tp_role", None)}
    ff = next(m for name, m in model.named_modules() if name.endswith("ff.proj"))
    return {"out": _global(y), "split": split, "ff_proj": ff.weight.detach().numpy(),
            "ff_proj_bias": ff.bias.detach().numpy(), "rows": rows}


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
    with torch.no_grad(), parallel.use_mesh(MESH):  # the mesh of a ring attention
        y = mmdit.apply(model, *_rows(x, t, ctx, pooled))
    split = sorted(name for name, m in model.named_modules() if getattr(m, "tp_role", None))
    return {"out": _global(y), "split": split}


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


@contextlib.contextmanager
def _draws(noises):
    """samplers._draw returns ``noises`` (the JAX dense call's global
    normals) in order; yields the list of those not drawn yet."""
    queue = [np.asarray(x) for x in noises]
    real = samplers._draw

    def draw(generator, shape, device):
        x = queue.pop(0)
        if tuple(shape) != x.shape:
            raise ValueError(f"a draw of {tuple(shape)} where the dense call drew {x.shape}")
        return _t(x).to(device)

    samplers._draw = draw
    try:
        yield queue
    finally:
        samplers._draw = real


def sd_mesh(kind, cfg, params, ids, uids, latent=None, noises=(), image=None, mask=None,
            control=None, kw=None):
    """An SD entry point on the mesh (``kind``: generate, img2img, inpaint,
    hires), its generator's draws replayed from the JAX dense call's; with
    ``control`` (JAX ControlNet params, hint, scale) a ControlNet split by
    shard_params as the UNet is."""
    model = sd.StableDiffusion(cfg, device="cpu", seed=None)
    load_sd(model, params)
    _sharded(model)
    kw, out, gen = dict(kw or {}), {}, torch.Generator()
    with _draws(noises) as left:
        if kind == "generate":
            if control is not None:
                cparams, hint, scale = control
                cn = controlnet.ControlNet(cfg.unet, device="cpu", seed=None)
                load_params(cn, cparams)
                _sharded(cn)
                out["cn_split"] = sorted(n for n, m in cn.named_modules()
                                         if getattr(m, "tp_role", None))
                kw["control"] = (cn, _t(hint), scale)
            img = sd.generate(model, _t(ids), _t(uids), _t(latent), 7.5, generator=gen,
                              mesh=MESH, **kw)
        elif kind == "img2img":
            img = sd.img2img(model, _t(image), _t(ids), _t(uids), gen, 7.5, mesh=MESH, **kw)
        elif kind == "inpaint":
            img = sd.inpaint(model, _t(image), _t(mask), _t(ids), _t(uids), _t(latent), 7.5,
                             mesh=MESH, **kw)
        else:
            img = sd.generate_hires(model, _t(ids), _t(uids), _t(latent), gen, 7.5, mesh=MESH,
                                    **kw)
    out.update(image=img.numpy(), left=len(left))
    return out


def sdxl_mesh(cfg, params, ids, uids, latent, noises, steps):
    """sdxl.generate on the mesh, euler_ancestral with the JAX draws."""
    model = sdxl.StableDiffusionXL(cfg, device="cpu", seed=None)
    load_sdxl(model, params)
    _sharded(model)
    with _draws(noises) as left:
        img = sdxl.generate(model, *(_t(a).long() for a in (*ids, *uids)), _t(latent), 7.5,
                            num_steps=steps, method="euler_ancestral",
                            generator=torch.Generator(), mesh=MESH)
    return {"image": img.numpy(), "left": len(left)}


def sd3_mesh(cfg, params, ids, latent, steps):
    model = sd3.StableDiffusion3(cfg, device="cpu", seed=None)
    load_sd3(model, params)
    _sharded(model)
    img = sd3.generate(model, *(_t(a) for a in ids), _t(latent), 5.0, num_steps=steps,
                       mesh=MESH)
    return {"image": img.numpy(), "left": 0}


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


def _optimizer(name, model):
    if isinstance(name, tuple) and name[0] == "adafactor":  # (.., rate, min dim to factor)
        return optim.adafactor(name[1], min_dim_size_to_factor=name[2],
                               layouts=train.param_layouts(model))
    if isinstance(name, tuple):  # ("sgd", rate)
        return optim.sgd(name[1])
    if name == "sgd":
        return optim.sgd(1e-2)
    return train.default_optimizer(1e-3)


def _trainee(cfg, params):
    """The port's UNet or MMDiT of ``cfg``, loaded with ``params``."""
    if isinstance(cfg, mmdit.MMDiTConfig):
        model = mmdit.MMDiT(cfg, device="cpu")
    else:
        model = unet.UNet(cfg, device="cpu")
    load_params(model, params)
    return model


def train_step(cfg, params, x0, cond, draws, opt, fsdp_min_size=None, objective="eps",
               mesh_shape=None, steps=1):
    """``steps`` sharded steps on one batch with the JAX step's global t
    and noise replayed: the draws of a rank that took its own rows' worth
    would be rows 0..b. cond: the conditioning arrays after x0 (context,
    and MMDiT's pooled); mesh_shape: (data, model) of a mesh of its own,
    else the module's."""
    mesh = MESH if mesh_shape is None else parallel.make_mesh(
        data=mesh_shape[0], model=mesh_shape[1], device_type="cpu")
    t_all, n_all = (_t(d) for d in draws)
    losses_mod, samplers_mod = losses.sample_timesteps, samplers._normal
    losses.sample_timesteps = lambda gen, n, cfg_, device=None: t_all[:n].to(device)
    samplers._normal = lambda gen, like: n_all[:like.shape[0]].to(like.device)
    try:
        model = set_trainable(parallel.shard_params(_trainee(cfg, params), mesh))
        tx = _optimizer(opt, model)
        state = train.TrainState.create(train.params_of(model, trainable_only=True), tx,
                                        placements=parallel.sharding_tree(model, mesh))
        if fsdp_min_size is not None:
            state = parallel.shard_fsdp(state, mesh, min_size=fsdp_min_size)
        state_bytes = optim.state_bytes(state.opt_state)
        step = train.make_train_step(train.module_apply(model), tx,
                                     losses.LossConfig(objective=objective))
        for _ in range(steps):
            state, m = step(state, _rows(x0, *cond, mesh=mesh), torch.Generator())
    finally:
        losses.sample_timesteps, samplers._normal = losses_mod, samplers_mod
    whole = parallel.unshard(state.params, state.placements)
    split = {k: (pl.model_dim, pl.data_dim) for k, pl in state.placements.items()}
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": {k: v.numpy() for k, v in whole.items()}, "split": split,
            "local_numel": sum(v.numel() for v in state.params.values()),
            "state_bytes": state_bytes}


def fsdp_specs(cfg, params):
    """The FSDP specs of a TrainState of the TINY UNet's params with an
    Adafactor state (factored from 8 wide) on it."""
    model = unet.UNet(cfg, device="cpu")
    load_params(model, params)
    _sharded(model)
    state = train.TrainState.create(train.params_of(model), _optimizer(("adafactor", 1e-3, 8),
                                                                       model),
                                    placements=parallel.sharding_tree(model, MESH))
    specs = parallel.fsdp_spec_tree(state, MESH, min_size=1)
    stats = specs["opt_state"][0]
    return {"params": specs["params"], "v_row": stats.v_row, "v_col": stats.v_col,
            "v": stats.v}


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


# -- ring attention -----------------------------------------------------------------

def ring_cases(q, k, v, k_remote, q_odd, k_odd, v_odd):
    """The sequence over a 4-way data axis (data 4, model 1): ring_attention
    whole and with a remote key moved, through ops.sdpa / sdpa_packed's
    ring impl on the ambient mesh, and at sequences that do not divide (61
    tokens, and 2, where two ranks' key chunks are padding alone)."""
    mesh = parallel.make_mesh(data=4, model=1, device_type="cpu")
    ra = parallel.ring_attention
    q, k, v, k_remote, q_odd, k_odd, v_odd = map(_t, (q, k, v, k_remote, q_odd, k_odd, v_odd))
    out = {"out": ra.ring_attention(q, k, v, mesh=mesh, axis="data").numpy(),
           "remote": ra.ring_attention(q, k_remote, v, mesh=mesh, axis="data").numpy(),
           "odd": ra.ring_attention(q_odd, k_odd, v_odd, mesh=mesh, axis="data").numpy(),
           "two": ra.ring_attention(q_odd[..., :2, :], k_odd[..., :2, :], v_odd[..., :2, :],
                                    mesh=mesh, axis="data").numpy()}
    with parallel.use_mesh(mesh):
        out["sdpa"] = ops.sdpa(q, k, v, impl="ring:data").numpy()
        b, h, s_, d = q_odd.shape
        pack = lambda x: x.transpose(1, 2).reshape(b, s_, h * d)  # noqa: E731
        out["packed"] = ops.sdpa_packed(pack(q_odd), pack(k_odd), pack(v_odd), heads=h,
                                        impl="ring:data").numpy()
        try:
            ops.sdpa(q, k, v, impl="ring:data", kv_len=32)
        except ValueError as e:
            out["kv_len_raised"] = str(e)
    out["ambient_after"] = parallel.current_mesh() is None
    out["rows"] = {seq: (lambda sp: (sp.lo, sp.hi))(ra.split_sequence(seq, mesh=mesh, axis="data"))
                   for seq in (64, 61, 2)}
    try:
        ra.ring_attention(q, k, v)
    except ValueError as e:
        out["no_mesh_raised"] = str(e)
    return out


# -- the pipeline -----------------------------------------------------------------------

def _pipe_mesh(stages):
    """stages 4: one four-stage pipe; 2: two two-stage pipes (data 2)."""
    return parallel.make_mesh(data=4 // stages, pipe=stages, device_type="cpu")


def pipe_linear(ws, bs, x, stages, microbatches):
    blocks = [{"w": _t(w), "b": _t(b)} for w, b in zip(ws, bs)]
    got = parallel.pipeline_apply(lambda lp, c: torch.tanh(c @ lp["w"] + lp["b"]), blocks,
                                  _t(x), mesh=_pipe_mesh(stages), microbatches=microbatches)
    return {"out": got.numpy()}


def pipe_carry(ws, x, cond):
    def blk(lp, carry):
        h, c = carry
        return torch.tanh(h @ lp + c), c

    with parallel.use_mesh(_pipe_mesh(4)):  # the ambient mesh
        h, c = parallel.pipeline_apply(blk, list(_t(ws)), (_t(x), _t(cond)), microbatches=2)
    return {"out": h.numpy(), "cond": c.numpy()}


def pipe_mmdit(cfg, params, x, t, ctx, pooled):
    """The MMDiT placed over two two-stage pipes (shard_params keeps this
    stage's blocks) and run pipelined."""
    model = mmdit.MMDiT(dataclasses.replace(cfg, pipeline_microbatches=2), device="cpu")
    load_params(model, params)
    whole = [sum(p.numel() for p in b.parameters()) for b in model.blocks]
    mesh = _pipe_mesh(2)
    parallel.shard_params(model, mesh)
    with torch.no_grad(), parallel.use_mesh(mesh):
        y = mmdit.apply(model, *map(_t, (x, t, ctx, pooled)))
    return {"out": y.numpy(), "stage": mesh.get_local_rank(parallel.PIPE_AXIS),
            "held": [i for i, b in enumerate(model.blocks)
                     if not isinstance(b, parallel.pipeline.Elsewhere)],
            "held_params": sum(p.numel() for p in model.blocks.parameters()),
            "block_params": whole}


def pipe_raises(x):
    out = {}
    mesh = _pipe_mesh(2)
    blocks = [torch.eye(x.shape[1])] * 2
    for name, kw in (("batch", dict(blocks=blocks, microbatches=2)),
                     ("depth", dict(blocks=blocks + blocks[:1], microbatches=1))):
        try:
            parallel.pipeline_apply(lambda w, c: c @ w, kw["blocks"], _t(x)[:3], mesh=mesh,
                                    microbatches=kw["microbatches"])
        except ValueError as e:
            out[name] = str(e)
    try:  # blocks placed for other stages
        parallel.pipeline_apply(lambda w, c: c @ w, [parallel.pipeline.Elsewhere(1),
                                                     parallel.pipeline.Elsewhere(0)],
                                _t(x), mesh=mesh, microbatches=2)
    except ValueError as e:
        out["elsewhere"] = str(e)
    return out


# -- the serving engine --------------------------------------------------------------

def _served(mesh, cfg, params, latents, ids, uids, steps, slots=4):
    """{request id: image} of the engine over ``mesh`` (its model split
    over the mesh's model axis), the requests' initial latents replayed
    from ``latents`` {seed: array}."""
    model = sd.StableDiffusion(cfg, device="cpu", seed=None)
    load_sd(model, params)
    parallel.shard_params(model, mesh)
    real = sd.initial_latent
    sd.initial_latent = lambda seed, batch, cfg, device, dtype: _t(latents[seed])[None].to(
        device, dtype)
    try:
        eng = Engine(model, num_slots=slots, mesh=mesh)
        for i, n in enumerate(steps):
            eng.submit(eng.make_request(ids, uids, num_steps=n, guidance=5.0, seed=i))
        images = {r.request_id: r.image for r in eng.run_until_idle()}
    finally:
        sd.initial_latent = real
    return eng, images


def _steps(eng):
    """How the engine ran its slot steps, and the slots this rank holds."""
    return {"steps": {k: eng.stats[k] for k in ("graph_steps", "eager_steps")},
            "slots": list(range(eng._first, eng._first + eng.local_slots))}


def serve_mesh(cfg, params, latents, ids, uids, steps):
    """The engine on the (data 2, model 2) mesh, then a Router over it and
    a local one-slot engine."""
    eng, images = _served(MESH, cfg, params, latents, ids, uids, steps)
    steps = _steps(eng)
    eng.reset()
    local_model = sd.StableDiffusion(cfg, device="cpu", seed=None)
    load_sd(local_model, params)
    small = Engine(local_model, num_slots=1)
    lockstep = {"mesh": eng.lockstep, "local": small.lockstep}
    router = Router({"big": eng, "small": small})
    lockstep["local_under_router"] = small.lockstep
    rids = [router.submit("big" if i % 2 == 0 else "small", ids, uids, num_steps=2,
                          seed=10 + i) for i in range(3)]
    routed = {r.request_id: r.image for r in router.run_until_idle()}
    try:
        Engine(local_model, num_slots=3, mesh=MESH)
        slots_raised = None
    except ValueError as e:
        slots_raised = str(e)
    return {"images": images, "routed": routed, "rids": rids, "health": router.health(),
            "slots_raised": slots_raised, "lockstep": lockstep, **steps}


def serve_subgroup(cfg, params, latents, ids, uids, steps):
    """Two engines at once, each on a (data 2, model 1) mesh of two ranks:
    ranks 0 and 1, ranks 2 and 3."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("replica", parallel.DATA_AXIS,
                                                                parallel.MODEL_AXIS))
    sub = mesh[parallel.DATA_AXIS, parallel.MODEL_AXIS]
    eng, images = _served(sub, cfg, params, latents, ids, uids, steps)
    return {"images": images, "ranks": sub.mesh.flatten().tolist(), **_steps(eng)}


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
