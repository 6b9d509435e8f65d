"""The port's serving path (serve/engine.py, serve/router.py,
examples/serve_demo_torch.py) against the JAX package's on the CPU, at
TINY in fp32.

- Scheduler cores: the port's Python and native (native/scheduler.cpp
  through the port's libtfnative) cores give the JAX Python core's answer
  to every call, on fixed sequences and on derandomised hypothesis ones.
- ``Engine._slot_step`` within 1e-5 of ``jax.jit`` of the JAX one (one
  UNet apply at the models' fp32 tolerance, then the fp32 DDIM update).
- Images: three requests over two slots, one joining mid-flight, from the
  same weights, ids and initial latents (the JAX engine's
  ``jax.random.normal`` latents replayed into the port's): within 1 uint8
  level of the JAX engine's, under 1% of the pixels differing.
- The rest: the JAX package's TestEngine / TestRouter cases on the port's
  engine, its refusals, and the demo.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from tinyfusers_tpu.pipeline import ddim as jddim
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu.serve import engine as jengine
from tinyfusers_tpu_torch.native import get_lib
from tinyfusers_tpu_torch.pipeline import ddim as tddim
from tinyfusers_tpu_torch.pipeline import sd as tsd
from tinyfusers_tpu_torch.serve import Engine, Router, make_scheduler_core
from tinyfusers_tpu_torch.serve import engine as tengine

from torch_parity import few_torch_threads, tiny_sd  # noqa: F401


# -- scheduler cores ---------------------------------------------------------

@pytest.fixture(params=["python", "native"])
def make_core(request):
    if request.param == "python":
        return tengine._PySchedulerCore
    if get_lib() is None:
        pytest.skip("libtfnative could not be built (no g++)")
    return lambda n: make_scheduler_core(n, prefer_native=True)


def _answers(core, ops, slots):
    """Every answer of ``core`` to ``ops``: each call's result, then the
    active and pending counts and every slot's remaining steps."""
    out = []
    for op in ops:
        out.append(core.submit(*op[1:]) if op[0] == "submit" else getattr(core, op[0])())
        out.append((core.active(), core.pending(), [core.remaining(s) for s in range(slots)]))
    return out


FIFO = [("submit", 10, 3), ("submit", 11, 1), ("submit", 12, 2), ("assign",), ("tick",),
        ("assign",), ("tick",), ("tick",), ("assign",), ("tick",)]
REMAINING = [("submit", 5, 4), ("assign",), ("tick",), ("tick",), ("submit", 6, 1),
             ("tick",), ("assign",), ("tick",), ("tick",)]


@pytest.mark.parametrize("ops, slots", [(FIFO, 2), (REMAINING, 1)], ids=["fifo", "remaining"])
def test_scheduler_core_equals_the_jax_core(make_core, ops, slots):
    """The sequences of the JAX package's TestSchedulerCore."""
    assert _answers(make_core(slots), ops, slots) == _answers(
        jengine._PySchedulerCore(slots), ops, slots)


_OPS = st.lists(st.one_of(
    st.tuples(st.just("submit"), st.integers(0, 1 << 40), st.integers(1, 6)),
    st.tuples(st.just("assign")), st.tuples(st.just("tick"))), max_size=40)


@settings(max_examples=50, derandomize=True, deadline=None, database=None)
@given(ops=_OPS, slots=st.integers(1, 4))
def test_scheduler_cores_equal_the_jax_core_on_any_sequence(ops, slots):
    want = _answers(jengine._PySchedulerCore(slots), ops, slots)
    assert _answers(tengine._PySchedulerCore(slots), ops, slots) == want
    if get_lib() is not None:
        assert _answers(make_scheduler_core(slots, prefer_native=True), ops, slots) == want


# -- the slot step and the images against the JAX engine ---------------------

STEPS = (3, 4, 2)  # the three requests' step counts


@pytest.fixture(scope="module")
def tiny():
    """JAX params, the port's StableDiffusion loaded from them, ids (3, T)
    and negative ids (T,)."""
    params, model, ids, uids, _ = tiny_sd(jsd, tsd, jsd.TINY, tsd.TINY, seed=0)
    rng = np.random.default_rng(7)
    more = rng.integers(0, tsd.TINY.clip.vocab_size - 1, (2, ids.shape[1])).astype(np.int32)
    return params, model, np.concatenate([ids, more]), uids[0]


def _jax_latent(seed):
    return np.array(jax.random.normal(jax.random.key(seed), jsd.TINY.latent_shape, jnp.float32))


def _drive(eng, ids, uids):
    """Request 0 alone for two ticks, then request 1 joins mid-flight and
    request 2 queues: {request id: image}."""
    reqs = [eng.make_request(ids[i], uids, num_steps=STEPS[i], guidance=7.5 - i, seed=10 + i)
            for i in range(3)]
    eng.submit(reqs[0])
    out = list(eng.step()) + list(eng.step())
    eng.submit(reqs[1])
    eng.submit(reqs[2])
    out += eng.run_until_idle()
    return {r.request_id: r.image for r in out}


@pytest.fixture(scope="module")
def jax_engine(tiny):
    """The JAX engine's images of ``_drive``. Each of its ticks waits for
    its step: the step is dispatched with ``jnp.asarray`` of the engine's
    host guidance array, which the CPU backend may alias, and the next
    tick's admission writes that array (a request finishing in slot 0 then
    took its last step at the guidance of the request admitted after it)."""
    params, _, ids, uids = tiny
    eng = jengine.Engine(params, jsd.TINY, num_slots=2)
    step = eng.step

    def step_and_wait():
        out = step()
        jax.block_until_ready(eng.latents)
        return out

    eng.step = step_and_wait
    return eng, _drive(eng, ids, uids)


def test_slot_step_matches_jax_jit(tiny, jax_engine):
    """Two slots at different timesteps, the second inactive."""
    params, model, _, _ = tiny
    jeng, _ = jax_engine
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, *jsd.TINY.latent_shape)).astype(np.float32)
    ctx = rng.standard_normal((4, 16, 32)).astype(np.float32)
    acp = np.asarray(jddim.alphas_cumprod())
    g = np.array([7.5, 3.0], np.float32)
    t = np.array([981.0, 261.0], np.float32)
    a_t, a_prev = acp[[981, 261]], acp[[931, 211]]
    active = np.array([True, False])
    want, _ = jeng._step(params["unet"], lat, ctx, g, t, a_t, a_prev, active)
    with torch.no_grad():
        got = Engine._slot_step(model.unet, *(torch.from_numpy(np.asarray(a)) for a in
                                              (lat, ctx, g, t, a_t, a_prev, active)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), lat[1])


def test_images_match_the_jax_engine(tiny, jax_engine, monkeypatch):
    _, model, ids, uids = tiny
    _, want = jax_engine
    monkeypatch.setattr(tsd, "initial_latent", lambda seed, batch, cfg, device, dtype:
                        torch.from_numpy(_jax_latent(seed))[None].to(device, dtype))
    got = _drive(Engine(model, num_slots=2), ids, uids)
    assert got.keys() == want.keys() == {0, 1, 2}
    for rid in want:
        assert got[rid].shape == (32, 32, 3) and got[rid].dtype == np.uint8
        diff = np.abs(got[rid].astype(int) - want[rid].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (rid, diff.max(), (diff > 0).mean())


# -- the JAX package's TestEngine cases on the port's engine -----------------

def _req(eng, seed, steps=3, prompt_tok=7):
    n = eng.cfg.clip.max_length
    return eng.make_request(np.full((n,), prompt_tok, np.int32), np.zeros((n,), np.int32),
                            num_steps=steps, seed=seed)


def test_single_request_completes(tiny):
    eng = Engine(tiny[1], num_slots=2)
    eng.submit(_req(eng, seed=1))
    results = eng.run_until_idle()
    assert len(results) == 1
    assert results[0].image.shape == (32, 32, 3) and results[0].image.dtype == np.uint8


def test_continuous_join_matches_solo(tiny):
    """A request joining mid-flight gives the image it gives alone, bit for
    bit: every row of the batch is computed independently of the others."""
    model = tiny[1]
    solo = Engine(model, num_slots=2)
    solo.submit(_req(solo, seed=5, steps=3))
    solo_img = solo.run_until_idle()[0].image
    eng = Engine(model, num_slots=2)
    eng.submit(_req(eng, seed=1, steps=5, prompt_tok=3))
    eng.step()
    eng.step()
    late = _req(eng, seed=5, steps=3)
    eng.submit(late)
    results = eng.run_until_idle()
    assert len(results) == 2
    np.testing.assert_array_equal({r.request_id: r.image for r in results}[late.request_id],
                                  solo_img)


def test_more_requests_than_slots(tiny):
    eng = Engine(tiny[1], num_slots=2)
    reqs = [_req(eng, seed=i, steps=2) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    assert sorted(r.request_id for r in eng.run_until_idle()) == [r.request_id for r in reqs]


def test_memory_hygiene(tiny):
    """Completed requests leave nothing in the engine's bookkeeping."""
    eng = Engine(tiny[1], num_slots=2)
    for i in range(6):
        eng.submit(_req(eng, seed=i, steps=2))
    assert len(eng.run_until_idle()) == 6
    assert eng._requests == {} and eng._pending_decodes == []
    assert eng._steps_total == {} and eng._staged == {}


def test_deep_queue_stages_o_slots(tiny):
    """A burst of 100 holds device state for the stage window (2 x slots),
    not for the queue; the rest stages as admissions drain the window."""
    eng = Engine(tiny[1], num_slots=2)
    reqs = [_req(eng, seed=i, steps=2) for i in range(100)]
    for r in reqs:
        eng.submit(r)
    assert len(eng._staged) == eng.stage_window == 4
    assert len(eng._unstaged) == 96
    eng.step()  # admits 2, tops the window back up
    assert len(eng._staged) == 4 and len(eng._unstaged) == 94
    results = eng.run_until_idle()
    assert sorted(r.request_id for r in results) == [r.request_id for r in reqs]
    assert eng._staged == {} and eng._unstaged == []
    assert eng.stats["completed"] == 100 and eng.stats["first_result_s"] > 0


def test_admission_tick_reads_nothing_back(tiny, monkeypatch):
    """The encode and the initial latent are issued at submit() and copied
    into the slots on the device: a tick that admits requests reads no
    tensor back to the host."""
    eng = Engine(tiny[1], num_slots=2)
    eng.submit(_req(eng, seed=0, steps=4))
    eng.submit(_req(eng, seed=1, steps=4, prompt_tok=3))
    assert len(eng._staged) == 2
    for ctx2, lat0 in eng._staged.values():
        assert ctx2.device == lat0.device == eng.device
    readbacks = []
    for name in ("item", "cpu", "numpy", "tolist", "__bool__"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _name=name, _real=real, **k):
            readbacks.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    try:
        eng.step()  # admits both; no completion yet
    finally:
        monkeypatch.undo()
    assert readbacks == []
    assert eng.core.active() == 2
    assert len(eng.run_until_idle()) == 2


def test_cpu_engine_steps_eagerly(tiny):
    """A CPU engine captures no CUDA graph: construction's probe and every
    tick with an active slot run the slot step eagerly, and the kernel
    wrappers' counters do not move (on the CPU no wrapper launches)."""
    from tinyfusers_tpu_torch.kernels import counters

    eng = Engine(tiny[1], num_slots=2)
    assert eng._graph is None
    assert (eng.stats["graph_steps"], eng.stats["eager_steps"]) == (0, 1)
    before = counters.snapshot()
    for i, steps in enumerate((3, 2, 2)):
        eng.submit(_req(eng, seed=i, steps=steps))
    stepping, done = 0, []
    while eng.core.active() or eng.core.pending():
        stepping += 1  # the free slots admit the queue's head: a slot steps
        done += eng.step()
    done += eng.flush()
    assert sorted(r.request_id for r in done) == [0, 1, 2] and stepping == 4
    assert (eng.stats["graph_steps"], eng.stats["eager_steps"]) == (0, 1 + stepping)
    assert counters.snapshot() == before


def test_smoke_counts_replayed_kernels_by_name(tmp_path):
    """chip_smoke.py's check of an engine's replayed ticks: for each CUDA
    graph launch of a Chrome trace, the hand-written kernels it ran (by
    correlation id), counted by family from their names as the H100
    profiler gives them, templates included; against a capture's counts.
    Kernels of no graph launch, host ops and other kernels do not count."""
    import collections
    import importlib.util
    import json
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    flash = ("void tf::(anonymous namespace)::flash_fwd_wgmma<tf::(anonymous namespace)::"
             "Cfg<3, 1, 64, 128, 2> >(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
             "tf::(anonymous namespace)::Params)")
    geglu = ("void tf::(anonymous namespace)::wg::geglu_ff_wgmma<tf::(anonymous namespace)::"
             "wg::Cfg<320> >(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
             "tf::(anonymous namespace)::wg::Params)")

    def kernel(name, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "args": {"correlation": corr}}

    events = ([{"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": ts,
                "args": {"correlation": corr}} for ts, corr in ((300, 9), (100, 7))]
              + [kernel(flash, 7)] * 2 + [kernel(geglu, 7)]
              + [kernel(flash, 9)] * 3 + [kernel(geglu, 9)] * 2
              + [kernel("ampere_bf16_s16816gemm", 9), kernel(flash, 5)]
              + [{"ph": "X", "cat": "cpu_op", "name": "flash_fwd_wgmma", "args": {"correlation": 9}},
                 {"ph": "i", "cat": "kernel", "name": flash, "args": {"correlation": 9}}])
    (tmp_path / "trace_1.json").write_text(json.dumps({"traceEvents": events}))
    assert smoke.traced_replays(str(tmp_path)) == [{"flash_fwd": 2, "geglu_ff": 1},
                                                   {"flash_fwd": 3, "geglu_ff": 2}]
    none = (0, collections.Counter(), collections.Counter())
    graph_counts = [(3, collections.Counter(), collections.Counter()), none,
                    (2, collections.Counter(), collections.Counter()), none, none]
    assert smoke.captured_launches(graph_counts) == {"flash_fwd": 3, "geglu_ff": 2}
    quant = [none, (1, collections.Counter(), collections.Counter()), none,
             (5, collections.Counter(), collections.Counter()),
             (4, collections.Counter(), collections.Counter())]
    assert smoke.captured_launches(quant) == {"flash_fwd": 1, "quant_mm": 9}


def test_host_ladder_matches_ddim(tiny):
    eng = Engine(tiny[1], num_slots=1)
    for steps in (2, 4, 20, 50):
        np.testing.assert_array_equal(eng._ladder(steps), np.asarray(jddim.ddim_timesteps(steps)))
    np.testing.assert_array_equal(eng._acp, tddim.alphas_cumprod().numpy())


def test_reset_keeps_the_model_and_the_buffers(tiny):
    eng = Engine(tiny[1], num_slots=2)
    model, ptrs = eng.model, (eng.latents.data_ptr(), eng.contexts.data_ptr())
    eng.submit(_req(eng, seed=0, steps=4))
    eng.step()
    eng.reset()
    assert eng.core.active() == 0 and eng.core.pending() == 0
    assert eng.model is model and (eng.latents.data_ptr(), eng.contexts.data_ptr()) == ptrs
    eng.submit(_req(eng, seed=1, steps=2))
    assert len(eng.run_until_idle()) == 1


def test_refuses_v_prediction_and_a_foreign_config(tiny):
    v_model = tsd.StableDiffusion(dataclasses.replace(tsd.TINY, prediction_type="v"),
                                  device="cpu", seed=None)
    with pytest.raises(ValueError, match="prediction_type 'v'"):
        Engine(v_model)
    with pytest.raises(ValueError, match="not the model's config"):
        Engine(tiny[1], tsd.SD15)


# -- the router --------------------------------------------------------------

def test_router_mixed_models_complete(tiny):
    model = tiny[1]
    router = Router({"a": Engine(model, num_slots=2), "b": Engine(model, num_slots=1)})
    ids = np.full((16,), 3, np.int32)
    rids = [router.submit("a" if i % 2 == 0 else "b", ids, np.zeros_like(ids), num_steps=2,
                          seed=i) for i in range(3)]
    assert sorted(r.request_id for r in router.run_until_idle()) == sorted(rids)
    h = router.health()
    assert h["a"]["failures"] == 0 and h["b"]["failures"] == 0


def test_router_engine_failure_retries(tiny, monkeypatch):
    """The first tick raises: the router resets the same engine, keeping its
    model and buffers, and re-queues the request, which then completes."""
    eng = Engine(tiny[1], num_slots=1)
    router = Router({"m": eng}, max_retries=1)
    ids = np.full((16,), 3, np.int32)
    rid = router.submit("m", ids, np.zeros_like(ids), num_steps=2)
    calls = {"n": 0}
    orig_step = Engine.step

    def flaky_step(self):
        if calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("injected device failure")
        return orig_step(self)

    monkeypatch.setattr(Engine, "step", flaky_step)
    ptr = eng.latents.data_ptr()
    assert [r.request_id for r in router.run_until_idle()] == [rid]
    assert router.health()["m"]["failures"] == 1
    assert router.engines["m"] is eng and eng.latents.data_ptr() == ptr


# -- the demo ------------------------------------------------------------------

def test_serve_demo_completes_every_request(capsys):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / "serve_demo_torch.py"
    spec = importlib.util.spec_from_file_location("serve_demo_torch", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    results = demo.main(["--cpu", "--preset", "tiny", "--requests", "5", "--slots", "2"])
    assert sorted(r.request_id for r in results) == [0, 1, 2, 3, 4]
    assert all(r.image.shape == (32, 32, 3) and r.image.dtype == np.uint8 for r in results)
