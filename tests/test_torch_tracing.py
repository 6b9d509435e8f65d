"""The port's span recorder (utils/profiling.py: span / begin / end,
tracing, drain, profiler_ns, trace) and the spans of the serving engine
and of sd / sd3 ``generate``, on the CPU at TINY.

- Off, a span records nothing and costs no allocation; on, spans nest
  (parent ids, containment) and request spans open and close across calls.
- The engine: one ``request.queued`` per request from its submit to its
  admission, every tick's children inside it in order, and the same
  images, bit for bit, with tracing on; the admission tick still reads
  nothing back.
- ``generate``: its three children, in order, inside it.
- The clock: under a CPU ``torch.profiler``, each ``aten::`` op issued
  inside a span lies inside the span as profiler_ns() maps it; trace()
  writes the spans into its Chrome trace over the ops.
"""
import json
import sys

import numpy as np
import pytest
import torch

from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu_torch.pipeline import sd as tsd
from tinyfusers_tpu_torch.pipeline import sd3 as tsd3
from tinyfusers_tpu_torch.serve import Engine
from tinyfusers_tpu_torch.utils import profiling

from torch_parity import few_torch_threads, tiny_sd  # noqa: F401

TICK_CHILDREN = ["engine.admit", "engine.control", "engine.slot_step", "engine.decode",
                 "engine.harvest"]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.drain()
    yield
    profiling.drain()


@pytest.fixture(scope="module")
def tiny():
    """The port's TINY StableDiffusion, prompt ids (T,) and negative ids (T,)."""
    _, model, ids, uids, lat = tiny_sd(jsd, tsd, jsd.TINY, tsd.TINY, seed=0)
    return model, ids[0], uids[0], lat


def _inside(inner, outer) -> bool:
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_off_records_nothing_and_allocates_nothing():
    assert not profiling._on
    assert profiling.span("engine.tick") is profiling.NO_SPAN
    scope = object()
    with profiling.span("x") as s:
        profiling.begin("request.queued", 1, scope)
        profiling.end("request.queued", 1, scope)
    assert s is profiling.NO_SPAN
    span, begin, end = profiling.span, profiling.begin, profiling.end
    for _ in range(100):  # warm every free list
        with span("engine.tick"):
            begin("request.queued", 3, scope)
            end("request.queued", 3, scope)
    blocks = sys.getallocatedblocks()
    for _ in range(10_000):
        with span("engine.tick"):
            begin("request.queued", 3, scope)
            end("request.queued", 3, scope)
    assert sys.getallocatedblocks() - blocks < 50  # not one a call
    assert profiling.drain() == ([], None)


def test_spans_nest_and_request_spans_cross_calls():
    eng, other = object(), object()
    with profiling.tracing():
        with profiling.span("a") as a:
            profiling.begin("request.queued", 7, eng)
            profiling.begin("request.queued", 7, other)  # another engine's request 7
            with profiling.span("b") as b:
                with profiling.span("c"):
                    pass
            with profiling.span("d"):
                profiling.end("request.queued", 7, eng)
        profiling.end("request.queued", 8, eng)       # never begun: nothing
        profiling.begin("request.denoise", 9, eng)    # still open at the drain
        spans, clock = profiling.drain()
        assert len(profiling._open) == 2
        profiling.forget(eng)
        assert list(profiling._open) == [("request.queued", id(other), 7)]
    assert [s.name for s in spans] == ["c", "b", "request.queued", "d", "a"]
    by = {s.name: s for s in spans}
    assert by["a"].id == a.id and by["b"].id == b.id
    assert by["a"].parent is None
    assert by["b"].parent == by["d"].parent == by["a"].id and by["c"].parent == by["b"].id
    for inner, outer in (("b", "a"), ("c", "b"), ("d", "a"), ("request.queued", "a")):
        assert _inside(by[inner], by[outer]), (inner, outer)
    q = by["request.queued"]
    assert q.request_id == 7 and q.parent is None
    assert q.start_ns < by["b"].start_ns and by["d"].start_ns <= q.end_ns <= by["d"].end_ns
    assert len({s.id for s in spans}) == 5
    assert clock.perf0 <= by["a"].start_ns and by["a"].end_ns <= clock.perf1
    assert profiling.drain()[0] == []  # the open request span was never handed out


def _engine_requests(eng, ids, uids):
    return [eng.make_request(ids, uids, num_steps=3, seed=10 + i) for i in range(3)]


def _run_engine(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.request_id: r.image for r in eng.run_until_idle()}


def test_engine_spans(tiny):
    model, ids, uids, _ = tiny
    eng = Engine(model, num_slots=2)
    reqs = _engine_requests(eng, ids, uids)
    with profiling.tracing():
        images = _run_engine(eng, reqs)
        spans, _ = profiling.drain()
    assert len(images) == 3
    named = lambda n: [s for s in spans if s.name == n]  # noqa: E731
    submits, admits, ticks = named("engine.submit"), named("engine.admit"), named("engine.tick")
    assert len(submits) == 3 and len(named("engine.stage")) == 3
    assert all(s.parent == p.id for s, p in zip(named("engine.stage"), submits))
    queued = {s.request_id: s for s in named("request.queued")}
    assert sorted(queued) == [r.request_id for r in reqs]
    for r, sub in zip(reqs, submits):  # from its submit to its admission
        q = queued[r.request_id]
        assert sub.start_ns <= q.start_ns <= sub.end_ns
        assert any(a.start_ns <= q.end_ns <= a.end_ns for a in admits)
    assert queued[reqs[2].request_id].end_ns - queued[reqs[2].request_id].start_ns > 0
    # the third waited for a slot: admitted a tick after the first two
    first_admit = min(admits, key=lambda a: a.start_ns)
    assert queued[reqs[2].request_id].end_ns > first_admit.end_ns
    for kind in ("request.denoise", "request.decode"):
        assert sorted(s.request_id for s in named(kind)) == [r.request_id for r in reqs]
    for r in reqs:
        d = next(s for s in named("request.denoise") if s.request_id == r.request_id)
        assert queued[r.request_id].end_ns <= d.start_ns
    assert len(ticks) >= 3
    for t in ticks:
        kids = sorted((s for s in spans if s.parent == t.id), key=lambda s: s.start_ns)
        assert all(_inside(k, t) for k in kids)
        names = [k.name for k in kids]
        assert names[:2] == ["engine.admit", "engine.control"] and names[-1] == "engine.harvest"
        middle = names[2:-1]
        assert middle == [n for n in TICK_CHILDREN[2:4] for _ in range(middle.count(n))]
        assert middle.count("engine.slot_step") <= 1
    assert len(named("engine.decode")) == 3
    assert all(s.parent is not None for s in spans if s.name.startswith("engine.")
               and s.name not in ("engine.submit", "engine.tick"))


def test_engine_images_equal_with_tracing_on(tiny, monkeypatch):
    model, ids, uids, _ = tiny
    off = Engine(model, num_slots=2)
    want = _run_engine(off, _engine_requests(off, ids, uids))
    on = Engine(model, num_slots=2)
    reqs = _engine_requests(on, ids, uids)
    with profiling.tracing():
        on.submit(reqs[0])
        on.submit(reqs[1])
        readbacks = []
        for name in ("item", "cpu", "numpy", "tolist", "__bool__"):
            real = getattr(torch.Tensor, name)

            def spy(self, *a, _name=name, _real=real, **k):
                readbacks.append(_name)
                return _real(self, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, spy)
        try:
            on.step()  # admits both; no completion yet
        finally:
            monkeypatch.undo()
        assert readbacks == [] and on.core.active() == 2
        on.submit(reqs[2])
        got = {r.request_id: r.image for r in on.run_until_idle()}
    assert profiling.drain()[0]
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def _generate(which, tiny):
    if which == "sd":
        model, ids, uids, lat = tiny
        return tsd.generate(model, torch.from_numpy(ids[None]), torch.from_numpy(uids[None]),
                            torch.from_numpy(lat), 7.5, num_steps=3)
    model = tsd3.StableDiffusion3(tsd3.TINY_SD3, device="cpu", seed=0)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 127, (1, 8)))
    uids = torch.full((1, 8), 127)
    lat = torch.from_numpy(rng.standard_normal((1, *tsd3.TINY_SD3.latent_shape)).astype(np.float32))
    return tsd3.generate(model, ids, ids, uids, uids, lat, 5.0, num_steps=2)


@pytest.mark.parametrize("which", ["sd", "sd3"])
def test_generate_spans(which, tiny):
    with profiling.tracing():
        image = _generate(which, tiny)
        spans, _ = profiling.drain()
    assert image.dtype == torch.uint8
    top = [s for s in spans if s.name == "generate"]
    assert len(top) == 1
    kids = sorted((s for s in spans if s.parent == top[0].id), key=lambda s: s.start_ns)
    assert [k.name for k in kids] == ["generate.encode", "generate.denoise", "generate.decode"]
    assert all(_inside(k, top[0]) for k in kids)
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))


def test_aten_ops_lie_inside_their_span_on_the_profilers_clock():
    x = torch.ones(64, 64)
    with profiling.tracing():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(5):
                with profiling.span("work"):
                    (x @ x).relu_().sum()
                torch.ones(8).add_(1)  # between spans
        spans, clock = profiling.drain()
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    work = [(profiling.profiler_ns(s.start_ns, clock), profiling.profiler_ns(s.end_ns, clock))
            for s in spans]
    assert len(work) == 5
    holders = {"aten::mm": set(), "aten::sum": set(), "aten::ones": set()}
    for s, e, name in ops:
        assert not [k for k, (a, b) in enumerate(work) if s < a < e or s < b < e], name
        if name in holders:
            holders[name] |= {k for k, (a, b) in enumerate(work) if a <= s and e <= b}
    assert holders == {"aten::mm": set(range(5)), "aten::sum": set(range(5)),
                       "aten::ones": set()}


def test_trace_writes_the_spans_over_the_ops(tiny, tmp_path):
    with profiling.trace(str(tmp_path)):
        _generate("sd", tiny)
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    assert {e["name"] for e in spans} == {"generate", "generate.encode", "generate.denoise",
                                         "generate.decode"}
    assert len({(e["pid"], e["tid"]) for e in spans}) == 1
    (den,) = [e for e in spans if e["name"] == "generate.denoise"]
    lo, hi = den["ts"], den["ts"] + den["dur"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("aten::")]
    conv = [e for e in ops if lo <= e["ts"] and e["ts"] + e["dur"] <= hi
            and e["name"] in ("aten::convolution", "aten::conv2d")]
    assert conv  # the UNet's convolutions ran inside the denoise span
    assert not [e for e in ops
                if e["ts"] < lo < e["ts"] + e["dur"] or e["ts"] < hi < e["ts"] + e["dur"]]
    assert profiling.drain() == ([], None)


def test_trace_of_the_engine_nests_the_thread_spans_and_tracks_each_request(tiny, tmp_path):
    model, ids, uids, _ = tiny
    eng = Engine(model, num_slots=2)
    reqs = _engine_requests(eng, ids, uids)
    with profiling.trace(str(tmp_path)):
        _run_engine(eng, reqs)
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    track = [e for e in events if e.get("tid") == profiling.SPAN_TRACK]
    assert profiling.SPAN_TRACK not in {e.get("tid") for e in events if e.get("cat") != "span"
                                        and e.get("cat") != "request"}
    xs = sorted((e for e in track if e["ph"] == "X"), key=lambda e: (e["ts"], -e["dur"]))
    assert {"engine.submit", "engine.tick", "engine.slot_step", "engine.decode"} <= {
        e["name"] for e in xs}
    for k, a in enumerate(xs):  # on one track, complete events nest or lie apart
        for b in xs[k + 1:]:
            if b["ts"] >= a["ts"] + a["dur"]:
                break
            assert b["ts"] + b["dur"] <= a["ts"] + a["dur"], (a["name"], b["name"])
    begins = [e for e in track if e["ph"] == "b"]
    ends = [e for e in track if e["ph"] == "e"]
    assert sorted((e["name"], e["args"]["request_id"]) for e in begins) == sorted(
        (n, r.request_id) for n in ("request.queued", "request.denoise", "request.decode")
        for r in reqs)
    key = lambda e: (e["cat"], e["name"], e["id"])  # noqa: E731
    assert sorted(map(key, ends)) == sorted(map(key, begins))
    assert len({e["id"] for e in begins}) == len(begins)
    assert {e["ph"] for e in track} == {"X", "b", "e"}
    assert profiling.drain() == ([], None)


def test_trace_takes_only_the_spans_that_closed_in_its_block(tmp_path):
    with profiling.tracing():
        with profiling.span("left"):
            pass
    with profiling.trace(str(tmp_path / "alone")):
        with profiling.span("traced"):
            torch.ones(4).add_(1)
    with profiling.tracing():
        with profiling.span("before"):
            pass
        with profiling.trace(str(tmp_path / "nested")):
            with profiling.span("inside"):
                torch.ones(4).add_(1)
        spans, clock = profiling.drain()
    # the outer block's drain keeps its own and the nested trace's spans
    assert [s.name for s in spans] == ["left", "before", "inside"]
    assert clock.perf0 <= spans[0].start_ns and spans[-1].end_ns <= clock.perf1
    for sub, want in (("alone", ["traced"]), ("nested", ["inside"])):
        (path,) = (tmp_path / sub).glob("trace_*.json")
        events = json.loads(path.read_text())["traceEvents"]
        assert [e["name"] for e in events if e.get("tid") == profiling.SPAN_TRACK] == want
