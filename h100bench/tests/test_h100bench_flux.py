"""The two cells added with FLUX.1-dev: that the harness finds every file
of flux1-dev-b1 and sd15-serve-backlog by name, a CPU run of each driver
at TINY sizes (flux_closed_loop with tiny_flux.json, engine_closed_loop
with tiny_sd.json) judged correct, the closed loop's images_per_s
arithmetic on a fake clock, and counts/flux.py against a count by hand of
one double and one single block and against the reference's counted
matmuls."""
import copy
import json
import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench.counts import flux as counts
from h100bench.drivers import engine_closed_loop as closed
from h100bench.lib import harness, weights
from h100bench.reference import flux as rflux, flux_pipeline, nn

TESTS = harness.HERE / "tests"
FLUX, BACKLOG = "tiny-flux-b1", "tiny-backlog"
# As tiny.LIMIT: the fp32 program reads 0 levels against the reference at
# these sizes.
LIMIT = {"image_rms_levels": 1.0}


@pytest.fixture()
def cells(tmp_path):
    bench = copy.deepcopy(json.loads((harness.ROOT / "BENCHMARK.json").read_text()))
    bench["configs"] += [
        {"name": "tiny-flux", "source": "tests", "file": str(TESTS / "tiny_flux.json"),
         "reduced": [], "why": "tests"},
        {"name": "tiny-sd", "source": "tests", "file": str(TESTS / "tiny_sd.json"), "reduced": [],
         "why": "tests"}]
    for d in ("traffic", "limits"):
        (tmp_path / d).mkdir()
    gen = json.loads((harness.HERE / "traffic/flux-b1.json").read_text())
    gen.update(steps=3, prompt_tokens=[1, 6])
    serve = json.loads((harness.HERE / "traffic/closed-16on8.json").read_text())
    serve.update(num_slots=4, clients=6, steps=[2, 3, 4], prompt_tokens=[2, 6], sample=3,
                 profile_min_active=4, profile_ticks=2)
    for w, c, mix in ((FLUX, "tiny-flux", gen), (BACKLOG, "tiny-sd", serve)):
        (tmp_path / "traffic" / f"{w}.json").write_text(json.dumps(mix))
        (tmp_path / "limits" / f"{w}.json").write_text(json.dumps(LIMIT))
        bench["workloads"].append({"name": w, "config": c, "traffic": w, "chips": 1,
                                   "why": "tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            real = "flux1-dev-b1" if w == FLUX else "sd15-serve-backlog"
            if real in m.get("workloads", []):
                m["workloads"].append(w)
    return bench, [tmp_path, harness.HERE]


@pytest.mark.parametrize("cell", ["flux1-dev-b1", "sd15-serve-backlog"])
def test_the_harness_finds_every_file_of_the_new_cells(cell):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    workload, cfg, config, traffic, driver, limits = harness.load_cell(cell, (harness.HERE,), bench)
    assert workload["chips"] == 1 and "image_rms_levels" in limits
    for fn in ("run", "sample", "compare", "control"):
        assert callable(getattr(driver, fn))
    for fn in ("spec", "build", "reference", "latent_hw", "work"):
        assert callable(getattr(config, fn))
    assert {m["name"] for m in bench["end_to_end"] if harness.applies(m, cell)} == {
        "images_per_s", "peak_mem_gib", "setup_s"}
    layer = [m["name"] for m in bench["per_layer"] if harness.applies(m, cell)]
    assert layer and all((harness.HERE / "metrics" / f"{n}.py").is_file() for n in layer)
    if cell == "flux1-dev-b1":
        assert cfg["reduced"] == [] and cfg["transformer"]["num_single_layers"] == 38
        assert sorted(layer) == ["attn_roofline.gen", "device_idle_share.gen", "double_stack_ms.flux",
                                 "launches_per_image.gen", "mfu.gen", "single_stack_ms.flux"]


@pytest.mark.parametrize("trace", [False, True])
def test_flux_rehearsal(cells, trace):
    bench, roots = cells
    runs = []
    res = harness.run_workload(FLUX, 2 ** 31 + 41, 1.0, trace, device="cpu", bench=bench,
                               roots=roots, runs=runs)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["image_rms_levels"]["value"] < 0.5
    if not trace:
        assert set(res["metrics"]) == {"images_per_s", "peak_mem_gib", "setup_s"}
        assert res["metrics"]["images_per_s"]["value"] > 0
    else:  # no device: the span metrics read nothing, but the spans were recorded
        assert res["metrics"] == {}
        names = [s.name for s in runs[0].records["spans"]]
        steps = runs[0].traffic["steps"] * res["attempted"]
        assert names.count("flux.double") == names.count("flux.single") == steps
        assert runs[0].records["clock"] is not None and runs[0].records["slice"] is None
    json.dumps(res)


def test_backlog_rehearsal(cells):
    bench, roots = cells
    runs = []
    res = harness.run_workload(BACKLOG, 2 ** 31 + 43, 2.0, False, device="cpu", bench=bench,
                               roots=roots, runs=runs)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > runs[0].traffic["clients"]  # the clients came back for more
    assert set(res["metrics"]) == {"images_per_s", "peak_mem_gib", "setup_s"}
    assert res["metrics"]["images_per_s"]["value"] > 0


def test_backlog_rate_counts_whole_images_and_in_flight_shares():
    submit = {1: 0.0, 2: 0.5, 3: 4.0, 4: 9.0, 5: 10.5}
    done = {1: 3.0, 2: 9.5, 3: 11.0, 4: 14.0, 5: 12.0}
    # window [0, 10]: 1 and 2 whole; 3 in flight 6 of its 7 s inside, 4 1 of 5; 5 after the close
    want = (2 + 6 / 7 + 1 / 5) / 10.0
    assert closed.rate(submit, done, 10.0, 10.0, 20.0) == pytest.approx(want, rel=1e-12)
    # a request not back counts up to the drain
    assert closed.rate({1: 8.0}, {}, 10.0, 10.0, 18.0) == pytest.approx(0.2 / 10.0)


class _ScriptedEngine:
    """Each request takes ``ticks`` ticks of a slot, at most ``slots`` at
    once in order of submission; its image comes back at the tick it ends."""

    def __init__(self, slots, ticks, clock):
        self.slots, self.ticks, self.clock = slots, ticks, clock
        self.left, self.queue = {}, []
        self.core = types.SimpleNamespace(active=lambda: len(self.left),
                                          pending=lambda: len(self.queue))

    def make_request(self, ids, uncond, **kw):
        return kw["seed"]   # the request id

    def submit(self, req):
        self.queue.append(req)
        return req

    def step(self):
        while self.queue and len(self.left) < self.slots:
            self.left[self.queue.pop(0)] = self.ticks
        self.clock.t += 1.0
        out = []
        for rid in list(self.left):
            self.left[rid] -= 1
            if not self.left[rid]:
                del self.left[rid]
                out.append(types.SimpleNamespace(request_id=rid, image=None))
        return out

    def flush(self):
        return []


def test_backlog_serve_keeps_every_client_busy_on_a_fake_clock(monkeypatch):
    clock = types.SimpleNamespace(t=0.0)
    monkeypatch.setattr(closed.time, "perf_counter", lambda: clock.t)
    monkeypatch.setattr(closed.time, "sleep", lambda s: None)
    eng = _ScriptedEngine(slots=2, ticks=3, clock=clock)
    mix = {"num_slots": 2, "clients": 3, "steps": [2], "guidance": 1.0, "prompt_tokens": [1, 2],
           "drain_s": 30, "profile_after": 0.5, "profile_min_active": 2, "profile_ticks": 2}
    draw = ((2, [0], k) for k in range(1, 100))
    out = closed.serve(eng, draw, mix, [0], 0.0, 10.0)
    # 2 slots, 3 ticks a request: 2 images every 3 s, a third client always queued
    back = sorted(out["done_t"].values())
    assert back[:4] == [3.0, 3.0, 6.0, 6.0]
    assert len(out["rid_at"]) == len(out["done_t"])          # drained
    assert sum(t <= 10.0 for t in back) == 6
    # in flight at the close, one a client: submitted at 6 and back at 12, at 9 and back
    # at 12, at 9 and (queued behind them) back at 15
    rate = closed.rate(out["submit_t"], out["done_t"], 10.0, 10.0, out["t_drained"])
    assert rate == pytest.approx((6 + 4 / 6 + 1 / 3 + 1 / 6) / 10.0)


def _hand_double(d, hid, heads, hd, n):
    mod = 2 * (2 * d * 6 * d)
    qkv, proj = 2 * n * d * 3 * d, 2 * n * d * d
    mlp = 2 * n * d * hid + 2 * n * hid * d
    return mod + qkv + proj + mlp + 2 * (2 * heads * n * n * hd)


def _hand_single(d, hid, heads, hd, n):
    return (2 * d * 3 * d + 2 * n * d * (3 * d + hid) + 2 * n * (d + hid) * d
            + 2 * (2 * heads * n * n * hd))


def test_flux_block_counts_by_hand():
    cfg = json.loads((harness.HERE / "configs/flux1-dev.json").read_text())
    m, n = cfg["transformer"], 512 + 64 * 64
    assert counts.double_block_flops(m, 1, n) == _hand_double(3072, 12288, 24, 128, n)
    assert counts.single_block_flops(m, 1, n) == _hand_single(3072, 12288, 24, 128, n)
    step = counts.flux_flops(m, 128, 128, 1, 512)
    assert 7.4e13 < step < 7.5e13
    calls = counts.flux_calls(m, 128, 128, 1, 512, 2)
    assert len(calls) == 57 and calls[0].shape == (1, 4608, 4608, 24, 128)
    assert calls[0].flops == 4 * 24 * 4608 * 4608 * 128


def test_flux_count_equals_the_references_counted_matmuls():
    cfg = json.loads((TESTS / "tiny_flux.json").read_text())
    m = cfg["transformer"]
    W = weights.make(rflux.spec(m, "transformer"), 5, "cpu", torch.float32)
    x = torch.randn(2, 12 * 12, m["in_channels"])
    ctx = torch.randn(2, 7, m["joint_attention_dim"])
    pe = rflux.rope(rflux.ids(7, 12, 12, "cpu"), m["axes_dims_rope"], m["theta"])
    with FlopCounterMode(display=False) as fc:
        rflux.forward(nn.Prec(), W, m, "transformer", x, ctx, pe, torch.ones(2) * 0.5,
                      torch.randn(2, m["pooled_projection_dim"]), torch.ones(2) * 3.5)
    assert fc.get_total_flops() == counts.flux_flops(m, 24, 24, 2, 7)
    with FlopCounterMode(display=False) as fc:
        from h100bench.reference import t5
        W5 = weights.make(t5.spec(cfg["t5"], "t5"), 6, "cpu", torch.float32)
        t5.forward(nn.Prec(), W5, cfg["t5"], "t5", torch.zeros(2, 12, dtype=torch.long))
    assert fc.get_total_flops() == counts.t5_flops(cfg["t5"], 2, 12)
    assert flux_pipeline.spec(cfg)  # the whole pipeline's list builds


def test_t5_q_at_the_checkpoint_init_keeps_bf16_t5_near_the_reference():
    """configs/flux1-dev.py scales T5's q projections, and only them, by
    head_dim^-1/2 on both sides. At d_kv 64 through 24 layers that keeps the
    port's bf16 T5 within a few percent of the fp32 reference (about 2% at this
    size), where the raw draw's logits of std 8 leave the two unrelated."""
    from h100bench.reference import t5 as rt5
    from tinyfusers_tpu_torch.models import t5

    config = harness.load_module(harness.HERE / "configs/flux1-dev.py")
    cfg = json.loads((TESTS / "tiny_flux.json").read_text())
    cfg["t5"] = dict(vocab_size=512, dim=512, ff_dim=1024, num_layers=24, num_heads=8,
                     head_dim=64, rel_buckets=32, rel_max_distance=128)
    cfg["transformer"]["joint_attention_dim"] = 512
    raw = weights.make(flux_pipeline.spec(cfg), 7, "cpu", torch.float32)
    raw = {k: v.clone() for k, v in raw.items()}
    W = config.reference(cfg, 7, "cpu").W
    assert raw.keys() == W.keys()
    for k in W:
        want = raw[k] / 8 if k.startswith("t5.") and k.endswith(".attn.q.weight") else raw[k]
        assert torch.equal(W[k], want), k
    built = config.build(cfg, 7, "cpu").state_dict()
    assert all(torch.equal(built[k], W[k]) for k in W)

    ids = torch.as_tensor(np.random.default_rng(3).integers(2, 512, (1, 128)))
    gaps = []
    for w in (W, raw):
        want = rt5.forward(nn.Prec("fp32"), w, cfg["t5"], "t5", ids)
        model = t5.T5Encoder(t5.T5Config(**cfg["t5"]), device="cpu", dtype=torch.bfloat16)
        model.load_state_dict({k[3:]: v.bfloat16() for k, v in w.items() if k.startswith("t5.")})
        got = t5.apply(model, ids).float()
        gaps.append(float((got - want).norm() / want.norm()))
    assert gaps[0] < 0.05 and gaps[1] > 0.5, gaps
