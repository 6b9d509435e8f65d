"""lib/spans.py and the span metrics' files (metrics/<name>.py for each of
spans_run.SPAN_METRICS) on synthetic events and spans, and spans_run.py
on the TINY serve cell on the CPU (the program's spans recorded over the
window; no slice without a card)."""
import numpy as np
import pytest

from h100bench import spans_run
from h100bench.lib import harness
from h100bench.lib import spans as S
from h100bench.tests import tiny
from tinyfusers_tpu_torch.utils import profiling
from tinyfusers_tpu_torch.utils.profiling import Clock, Span

IDENTITY = Clock(0, 0, 10_000, 10_000)


def _span(name, a, b, sid, parent=None, rid=None):
    return Span(name, a, b, sid, parent, rid)


# one tick: admit, control (an upload), the slot step (two launches), a
# decode (one launch), harvest; times in ns on the profiler's clock
TICK = [_span("engine.tick", 100, 1000, 1), _span("engine.admit", 110, 200, 2, 1),
        _span("engine.control", 200, 300, 3, 1), _span("engine.slot_step", 300, 800, 4, 1),
        _span("engine.decode", 800, 900, 5, 1), _span("engine.harvest", 900, 990, 6, 1),
        _span("request.denoise", 150, 850, 7, rid=3)]
CALLS = [(250, 258, "cudaMemcpyAsync", 4), (310, 330, "cudaLaunchKernel", 1),
         (400, 420, "cuLaunchKernelEx", 2), (810, 830, "cudaLaunchKernel", 3),
         (950, 960, "cudaEventQuery", 9)]
DEVICE = [(260, 270, "Memcpy HtoD (Pinned -> Device)", 4), (320, 500, "unet_kernel", 1),
          (500, 700, "flash_fwd", 2), (820, 1200, "vae_kernel", 3)]
LO, HI = 0, 1300


@pytest.fixture()
def ms():
    return S.mapped(TICK, IDENTITY)


def test_mapped_leaves_request_spans_out_and_maps_the_clock():
    clock = Clock(perf0=1_000, unix0=5_000_000, perf1=2_001_000, unix1=7_001_000)
    assert profiling.profiler_ns(1_000, clock) == 5_000_000
    assert profiling.profiler_ns(1_001_000, clock) == pytest.approx(6_000_500)  # slope 1.0005
    got = S.mapped(TICK, clock)
    assert [s.name for _, _, s in got] == [s.name for s in TICK[:6]]
    assert got[0][:2] == (profiling.profiler_ns(100, clock), profiling.profiler_ns(1000, clock))


def test_idle_split_by_innermost_span_sums_to_the_idle_time(ms):
    gaps = S.idle_gaps(DEVICE, LO, HI)
    assert gaps == [(0, 260), (270, 320), (700, 820), (1200, 1300)]
    idle = S.idle_by_span(DEVICE, ms, LO, HI)
    assert idle == pytest.approx({"engine.admit": 260e-9, "engine.control": 50e-9,
                                  "engine.slot_step": 120e-9, S.NONE: 100e-9})
    assert sum(idle.values()) == pytest.approx((HI - LO) / 1e9 - S.busy_s(DEVICE))
    assert S.idle_inside(DEVICE, ms, "engine.slot_step", LO, HI) == pytest.approx(120e-9)
    assert S.idle_gaps([], 5, 9) == [(5, 9)]


def test_kernels_belong_to_the_span_their_launch_started_in(ms):
    step = S.launched_in(DEVICE, CALLS, ms, ["engine.slot_step"])
    assert [d[2] for d in step] == ["unet_kernel", "flash_fwd"]
    assert S.busy_s(step) == pytest.approx(380e-9)
    assert [d[2] for d in S.launched_in(DEVICE, CALLS, ms, ["engine.decode", "engine.control"])
            ] == ["Memcpy HtoD (Pinned -> Device)", "vae_kernel"]
    assert S.unattributed(DEVICE, CALLS, ms, ["engine.slot_step", "engine.decode"]) == \
        pytest.approx({"Memcpy HtoD (Pinned -> Device)": 10e-9})


def test_launch_check_finds_calls_across_a_span_edge(ms):
    good = S.launch_check(CALLS, ms, "engine.slot_step")
    assert good == {"spans": 1, "first_launch_inside": 1, "least_margin_ns": 10,
                    "straddling_calls": 0, "deepest_straddle_ns": 0.0}
    shifted = S.mapped(TICK, Clock(0, 15, 10_000, 10_015))  # spans 15 ns late
    bad = S.launch_check(CALLS, shifted, "engine.slot_step")
    # (310, 330) over 315 and (810, 830) over 815: each an end of one span
    # and the start of the next
    assert bad["straddling_calls"] == 4 and bad["deepest_straddle_ns"] == 5
    late = S.mapped(TICK, Clock(0, 5_000, 10_000, 15_000))  # every launch before it
    assert S.launch_check(CALLS, late, "engine.slot_step")["first_launch_inside"] == 0


def test_queue_wait_p90_over_the_requests_submitted_in_the_share():
    waits = [0.0, 0.1, 0.2, 0.4, 0.8, 1.6]
    rows = [_span("request.queued", int(i * 1e9), int(i * 1e9 + w * 1e9), 10 + i, rid=i)
            for i, w in enumerate(waits)]
    rows.append(_span("request.denoise", 0, int(9e9), 99, rid=0))
    p90, n = S.queue_wait_p90_s(rows, 0, 4e9)
    assert n == 5 and p90 == pytest.approx(float(np.percentile(waits[:5], 90)))
    assert S.queue_wait_p90_s(rows, 7e9, 8e9) == (None, 0)


class _Run:
    def __init__(self, traffic, seconds=2.0, **records):
        self.traffic, self.seconds, self.records = traffic, seconds, records


class _Slice:
    t0, t1 = LO / 1e9, HI / 1e9


def _read(name, run):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(run)


def test_the_span_metrics_of_a_serve_slice(monkeypatch):
    monkeypatch.setattr(S, "events", lambda sl: (DEVICE, CALLS))
    queued = _span("request.queued", 50, 2_000, 20, rid=5)
    late = _span("request.queued", 1_500_000_000, 1_600_000_000, 21, rid=6)  # after the share
    serve = _Run({"driver": "engine_open_loop", "profile_after": 0.5},
                 spans=TICK + [queued, late], clock=IDENTITY, slice=_Slice())
    assert _read("queue_wait_p90_s.serve", serve) == pytest.approx(1_950e-9)
    assert _read("slot_step_idle_share.serve", serve) == pytest.approx(100 * 120 / 1300)
    for name in ("encode_ms.gen", "denoise_step_ms.gen", "decode_ms.gen"):
        assert _read(name, serve) is None  # no generate span in the slice
    out = S.breakdown(serve)
    assert out["queue_wait_requests"] == 1 and out["recorded"] == 9
    assert out["idle_s"] == pytest.approx(out["slice_wall_s"] - out["slice_busy_s"])
    assert out["mapping"]["first_launch_inside"] == 1
    assert spans_run.readings(serve) == {"queue_wait_p90_s.serve": pytest.approx(1_950e-9),
                                         "slot_step_idle_share.serve": pytest.approx(
                                             100 * 120 / 1300), **out}


def test_the_span_metrics_of_a_generate_slice(monkeypatch):
    gen = [_span("generate", 100, 1000, 1), _span("generate.encode", 110, 300, 2, 1),
           _span("generate.denoise", 300, 800, 3, 1), _span("generate.decode", 800, 990, 4, 1)]
    monkeypatch.setattr(S, "events", lambda sl: (DEVICE + [(1250, 1260, "Memcpy DtoH", 12)],
                                                 CALLS + [(1240, 1250, "cudaMemcpyAsync", 12)]))
    gen_run = _Run({"driver": "generate_closed_loop", "steps": 2}, spans=gen, clock=IDENTITY,
                   slice=_Slice())
    assert _read("encode_ms.gen", gen_run) == pytest.approx(10e-6)
    assert _read("denoise_step_ms.gen", gen_run) == pytest.approx(380e-6 / 2)
    assert _read("decode_ms.gen", gen_run) == pytest.approx(380e-6)
    assert _read("slot_step_idle_share.serve", gen_run) is None
    assert _read("queue_wait_p90_s.serve", gen_run) is None  # no engine, no profile_after
    assert spans_run.readings(gen_run)["decode_ms.gen"] == pytest.approx(380e-6)
    out = S.breakdown(gen_run)
    assert out["generate_busy_share"] == pytest.approx(770 / 780)
    assert out["outside_generate_s"] == pytest.approx({"Memcpy DtoH": 10e-9})
    assert out["mapping"]["spans"] == 1


@pytest.mark.parametrize("driver", ["engine_open_loop", "generate_closed_loop"])
def test_a_run_without_spans_reads_nothing(driver):
    """The parent's drivers, and an untraced run, leave no spans: each
    metric reads None and the breakdown does not raise."""
    run = _Run({"driver": driver, "profile_after": 0.5, "steps": 2})
    assert {name: _read(name, run) for name in spans_run.SPAN_METRICS} == dict.fromkeys(
        spans_run.SPAN_METRICS)
    assert S.breakdown(run) == {"recorded": 0, **(
        {"queue_wait_requests": 0} if driver == "engine_open_loop" else {})}


@pytest.mark.parametrize("spans_on", [True, False])
def test_spans_run_on_the_tiny_serve_cell(tmp_path, spans_on):
    bench, roots = tiny.bench_and_roots(tmp_path)
    out = spans_run.traced(tiny.SERVE, 2 ** 31 + 5, 2.0, spans_on, device="cpu", bench=bench,
                           roots=roots)
    assert out["result"]["correct"] is True
    assert not profiling._on and profiling.drain() == ([], None)
    got = out["spans"]
    if spans_on:
        assert got["recorded"] > 0 and got["queue_wait_requests"] > 0
        assert got["queue_wait_p90_s.serve"] >= 0
    else:
        assert got == {"recorded": 0, "queue_wait_requests": 0}


def test_spans_run_on_the_tiny_generate_cell(tmp_path):
    bench, roots = tiny.bench_and_roots(tmp_path)
    out = spans_run.traced(tiny.GEN, 2 ** 31 + 7, 2.0, device="cpu", bench=bench, roots=roots)
    assert out["result"]["correct"] is True
    got = out["spans"]
    assert got["recorded"] >= 4  # generate and its three parts, each call
    assert not set(got) & set(spans_run.SPAN_METRICS)  # no slice without a card
