"""A rehearsal of run.py's drivers at TINY sizes on the CPU (the kernels'
plain versions), with the cells' traffic and limits loaded from a
temporary directory: a new mix and cell added as files and entries only.
Also: the result line's shape, the import guard, and the refusal of a
machine without a card."""
import json
import subprocess
import sys
import types

import pytest
import torch

from h100bench.lib import harness
from h100bench.tests import tiny


@pytest.fixture()
def cells(tmp_path):
    return tiny.bench_and_roots(tmp_path)


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.GEN])
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(cells, cell, trace):
    bench, roots = cells
    res = harness.run_workload(cell, 2 ** 31 + 17, 2.0, trace, device="cpu", bench=bench,
                               roots=roots)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["image_rms_levels"]["value"] < 0.5
    want = {m["name"] for m in bench["end_to_end"] if harness.applies(m, cell)}
    if not trace:
        assert set(res["metrics"]) == want
        assert all(v["value"] > 0 for k, v in res["metrics"].items() if k != "peak_mem_gib")
    else:  # no device on the CPU: only the host's per-layer metrics are read
        assert set(res["metrics"]) <= {"tick_ms.serve", "queue_depth.serve"}
    json.dumps(res)


def test_a_new_mix_is_found_by_name(cells, tmp_path):
    bench, roots = cells
    mix = json.loads((tmp_path / "traffic" / f"{tiny.SERVE}.json").read_text())
    mix.update(rate_per_s=2.0, steps=[3])
    (tmp_path / "traffic" / "throwaway.json").write_text(json.dumps(mix))
    (tmp_path / "limits" / "tiny-throwaway.json").write_text(json.dumps({"image_rms_levels": 1.0}))
    bench["workloads"].append({"name": "tiny-throwaway", "config": "tiny-sd",
                               "traffic": "throwaway", "chips": 1, "why": "tests"})
    for m in bench["end_to_end"]:
        if "workloads" in m and tiny.SERVE in m["workloads"]:
            m["workloads"].append("tiny-throwaway")
    res = harness.run_workload("tiny-throwaway", 5, 2.0, False, device="cpu", bench=bench,
                               roots=roots)
    assert res["correct"] and res["attempted"] == 4


def test_same_seed_same_requests():
    from h100bench.drivers import generate_closed_loop as gen

    cfg = json.loads((harness.HERE / "tests/tiny_sd3.json").read_text())
    mix = json.loads((harness.HERE / "traffic/closed-b1.json").read_text())
    mix.update(prompt_tokens=[1, 5])
    def draw(seed):
        d = gen.requests(mix, cfg, (16, 16), seed, "cpu")
        return [next(d) for _ in range(4)]

    for x, y in zip(draw(2 ** 31 + 3), draw(2 ** 31 + 3)):
        assert torch.equal(x[0], y[0]) and torch.equal(x[2], y[2]) and x[3] == y[3]
    assert not torch.equal(draw(1)[0][2], draw(2)[0][2])


def test_import_guard(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "tinyfusers_tpu_torch_extra", types.ModuleType("x"))
    assert "tinyfusers_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tinyfusers_tpu.models", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert {"jax", "tinyfusers_tpu"} <= set(harness.forbidden_modules())


def test_run_refuses_a_machine_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                           "sd15-serve-poisson", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120, cwd=harness.ROOT)
    assert done.returncode != 0 and done.stdout == ""
    assert "CUDA device" in done.stderr


class _ScriptedEngine:
    """An engine whose k-th tick steps ``script[k]`` slots (then ``tail``),
    each image back at the flush."""

    def __init__(self, script, tail):
        self.script, self.tail, self.k, self.rids = script, tail, 0, []
        self.core = types.SimpleNamespace(pending=lambda: 0, active=self._active)

    def _active(self):
        return self.script[self.k] if self.k < len(self.script) else self.tail

    def make_request(self, ids, uncond, **kw):
        return len(self.rids)

    def submit(self, rid):
        self.rids.append(rid)
        return rid

    def step(self):
        self.k += 1
        return []

    def flush(self):
        return [types.SimpleNamespace(request_id=r, image=None) for r in self.rids]


@pytest.mark.parametrize("script,tail,kept,dropped", [
    ([1, 3, 3, 1, 3, 3, 3], 3, (4, 7), 1),   # a slice broken by a quiet tick, then one whole
    ([3, 3, 3], 3, (0, 3), 0),
    ([3, 3, 1, 3, 3, 1], 1, None, 2),       # never three busy ticks in a row
])
def test_serve_traces_the_first_run_of_busy_ticks(cells, script, tail, kept, dropped):
    import time

    from h100bench.drivers import engine_open_loop as drv

    bench, roots = cells
    mix = harness.load_cell(tiny.SERVE, roots, bench)[3]
    mix.update(num_slots=4, profile_ticks=3, profile_min_active=3, profile_after=0.0, drain_s=0)
    eng, slices = _ScriptedEngine(script, tail), []

    class Fake:
        def start(self):
            self.at = [eng.k]
            slices.append(self)

        def stop(self):
            self.at.append(eng.k)

    sched = [(0.0, 2, [0], 1)]
    out = drv.serve(eng, sched, mix, [0], time.perf_counter(), 0.05, trace=True, new_slice=Fake)
    assert out["dropped"] == dropped
    if kept is None:
        assert out["slice"] is None and out["slice_work"] == []
    else:
        assert tuple(out["slice"].at) == kept
        assert [a for a, _ in out["slice_work"]] == [3, 3, 3]
    assert all(len(s.at) == 2 for s in slices)   # every slice started was stopped
