"""The controls at TINY sizes: the reference computed in float8 e4m3, put
in the program's place on the same requests, and, for the serve cell, the
port's own e4m3 weight-only UNet, both judged not correct by the run's
own checks."""
import pytest

from h100bench.lib import harness
from h100bench.tests import tiny


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.GEN])
def test_reference_in_fp8_is_not_correct(tmp_path, cell):
    bench, roots = tiny.bench_and_roots(tmp_path)
    cal = harness.load_module(harness.HERE / "calibrate.py")
    runs = []
    res = harness.run_workload(cell, 31, 1.5, False, device="cpu", bench=bench, roots=roots,
                               runs=runs)
    run = runs[0]
    driver = harness.load_module(harness.find(roots, f"drivers/{run.traffic['driver']}.py"))
    program = res["checks"]["image_rms_levels"]["value"]
    served = [c[-1] for c in run.compared]
    assert res["correct"] is True
    assert cal.put_in_place(run, driver, "fp8") is False
    assert run.checks["image_rms_levels"]["value"] > run.checks["image_rms_levels"]["limit"]
    assert run.checks["image_rms_levels"]["value"] != program
    assert all(c[-1] is not s for c, s in zip(run.compared, served))


def test_program_fp8_path_is_not_correct(tmp_path):
    bench, roots = tiny.bench_and_roots(tmp_path)
    cal = harness.load_module(harness.HERE / "calibrate.py")
    res = harness.run_workload(tiny.SERVE, 31, 1.5, False, device="cpu", bench=bench,
                               roots=roots, wrap_config=cal.program_fp8)
    assert res["correct"] is False
