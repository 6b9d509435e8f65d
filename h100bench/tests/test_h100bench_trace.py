"""The idle-share union of intervals, the idle-gap attribution, the
roofline and MFU arithmetic, on synthetic events."""
import types

import pytest
import torch

from h100bench.counts import flops
from h100bench.lib import roofline, trace

PEAK = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_union_counts_overlap_once():
    busy, gaps = trace.union_us([(0, 10), (5, 15), (20, 30), (22, 25), (40, 41)])
    assert busy == 15 + 10 + 1
    assert gaps == [(15, 20), (30, 40)]


def test_union_of_nested_and_touching():
    assert trace.union_us([(0, 100), (10, 20), (30, 40)]) == (100, [])
    assert trace.union_us([(0, 5), (5, 9)]) == (9, [])
    assert trace.union_us([]) == (0.0, [])


def test_idle_gap_goes_to_the_innermost_host_op():
    cpu = sorted([(0, 100, "bench:tick"), (10, 60, "aten::conv2d"), (20, 30, "aten::add")])
    starts = [s for s, _, _ in cpu]
    assert trace._innermost(cpu, starts, 25) == "aten::add"
    assert trace._innermost(cpu, starts, 45) == "aten::conv2d"
    assert trace._innermost(cpu, starts, 80) == "bench:tick"
    assert trace._innermost(cpu, starts, 150) == "host between CUDA calls"


def test_roofline_share():
    # a compute-bound attention call and a bandwidth-bound GEGLU call
    a = flops.attn_call(16, 4096, 4096, 8, 40, 2)
    g = flops.geglu_call(512, 5120, 1280, 2)
    small = flops.attn_call(16, 256, 256, 8, 160, 2)     # below the flash kernels' floor
    ta = a.flops / PEAK["bf16_flops_per_s"]
    tg = g.bytes / PEAK["hbm_bytes_per_s"]
    assert ta > a.bytes / PEAK["hbm_bytes_per_s"] and tg > g.flops / PEAK["bf16_flops_per_s"]
    run = types.SimpleNamespace(peak=PEAK, trace_calls=[a, a, g, small], trace={"kernel_s": {
        "void flash_fwd_wgmma<...>(...)": 8 * ta, "geglu_ff_wgmma": 4 * tg, "ampere_sgemm": 1.0}})
    assert roofline.share(run, "attn") == pytest.approx(25.0)
    assert roofline.share(run, "geglu") == pytest.approx(25.0)
    run.trace["kernel_s"] = {}
    assert roofline.share(run, "attn") is None
    run.trace, run.peak = None, PEAK
    assert roofline.share(run, "attn") is None


def test_mfu():
    assert roofline.mfu(989e12, 2.0, PEAK) == pytest.approx(50.0)
    assert roofline.mfu(1.0, 0.0, PEAK) is None and roofline.mfu(1.0, 1.0, None) is None
    assert roofline.peaks("some other card") is None


@pytest.mark.cuda
def test_slice_on_the_card(cuda_device):
    x = torch.randn(2048, 2048, device="cuda")
    s = trace.Slice()
    s.start()
    for _ in range(10):
        x = x @ x
        x = x / x.norm()
    s.stop()
    out = s.summary()
    assert out["launches"] >= 20 and 0 < out["busy_s"] <= out["window_s"]
    assert len(out["breakdown"]["device_ops"]) <= 10


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
