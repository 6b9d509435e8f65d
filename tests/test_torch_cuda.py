"""The port's CUDA kernels against their plain versions on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file
imports neither jax nor the JAX package, so it also runs on a machine
without them; there, skip tests/conftest.py (which sets up jax):

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Tolerances on ||kernel - plain|| / ||plain||: fp32 1e-5 (both exact fp32,
other summation order; TF32 is switched off); bf16 attention 1e-2 (the
kernel rounds P to bf16 against a running per-tile max, the plain version
against the row's global max); one full-width MMDiT block in fp32 1e-4
(exact fp32 on both devices, other summation orders); bf16 GEGLU 5e-4: h
is the plain version's bit for bit (test_cuda_geglu_wgmma_forms_h_exactly),
so only the fp32 sums' order differs (at most 9.6e-5 measured at SD1.5's
shapes), while h left unrounded before the product gives 1.8e-3
(chip_smoke.py phase 3 measures it); bf16 quantized matmuls 5e-4: the weight
converts to bf16 identically on both sides, so only the sums' order
differs (at most 1.2e-4 measured at SD1.5's shapes), while each rounding
hazard of the quantized formats (int4 scaled without the rounding to bf16
before the product, or with its scale rounded to bf16 first; the int8 /
fp8 scale folded into the bf16 weight) gives about 1e-3 or more
(chip_smoke.py phase 3 measures them). The flash, GEGLU and quant tests
also hold each row (_row_rel) to a limit measured on the card (see
ATTN_ROW_REL).
"""
import copy
import dataclasses
import sys

import pytest
import torch

from tinyfusers_tpu_torch.kernels.flash_attention import (
    LOG2E, _prescale, flash_bhsd, flash_bhsd_plain, flash_packed, flash_packed_plain)
from tinyfusers_tpu_torch.kernels import _build
from tinyfusers_tpu_torch.kernels import geglu_ff as gf
from tinyfusers_tpu_torch.kernels import quant_matmul as qm
from tinyfusers_tpu_torch.kernels.geglu_ff import geglu_matmul, geglu_matmul_plain
from tinyfusers_tpu_torch.kernels.quant_matmul import (
    _plan, quant_matmul, quant_matmul_int4, quant_matmul_int4_plain, quant_matmul_plain)
from tinyfusers_tpu_torch.models import mmdit
from tinyfusers_tpu_torch.models.layers import ZeroLinear, init_weights
from tinyfusers_tpu_torch.ops.linear import geglu_linear, linear
from tinyfusers_tpu_torch.ops.quant import Int4Tensor, QuantizedTensor, quantize, quantize_int4


@pytest.fixture
def cuda():
    """Decided when the test runs, never at import: every worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _row_rel(got, want):
    """The largest relative error of one row (last axis; rows of zeros in
    the plain version are skipped): a fault confined to a few rows, such as
    one batch row read wrong, barely moves _rel over thousands of rows."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    norm = w.norm(dim=1)
    keep = norm > 0
    return ((g - w).norm(dim=1)[keep] / norm[keep]).max().item()


ATTN_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
GEGLU_REL = {torch.bfloat16: 5e-4, torch.float32: 1e-5}
QUANT_REL = {torch.bfloat16: 5e-4, torch.float32: 1e-5}
# Per-row limits (_row_rel). Measured on an H100 at the main-path shapes:
# bf16 attention rows at most 3.6e-3, fp32 1.8e-6; bf16 quant-matmul rows
# at most 1.2e-3 (int4, K = 1280 over N = 320), int8 / fp8 8.7e-4; bf16
# GEGLU rows at most 1.02e-3 (K = 2560 over N = 640), fp32 8.6e-7.
ATTN_ROW_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
QUANT_ROW_REL = {torch.bfloat16: 3e-3, torch.float32: 1e-5}
GEGLU_ROW_REL = {torch.bfloat16: 3e-3, torch.float32: 1e-5}
QFORMAT_NAMES = {torch.int8: "int8", torch.float8_e4m3fn: "fp8", torch.float8_e5m2: "e5m2"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,heads,d,kv_len", [
    (2, 4096, 4096, 8, 40, None), (2, 4096, 77, 8, 40, None),
    (2, 1024, 1024, 8, 80, None), (2, 1024, 77, 8, 80, None),
    (1, 300, 80, 2, 40, 77), (1, 100, 200, 3, 128, 0),
    (2, 130, 70, 3, 36, 50),  # d % 8 != 0: read zero-padded to 40
    (2, 4224, 4224, 24, 64, 4173),  # SD3's joint attention (the TPU's multi-k kernel)
    (2, 4352, 4352, 24, 64, 4250),  # the same with T5's 77 tokens
    (2, 9216, 9216, 5, 64, None), (2, 9216, 77, 5, 64, None),  # SD2.1-v at 768x768
    (2, 2304, 2304, 10, 64, None), (2, 2304, 77, 10, 64, None),
    (2, 1024, 1024, 16, 72, None),  # DiT-XL/2 at 512x512: 16 heads of 72 (144-byte rows)
])
def test_cuda_packed_matches_plain(cuda, dtype, b, sq, sk, heads, d, kv_len):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, s, heads * d, generator=g, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    key = (b, sq, sk, heads * d, heads, sk if kv_len is None else kv_len)
    n0, s0 = flash_packed.launches, flash_packed.shapes[key]
    got = flash_packed(q, k, v, heads=heads, kv_len=kv_len)
    torch.cuda.synchronize()
    want = flash_packed_plain(q, k, v, heads=heads, kv_len=kv_len)
    assert flash_packed.launches == n0 + 1 and flash_packed.shapes[key] == s0 + 1
    assert got.dtype == dtype
    if kv_len == 0:
        assert not got.any()
    else:
        assert _rel(got, want) <= ATTN_REL[dtype]
        assert _row_rel(got, want) <= ATTN_ROW_REL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lead,sq,sk,d,causal,kv_len", [
    ((1, 1), 4096, 4096, 512, False, None), ((2, 3), 300, 300, 64, True, None),
    ((2,), 130, 300, 96, False, 250), ((1,), 256, 256, 200, True, 180),
    ((3,), 90, 150, 20, True, None),  # d % 8 != 0: read zero-padded to 24
    ((1,), 200, 300, 512, False, 250),  # d = 512: ragged kv_len, Sq % 64 != 0
    ((2,), 130, 130, 512, True, None),
    ((1, 1), 9216, 9216, 512, False, None),  # the 768x768 VAE's mid attention
])
def test_cuda_bhsd_matches_plain(cuda, dtype, lead, sq, sk, d, causal, kv_len):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(*lead, s, d, generator=g, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    key = (q.numel() // (sq * d), sq, sk, d)
    s0 = flash_bhsd.shapes[key]
    got = flash_bhsd(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_bhsd.shapes[key] == s0 + 1
    want = flash_bhsd_plain(q, k, v, causal=causal, kv_len=kv_len)
    assert _rel(got, want) <= ATTN_REL[dtype]
    assert _row_rel(got, want) <= ATTN_ROW_REL[dtype]


@pytest.mark.cuda
def test_cuda_bhsd_vae_1024_matches_plain(cuda):
    """The 1024x1024 SD3 VAE's mid attention: one d = 512 head over 16384
    tokens, through the wgmma_wide kernel."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, 1, 16384, 512, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    v0 = flash_bhsd.variants["wgmma_wide"]
    got = flash_bhsd(q, k, v)
    torch.cuda.synchronize()
    assert flash_bhsd.variants["wgmma_wide"] == v0 + 1
    want = flash_bhsd_plain(q, k, v)
    assert _rel(got, want) <= ATTN_REL[torch.bfloat16]
    assert _row_rel(got, want) <= ATTN_ROW_REL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 72, 80])
def test_cuda_packed_reads_no_other_batch_or_head(cuda, d):
    """77 keys, B = 2: a 64-key tile past key 77 and a 64-column box past d
    must read zeros, never batch 1's keys or the next head's columns. So
    batch 0's output does not move, bit for bit, when batch 1's k / v or
    another head's change."""
    g = torch.Generator(device=cuda).manual_seed(0)
    heads = 8
    q, k, v = (torch.randn(2, s, heads * d, generator=g, device=cuda).to(torch.bfloat16)
               for s in (1024, 77, 77))
    base = flash_packed(q, k, v, heads=heads)
    k2, v2 = k.clone(), v.clone()
    k2[1], v2[1] = k2[1] * 3 + 1, v2[1] * 3 + 1  # batch 1
    k2[0, :, d:], v2[0, :, d:] = 7.0, -7.0        # heads 1.. of batch 0
    got = flash_packed(q, k2, v2, heads=heads)
    torch.cuda.synchronize()
    assert torch.equal(got[0, :, :d], base[0, :, :d])
    assert not torch.equal(got[1], base[1])
    assert _rel(base, flash_packed_plain(q, k, v, heads=heads)) <= ATTN_REL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,d", [((2, 4096, 320), 40), ((2, 1024, 640), 80),
                                     ((2, 4224, 1536), 64), ((1, 4096, 512), 512)])
def test_cuda_prescale_in_kernel_matches_prescale_bit_for_bit(cuda, shape, d):
    """The kernels round q * scale * log2(e) to bf16 in shared memory as
    the plain versions' _prescale does in device memory: the kernel on q
    equals the kernel on _prescale(q) with a factor of exactly 1."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    scale = d ** -0.5
    if d == 512:  # flash_bhsd: one head
        got = flash_bhsd(q, k, v, scale=scale)
        want = flash_bhsd(_prescale(q, scale), k, v, scale=1 / LOG2E)
    else:
        heads = shape[-1] // d
        got = flash_packed(q, k, v, heads=heads, scale=scale)
        want = flash_packed(_prescale(q, scale), k, v, heads=heads, scale=1 / LOG2E)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 512])
def test_cuda_rows_with_no_key_give_zeros(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, 130, d, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    assert not flash_bhsd(q, k, v, kv_len=0).any()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_main_path_shapes_run_on_the_wgmma_kernels(cuda):
    """Every bf16 shape of the main paths goes to a TMA + wgmma variant."""
    g = torch.Generator(device=cuda).manual_seed(0)
    before = (dict(flash_packed.variants), dict(flash_bhsd.variants))
    for b, sq, sk, heads, d, kv_len in [(2, 4096, 4096, 8, 40, None), (2, 4096, 77, 8, 40, None),
                                        (2, 1024, 1024, 8, 80, None), (2, 1024, 77, 8, 80, None),
                                        (2, 4224, 4224, 24, 64, 4173)]:
        q, k, v = (torch.randn(b, s, heads * d, generator=g, device=cuda).to(torch.bfloat16)
                   for s in (sq, sk, sk))
        flash_packed(q, k, v, heads=heads, kv_len=kv_len)
    q = torch.randn(1, 1, 4096, 512, generator=g, device=cuda).to(torch.bfloat16)
    flash_bhsd(q, q, q)
    torch.cuda.synchronize()
    assert flash_packed.variants["wgmma"] == before[0].get("wgmma", 0) + 5
    assert flash_bhsd.variants["wgmma_wide"] == before[1].get("wgmma_wide", 0) + 1


@pytest.mark.cuda
def test_cuda_sd21_shapes_run_on_the_wgmma_kernels(cuda):
    """Every bf16 attention and FF shape of the SD2.1-v path at 768x768 goes
    to a TMA + wgmma variant (64-wide heads, 5 and 10 of them; 9216 tokens,
    not a power of two)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    before = (dict(flash_packed.variants), dict(flash_bhsd.variants),
              dict(geglu_matmul.variants))
    for b, sq, sk, heads in [(2, 9216, 9216, 5), (2, 9216, 77, 5), (2, 2304, 2304, 10),
                             (2, 2304, 77, 10)]:
        q, k, v = (torch.randn(b, s, heads * 64, generator=g, device=cuda).to(torch.bfloat16)
                   for s in (sq, sk, sk))
        flash_packed(q, k, v, heads=heads)
    q = torch.randn(1, 1, 9216, 512, generator=g, device=cuda).to(torch.bfloat16)
    flash_bhsd(q, q, q)
    for m, k, n in [(18432, 1280, 320), (4608, 2560, 640), (1152, 5120, 1280), (288, 5120, 1280)]:
        geglu_matmul(*_geglu_case(g, m, k, n, cuda))
    torch.cuda.synchronize()
    assert flash_packed.variants["wgmma"] == before[0].get("wgmma", 0) + 4
    assert flash_bhsd.variants["wgmma_wide"] == before[1].get("wgmma_wide", 0) + 1
    assert geglu_matmul.variants["wgmma"] == before[2].get("wgmma", 0) + 4


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip(cuda, tmp_path):
    """A bf16 model on the card, written as an fp16 checkpoint and read back
    onto the card and onto the CPU: every parameter is the seeded one after
    the same fp16 rounding, bit for bit, on both."""
    from tinyfusers_tpu_torch.io import checkpoints
    from tinyfusers_tpu_torch.pipeline import sd

    cfg = sd.SD15_QUARTER
    model = sd.StableDiffusion(cfg, device=cuda, dtype=torch.bfloat16, seed=3)
    path = tmp_path / "quarter.safetensors"
    checkpoints.save_sd_checkpoint(model, path, cfg, dtype=torch.float16)
    on_card = checkpoints.load_sd_params(path, cfg, device=cuda, dtype=torch.bfloat16)
    on_cpu = checkpoints.load_sd_params(path, cfg, device="cpu", dtype=torch.bfloat16)
    want = {n: p.to(torch.float16).to(torch.bfloat16) for n, p in model.named_parameters()}
    for loaded in (on_card, on_cpu):
        got = dict(loaded.named_parameters())
        assert got.keys() == want.keys()
        for n, w in want.items():
            assert torch.equal(got[n].to(cuda), w), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,bias", [
    (8192, 1280, 320, True), (2048, 2560, 640, True), (512, 5120, 1280, True),
    (128, 5120, 1280, True), (100, 96, 70, False),
    (70, 100, 33, True),  # K % 8 != 0 and odd N: element-wise loads and stores
    (18432, 1280, 320, True), (4608, 2560, 640, True),  # SD2.1-v at 768x768
    (1152, 5120, 1280, True), (288, 5120, 1280, True),
])
def test_cuda_geglu_matches_plain(cuda, dtype, m, k, n, bias):
    g = torch.Generator(device=cuda).manual_seed(0)
    gx, gate = torch.randn(m, 2 * k, generator=g, device=cuda).to(dtype).chunk(2, -1)
    w = (torch.randn(n, k, generator=g, device=cuda) * k ** -0.5).to(dtype).t()
    b = torch.randn(n, generator=g, device=cuda).to(dtype) if bias else None
    s0 = geglu_matmul.shapes[(m, k, n)]
    got = geglu_matmul(gx, gate, w, b)
    torch.cuda.synchronize()
    assert geglu_matmul.shapes[(m, k, n)] == s0 + 1
    want = geglu_matmul_plain(gx, gate, w, b)
    assert _rel(got, want) <= GEGLU_REL[dtype]
    assert _row_rel(got, want) <= GEGLU_ROW_REL[dtype]


def _geglu_case(g, m, k, n, device):
    """gx and gate, the strided halves of one (m, 2k) projection as the UNet
    passes them; w (k, n) seen from a module's (n, k) storage; a bf16 bias."""
    gx, gate = torch.randn(m, 2 * k, generator=g, device=device).to(torch.bfloat16).chunk(2, -1)
    w = (torch.randn(n, k, generator=g, device=device) * k ** -0.5).to(torch.bfloat16).t()
    b = torch.randn(n, generator=g, device=device).to(torch.bfloat16)
    return gx, gate, w, b


def _geglu_wgmma(gx, gate, w, b, bn, split):
    """geglu_matmul's wgmma variant at given columns per block and split,
    through the C entry (the wrapper takes them from _plan)."""
    m, k = gx.shape
    n = w.shape[1]
    wt = w.t().contiguous()
    out = torch.empty(m, n, dtype=torch.bfloat16, device=gx.device)
    _build.entry("geglu_ff", "tf_geglu_ff", gf._ARGS)(
        gf._VARIANTS["wgmma"], _build.dtype_code(gx.dtype), gx.data_ptr(), gate.data_ptr(),
        gx.stride(0), wt.data_ptr(), None if b is None else b.data_ptr(),
        _build.dtype_code(torch.float32 if b is None else b.dtype), out.data_ptr(), m, n, k,
        bn, split, torch.cuda.current_stream().cuda_stream)
    return out


GEGLU_BN = (160, 320)  # columns per block of the wgmma variant (64 rows each)
GEGLU_SPLITS = (1, 2, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (8192, 1280, 320), (2048, 2560, 640), (512, 5120, 1280), (128, 5120, 1280),
    (300, 512, 200),  # ragged M and N: rows past M and columns past N inside a tile
])
def test_cuda_geglu_wgmma_tiles_and_splits_match_plain(cuda, m, k, n):
    """Every column tile and every split (1, 2, 4) of the wgmma variant
    against the plain version with a bf16 bias; an fp32 bias gives the same
    bits (bf16 -> fp32 is exact); no bias too."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    gx, gate, w, b = _geglu_case(gen, m, k, n, cuda)
    want = geglu_matmul_plain(gx, gate, w, b)
    want_nb = geglu_matmul_plain(gx, gate, w)
    for bn in GEGLU_BN:
        for split in GEGLU_SPLITS:
            got = _geglu_wgmma(gx, gate, w, b, bn, split)
            torch.cuda.synchronize()
            assert _rel(got, want) <= GEGLU_REL[torch.bfloat16], (bn, split)
            assert _row_rel(got, want) <= GEGLU_ROW_REL[torch.bfloat16], (bn, split)
            assert torch.equal(_geglu_wgmma(gx, gate, w, b.float(), bn, split), got)
            nb = _geglu_wgmma(gx, gate, w, None, bn, split)
            assert _rel(nb, want_nb) <= GEGLU_REL[torch.bfloat16], (bn, split)


# The share of the finite bf16 gate values whose h the kernel gives bit for
# bit as the plain version does. nvcc contracts the erf polynomial into
# FMAs where PyTorch rounds each product, but after h's rounding to bf16 no
# gate value differs: measured on an H100, all 65,280 agree.
GEGLU_H_EXACT_SHARE = 1.0


@pytest.mark.cuda
def test_cuda_geglu_wgmma_forms_h_exactly(cuda):
    """gx = 1, gate holding every finite bf16 value once, W the identity
    (K = N = 256): the output is h itself. Every element is within one bf16
    ulp of the plain version's h, and the bit-equal share is at least the
    one measured on the card. Two more rows hold +inf and -inf among zero
    gates: h = +inf and NaN there, so the identity's zeros make the rest of
    each row NaN, and +inf must come out at its own column (1 / inf is 0 in
    the erf, not NaN), as in the plain version."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    vals = bits.view(torch.bfloat16)
    finite = vals[torch.isfinite(vals.float())].reshape(-1, 256)  # 255 x 256
    infs = torch.zeros(2, 256, dtype=torch.bfloat16)
    infs[0, 7], infs[1, 9] = float("inf"), float("-inf")
    gate = torch.cat([finite, infs]).to(cuda)
    gx = torch.ones_like(gate)
    w = torch.eye(256, device=cuda, dtype=torch.bfloat16)
    want = geglu_matmul_plain(gx.cpu(), gate.cpu(), w.cpu())
    assert gf._plan(torch.bfloat16, *gate.shape, 256)[0] == "wgmma"
    v0 = geglu_matmul.variants["wgmma"]
    got = geglu_matmul(gx, gate, w).cpu()
    assert geglu_matmul.variants["wgmma"] == v0 + 1
    assert torch.isfinite(got[:255].float()).all()
    assert got[255, 7].item() == float("inf") and want[255, 7].item() == float("inf")
    assert torch.equal(got[255:].isnan(), want[255:].isnan())
    assert torch.equal(got[255:].nan_to_num(), want[255:].nan_to_num())
    # bf16 bit patterns of one sign are ordered as their values
    g16, w16 = got[:255].view(torch.int16).int(), want[:255].view(torch.int16).int()
    ulps = torch.where((g16 < 0) == (w16 < 0), (g16 - w16).abs(),
                       (g16 & 0x7FFF) + (w16 & 0x7FFF))  # across zero
    assert ulps.max().item() <= 1
    assert (ulps == 0).float().mean().item() >= GEGLU_H_EXACT_SHARE
    # the mma kernel forms h with the same geglu(): the same bits, the
    # infinite gates' rows included (NaN-aware)
    out = torch.empty_like(gate)
    _build.entry("geglu_ff", "tf_geglu_ff", gf._ARGS)(
        gf._VARIANTS["mma"], _build.dtype_code(torch.bfloat16), gx.data_ptr(), gate.data_ptr(),
        256, w.data_ptr(), None, _build.dtype_code(torch.float32), out.data_ptr(),
        gate.shape[0], 256, 256, 0, 1, torch.cuda.current_stream().cuda_stream)
    out = out.cpu()
    assert torch.equal(out.isnan(), got.isnan())
    assert torch.equal(out.nan_to_num(), got.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2048, 2560, 640), (128, 5120, 1280)])
def test_cuda_geglu_wgmma_is_deterministic_and_replays_bit_for_bit(cuda, m, k, n):
    """At every split, two eager calls and a CUDA-graph replay give the same
    bits: split-K sums the cluster's partials in a fixed rank order with no
    atomics or workspace."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    gx, gate, w, b = _geglu_case(gen, m, k, n, cuda)
    for split in GEGLU_SPLITS:
        first = _geglu_wgmma(gx, gate, w, b, 320, split)
        second = _geglu_wgmma(gx, gate, w, b, 320, split)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _geglu_wgmma(gx, gate, w, b, 320, split)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            replayed = _geglu_wgmma(gx, gate, w, b, 320, split)
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first, second) and torch.equal(first, replayed), split
    _, bn, split = gf._plan(torch.bfloat16, m, k, n)  # the wrapper's own launch, too
    assert torch.equal(geglu_matmul(gx, gate, w, b), _geglu_wgmma(gx, gate, w, b, bn, split))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [100, 200])
def test_cuda_geglu_wgmma_rows_do_not_leak(cuda, m):
    """Rows past M inside a tile are TMA's zeros: changing the last row of
    gx and gate leaves the other output rows unchanged, bit for bit, and
    moves the last, at every tile and split."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    gx, gate, w, b = _geglu_case(gen, m, 1280, 640, cuda)
    gx2, gate2 = gx.clone(), gate.clone()
    gx2[-1] = gx2[-1] * 3 + 1
    gate2[-1] = gate2[-1] - 1
    for bn in GEGLU_BN:
        for split in (1, 4):
            base = _geglu_wgmma(gx, gate, w, b, bn, split)
            got = _geglu_wgmma(gx2, gate2, w, b, bn, split)
            torch.cuda.synchronize()
            assert torch.equal(got[:-1], base[:-1]), (bn, split)
            assert not torch.equal(got[-1], base[-1]), (bn, split)


@pytest.mark.cuda
def test_cuda_geglu_variants_are_counted(cuda):
    """wgmma for a main-path bf16 shape, mma for a ragged-K bf16 shape and
    for a misaligned row stride, fma for fp32: each launch counted once
    under its variant; no copy of the strided halves on the wgmma path."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    before = dict(geglu_matmul.variants)
    for m, k, n, dtype in [(512, 5120, 1280, torch.bfloat16), (70, 100, 32, torch.bfloat16),
                           (128, 256, 64, torch.float32)]:
        gx, gate = torch.randn(m, 2 * k, generator=gen, device=cuda).to(dtype).chunk(2, -1)
        geglu_matmul(gx, gate, torch.randn(k, n, generator=gen, device=cuda).to(dtype))
    proj = torch.randn(64, 2 * 128 + 4, generator=gen, device=cuda).to(torch.bfloat16)
    gx, gate = proj[:, :128], proj[:, 130:258]  # row stride 260: not 16-byte rows
    geglu_matmul(gx, gate, torch.randn(128, 64, generator=gen, device=cuda).to(torch.bfloat16))
    torch.cuda.synchronize()
    got = {v: geglu_matmul.variants[v] - before.get(v, 0) for v in ("wgmma", "mma", "fma")}
    assert got == {"wgmma": 1, "mma": 2, "fma": 1}


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_packed(x, x, x, heads=2)
    with pytest.raises(TypeError):
        geglu_matmul(x, x, torch.zeros(16, 4, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        flash_bhsd(x.float(), x.float(), x.float(), kv_len=9)
    odd = torch.zeros(1 + 8 * 64, device=cuda, dtype=torch.bfloat16)[1:].view(1, 8, 64)
    with pytest.raises(ValueError, match="aligned"):  # TMA reads 16-byte aligned rows
        flash_packed(odd, odd, odd, heads=1)
    with pytest.raises(ValueError):  # no plain fallback for a weight it cannot take
        geglu_linear(x.float(), x.float(), torch.zeros(2, 16, 4, device=cuda))


QUANT_SHAPES = [  # (M, K, N, bias): SD1.5 calls, then ragged edges
    (2, 1280, 320, True), (154, 768, 640, False), (8192, 320, 320, False),
    (512, 5120, 1280, True),
    (37, 96, 40, True),   # K % 16 != 0: element-wise weight loads
    (5, 72, 33, True),    # K % 16 != 0, odd N
]
# The quantized MMDiT's and DiT's calls: M = 2 (the CFG batch's conditioning
# MLPs), M = 154 (the context embedding), N = 64 (SD3's final projection),
# N = 16 (DiT-XL/2's, at 256x256).
TRANSFORMER_QUANT_SHAPES = [(2, 256, 1536, True), (2, 1536, 3072, True),
                            (154, 4096, 1536, True), (8192, 1536, 64, True),
                            (512, 1152, 16, True)]
QUANT_SHAPES = QUANT_SHAPES + TRANSFORMER_QUANT_SHAPES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("wdtype", list(QFORMAT_NAMES))
@pytest.mark.parametrize("m,k,n,bias", QUANT_SHAPES)
def test_cuda_quant_matmul_matches_plain(cuda, dtype, wdtype, m, k, n, bias):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = quantize(torch.randn(n, k, generator=g, device=cuda).t() * k ** -0.5, wdtype)
    b = torch.randn(n, generator=g, device=cuda).to(dtype) if bias else None
    key = (QFORMAT_NAMES[wdtype], m, k, n)
    s0 = quant_matmul.shapes[key]
    got = quant_matmul(x, w, b)
    torch.cuda.synchronize()
    assert quant_matmul.shapes[key] == s0 + 1 and got.dtype == dtype
    want = quant_matmul_plain(x, w, b)
    assert _rel(got, want) <= QUANT_REL[dtype]
    assert _row_rel(got, want) <= QUANT_ROW_REL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,bias", QUANT_SHAPES + [(37, 130, 40, True)])  # g = 2
def test_cuda_quant_matmul_int4_matches_plain(cuda, dtype, m, k, n, bias):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = quantize_int4(torch.randn(n, k, generator=g, device=cuda).t() * k ** -0.5, axis=0)
    b = torch.randn(n, generator=g, device=cuda).to(dtype) if bias else None
    key = (m, k, n, w.group_size)
    s0 = quant_matmul_int4.shapes[key]
    got = quant_matmul_int4(x, w, b)
    torch.cuda.synchronize()
    assert quant_matmul_int4.shapes[key] == s0 + 1 and got.dtype == dtype
    want = quant_matmul_int4_plain(x, w, b)
    assert _rel(got, want) <= QUANT_REL[dtype]
    assert _row_rel(got, want) <= QUANT_ROW_REL[dtype]


def _int4_weight(cuda, g, n, k, group_size=64):
    """Seeded int4 weight in a model's layout: (N, K/2) bytes and (N, K/g)
    scales in storage, (K/2, N) and (K/g, N) views, as layers.Linear holds it."""
    w = quantize_int4(torch.randn(n, k, generator=g, device=cuda).t() * k ** -0.5, axis=0,
                      group_size=group_size)
    return Int4Tensor(w.packed.t().contiguous().t(), w.scales.t().contiguous().t(), axis=0,
                      group_size=w.group_size, orig_dim=k)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,g,tile,split", [
    (2, 1280, 320, 64, 8, 8), (2, 1280, 1280, 64, 8, 5), (2, 1280, 1088, 64, 8, 6),
    (2, 1536, 1536, 64, 8, 4), (154, 768, 320, 64, 64, 7), (154, 768, 640, 64, 64, 3),
    (154, 768, 1280, 64, 64, 2), (128, 1280, 1280, 64, 128, 5), (512, 5120, 1280, 64, 128, 4),
    (512, 1280, 1280, 64, 128, 1), (2048, 2560, 640, 64, 160, 2), (8192, 320, 320, 64, 160, 1),
    (8192, 5120, 320, 32, 160, 5),
    (37, 768, 40, 64, 64, 8),  # ragged M and N
    (300, 512, 200, 64, 128, 8),  # ragged M and N over three row tiles
    (154, 640, 320, 32, 64, 7), (64, 1280, 320, 128, 64, 8),  # g = 32, 128
])
def test_cuda_int4_wgmma_tiles_and_splits_match_plain(cuda, m, k, n, g, tile, split):
    """Each x-row tile (8, 64, 128, 160) and each split count (1-8) of the
    wgmma variant, ragged M and N, and g = 32 / 64 / 128, against the plain
    version with a bf16 bias."""
    assert _plan(torch.bfloat16, m, k, n, g) == ("wgmma", tile, split)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    w = _int4_weight(cuda, gen, n, k, g)
    b = torch.randn(n, generator=gen, device=cuda).to(torch.bfloat16)
    v0 = quant_matmul_int4.variants["wgmma"]
    got = quant_matmul_int4(x, w, b)
    torch.cuda.synchronize()
    assert quant_matmul_int4.variants["wgmma"] == v0 + 1
    want = quant_matmul_int4_plain(x, w, b)
    assert _rel(got, want) <= QUANT_REL[torch.bfloat16]
    assert _row_rel(got, want) <= QUANT_ROW_REL[torch.bfloat16]
    # the bias is read in its own dtype: bf16 -> fp32 is exact
    assert torch.equal(quant_matmul_int4(x, w, b.float()), got)
    assert _rel(quant_matmul_int4(x, w), quant_matmul_int4_plain(x, w)) \
        <= QUANT_REL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2, 1280, 320), (154, 768, 640), (512, 5120, 1280),
                                   (8192, 320, 320)])
def test_cuda_int4_wgmma_is_deterministic_and_replays_bit_for_bit(cuda, m, k, n):
    """Split-K sums the cluster's partials in a fixed rank order with no
    atomics or workspace: two eager calls and a CUDA-graph replay give the
    same bits."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    w = _int4_weight(cuda, gen, n, k)
    b = torch.randn(n, generator=gen, device=cuda).to(torch.bfloat16)
    first = quant_matmul_int4(x, w, b)
    second = quant_matmul_int4(x, w, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        quant_matmul_int4(x, w, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        replayed = quant_matmul_int4(x, w, b)
    replayed.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, replayed)


@pytest.mark.cuda
def test_cuda_int4_wgmma_rows_do_not_leak(cuda):
    """M = 2 runs as an 8-row tile that TMA pads with zeros: changing x's
    row 1 leaves output row 0 unchanged, bit for bit, and moves row 1."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 1280, generator=gen, device=cuda).to(torch.bfloat16)
    w = _int4_weight(cuda, gen, 1280, 1280)
    base = quant_matmul_int4(x, w)
    x2 = x.clone()
    x2[1] = x2[1] * 3 + 1
    got = quant_matmul_int4(x2, w)
    torch.cuda.synchronize()
    assert torch.equal(got[0], base[0]) and not torch.equal(got[1], base[1])


@pytest.mark.cuda
def test_cuda_int4_variants_are_counted(cuda):
    """wgmma for a main-path bf16 shape, mma for a ragged-K bf16 shape,
    fma for fp32: each launch counted once under its variant."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    before = dict(quant_matmul_int4.variants)
    for m, k, n, dtype in [(2, 1280, 320, torch.bfloat16), (37, 96, 40, torch.bfloat16),
                           (2, 1280, 320, torch.float32)]:
        x = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
        quant_matmul_int4(x, _int4_weight(cuda, gen, n, k))
    torch.cuda.synchronize()
    got = {v: quant_matmul_int4.variants[v] - before.get(v, 0) for v in ("wgmma", "mma", "fma")}
    assert got == {"wgmma": 1, "mma": 1, "fma": 1}


def _byte_weight(cuda, g, n, k, wdtype):
    """Seeded int8 / fp8 weight in a model's layout: (N, K) values in
    storage, seen as (K, N), as layers.Linear holds it."""
    w = quantize(torch.randn(n, k, generator=g, device=cuda).t() * k ** -0.5, wdtype)
    return QuantizedTensor(w.values.t().contiguous().t(), w.scales)


def _byte_wgmma(x, w, b, tile, split):
    """quant_matmul's wgmma variant at a given x-row tile and split,
    through the C entry (the wrapper takes them from _plan)."""
    m, k = x.shape
    n = w.values.shape[1]
    rows, scales = w.values.t().contiguous(), w.scales.reshape(-1).float().contiguous()
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    _build.entry("quant_matmul", "tf_quant_matmul", qm._ARGS)(
        qm._VARIANTS["wgmma"], _build.dtype_code(x.dtype), qm._FORMATS[w.values.dtype][0],
        x.data_ptr(), rows.data_ptr(), scales.data_ptr(), None if b is None else b.data_ptr(),
        _build.dtype_code(torch.float32 if b is None else b.dtype), out.data_ptr(), m, n, k, 0,
        tile, split, torch.cuda.current_stream().cuda_stream)
    return out


# x-row tile -> (an SD1.5 shape, a ragged M and N shape) of that tile
BYTE_TILE_SHAPES = {8: [(2, 1280, 320), (5, 640, 72)], 64: [(154, 768, 640), (37, 768, 40)],
                    128: [(128, 1280, 1280), (300, 512, 200)],
                    160: [(2048, 2560, 640), (1100, 640, 136)]}


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", list(QFORMAT_NAMES))
@pytest.mark.parametrize("tile", list(BYTE_TILE_SHAPES))
def test_cuda_quant_wgmma_tiles_and_splits_match_plain(cuda, wdtype, tile):
    """Each x-row tile of quant_matmul's wgmma variant with every split
    1-8, at an SD1.5 shape and at ragged M and N, against the plain
    version with a bf16 bias; a bf16 and an fp32 bias give the same bits,
    and no bias matches too."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for m, k, n in BYTE_TILE_SHAPES[tile]:
        x = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
        w = _byte_weight(cuda, gen, n, k, wdtype)
        b = torch.randn(n, generator=gen, device=cuda).to(torch.bfloat16)
        want, want_nb = quant_matmul_plain(x, w, b), quant_matmul_plain(x, w)
        for split in range(1, 9):
            got = _byte_wgmma(x, w, b, tile, split)
            torch.cuda.synchronize()
            assert _rel(got, want) <= QUANT_REL[torch.bfloat16], (m, k, n, split)
            assert _row_rel(got, want) <= QUANT_ROW_REL[torch.bfloat16], (m, k, n, split)
            assert torch.equal(_byte_wgmma(x, w, b.float(), tile, split), got)
            assert _rel(_byte_wgmma(x, w, None, tile, split), want_nb) \
                <= QUANT_REL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", list(QFORMAT_NAMES))
def test_cuda_quant_wgmma_decodes_every_byte_exactly(cuda, wdtype):
    """All 256 byte values of the format through the wgmma variant with
    one-hot x rows, scale 1 and no bias: each output is one weight, which
    must equal values.to(bfloat16) exactly. Every value sits at every K
    position of the fragment (W[k, n] = (k + n) % 256). A NaN or inf code
    is kept once, in a column of its own (elsewhere it becomes 0), since 0
    times it is NaN in the other rows; there the output must equal the
    plain version NaN for NaN."""
    k = n = m = 256
    codes = (torch.arange(k)[:, None] + torch.arange(n)[None, :]) % 256
    decoded = codes.to(torch.uint8).view(wdtype).float()
    special = [v for v in range(256) if not torch.isfinite(decoded[v, 0])]
    kept = {}  # special code -> (k, n) where it is kept
    for i, v in enumerate(special):
        codes[codes == v] = 0
        col = 8 * i + 3
        kept[v] = ((v - col) % 256, col)
        codes[kept[v]] = v
    values = codes.to(torch.uint8).t().contiguous().t().view(wdtype).to(cuda)  # (N, K) storage
    w = QuantizedTensor(values, torch.ones(1, n, device=cuda))
    x = torch.eye(m, device=cuda).to(torch.bfloat16)
    v0 = quant_matmul.variants["wgmma"]
    got = quant_matmul(x, w).float()
    torch.cuda.synchronize()
    assert quant_matmul.variants["wgmma"] == v0 + 1
    want = values.to(torch.bfloat16).float()
    clean = [c for c in range(n) if c not in {col for _, col in kept.values()}]
    assert torch.equal(got[:, clean], want[:, clean])
    for kk, col in kept.values():
        assert torch.equal(got[kk, col], want[kk, col]) or (got[kk, col].isnan()
                                                           and want[kk, col].isnan())
    plain = quant_matmul_plain(x, w).float()
    assert torch.equal(got.isnan(), plain.isnan())
    assert torch.equal(got[~got.isnan()], plain[~plain.isnan()])


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", list(QFORMAT_NAMES))
def test_cuda_quant_wgmma_is_deterministic_and_replays_bit_for_bit(cuda, wdtype):
    """At every split 1-8, two eager calls and a CUDA-graph replay give the
    same bits: split-K sums the cluster's partials in a fixed rank order,
    then scales, with no atomics or workspace."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    m, k, n = 154, 768, 640
    x = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    w = _byte_weight(cuda, gen, n, k, wdtype)
    b = torch.randn(n, generator=gen, device=cuda).to(torch.bfloat16)
    for split in range(1, 9):
        first = _byte_wgmma(x, w, b, 64, split)
        second = _byte_wgmma(x, w, b, 64, split)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _byte_wgmma(x, w, b, 64, split)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            replayed = _byte_wgmma(x, w, b, 64, split)
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first, second) and torch.equal(first, replayed), split
    tile, split = _plan(torch.bfloat16, m, k, n)[1:]  # the wrapper's own launch, too
    assert torch.equal(quant_matmul(x, w, b), _byte_wgmma(x, w, b, tile, split))


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", list(QFORMAT_NAMES))
@pytest.mark.parametrize("m,k,n", [(2, 1280, 1280), (37, 768, 640)])
def test_cuda_quant_wgmma_rows_do_not_leak(cuda, wdtype, m, k, n):
    """Rows past M are TMA's zeros: changing x's last row leaves the other
    output rows unchanged, bit for bit, and moves the last."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    w = _byte_weight(cuda, gen, n, k, wdtype)
    base = quant_matmul(x, w)
    x2 = x.clone()
    x2[-1] = x2[-1] * 3 + 1
    got = quant_matmul(x2, w)
    torch.cuda.synchronize()
    assert torch.equal(got[:-1], base[:-1]) and not torch.equal(got[-1], base[-1])


@pytest.mark.cuda
def test_cuda_quant_variants_are_counted(cuda):
    """quant_matmul: wgmma for a main-path bf16 shape, mma for a ragged-K
    bf16 shape, fma for fp32: each launch counted once under its variant."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    before = dict(quant_matmul.variants)
    for m, k, n, dtype in [(2, 1280, 320, torch.bfloat16), (37, 96, 40, torch.bfloat16),
                           (2, 1280, 320, torch.float32)]:
        x = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
        quant_matmul(x, _byte_weight(cuda, gen, n, k, torch.int8))
    torch.cuda.synchronize()
    got = {v: quant_matmul.variants[v] - before.get(v, 0) for v in ("wgmma", "mma", "fma")}
    assert got == {"wgmma": 1, "mma": 1, "fma": 1}


@pytest.mark.cuda
def test_cuda_quantized_linear_launches_the_kernels(cuda):
    x = torch.randn(3, 7, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(64, 48, device=cuda)
    counts = (quant_matmul.launches, quant_matmul_int4.launches, geglu_matmul.launches)
    y8 = linear(x, quantize(w, torch.int8))
    y4 = geglu_linear(x, x, quantize_int4(w, axis=0))  # a quantized FF weight: no GEGLU kernel
    torch.cuda.synchronize()
    assert y8.shape == y4.shape == (3, 7, 48)
    assert (quant_matmul.launches, quant_matmul_int4.launches,
            geglu_matmul.launches) == (counts[0] + 1, counts[1] + 1, counts[2])


@pytest.mark.cuda
def test_cuda_quant_wrappers_raise_and_never_fall_back(cuda):
    x = torch.randn(4, 64, device=cuda)
    w = torch.randn(64, 32, device=cuda)
    with pytest.raises(ValueError, match="axis 0"):  # packed on the wrong axis
        quant_matmul_int4(x, quantize_int4(w.t(), axis=1))
    with pytest.raises(TypeError):  # a dtype the kernel does not take
        quant_matmul(x.half(), quantize(w))
    q = quantize(w)
    with pytest.raises(TypeError):  # a weight format the kernel does not take
        quant_matmul(x, QuantizedTensor(q.values.view(torch.uint8), q.scales))
    with pytest.raises(ValueError, match="one CUDA device"):  # CPU weight, CUDA x
        quant_matmul(x, quantize(w.cpu()))
    with pytest.raises(ValueError, match="one CUDA device"):
        quant_matmul_int4(x, quantize_int4(w.cpu(), axis=0))
    with pytest.raises(ValueError, match="K mismatch"):
        quant_matmul(x[:, :32], quantize(w))


@pytest.mark.cuda
def test_cuda_full_width_mmdit_block_matches_cpu(cuda):
    """One SD3-medium joint block (1536 wide, 24 heads) at a 64x64 latent:
    1024 image + 77 text tokens, the text padded to a joint 1152 with
    kv_len 1101, through the packed kernel on the card and the math route
    on the CPU. The adaLN leaves are filled (zeros at init would keep the
    attention out of the output)."""
    cfg = dataclasses.replace(mmdit.SD3_MEDIUM, depth=1)
    model = mmdit.MMDiT(cfg, device=cuda)
    init_weights(model, 0)
    g = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        for leaf in model.modules():
            if isinstance(leaf, ZeroLinear):
                leaf.weight.copy_(torch.randn(leaf.weight.shape, generator=g, device=cuda)
                                  * leaf.weight.shape[1] ** -0.5)
                leaf.bias.copy_(torch.randn(leaf.bias.shape, generator=g, device=cuda) * 0.1)
    on_cpu = copy.deepcopy(model).to("cpu")
    img, txt = (torch.randn(2, n, 1536, generator=g, device=cuda) for n in (1024, 128))
    c = torch.randn(2, 1536, generator=g, device=cuda)
    key = (2, 1152, 1152, 1536, 24, 1101)
    s0 = flash_packed.shapes[key]
    with torch.no_grad():
        got = mmdit._block(model.blocks[0], img, txt, c, cfg, kv_len=1101)
        torch.cuda.synchronize()
        assert flash_packed.shapes[key] == s0 + 1
        want = mmdit._block(on_cpu.blocks[0], img.cpu(), txt.cpu(), c.cpu(), cfg, kv_len=1101)
    for a, b in zip(got, want):
        assert _rel(a.cpu(), b) <= 1e-4


# --- the SD1.x surface beyond text to image: hires fix, batch-1 branches,
# VAE encode, the text towers' bf16 GELU -------------------------------------

HIRES_PACKED = [(2, 16384, 77, 8, 40), (2, 4096, 4096, 8, 80), (2, 4096, 77, 8, 80),
                (2, 1024, 1024, 8, 160), (2, 1024, 77, 8, 160)]
B1_PACKED = [(1, 4096, 4096, 8, 40), (1, 4096, 77, 8, 40), (1, 1024, 1024, 8, 80),
             (1, 1024, 77, 8, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,heads,d", HIRES_PACKED + B1_PACKED)
def test_cuda_hires_and_batch1_packed_match_plain(cuda, b, sq, sk, heads, d):
    """The hires fix's 1024x1024 levels (8 heads of 40, 80 and 160 packed:
    d = 160 on wgmma_wide, with 77-key cross attention) and SD1.5's shapes at
    batch 1 (DeepCache with cached CFG), bf16, on a TMA + wgmma variant."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, s, heads * d, generator=g, device=cuda).to(torch.bfloat16)
               for s in (sq, sk, sk))
    before = dict(flash_packed.variants)
    got = flash_packed(q, k, v, heads=heads)
    torch.cuda.synchronize()
    variant = "wgmma" if d <= 128 else "wgmma_wide"
    assert flash_packed.variants[variant] == before.get(variant, 0) + 1
    want = flash_packed_plain(q, k, v, heads=heads)
    assert _rel(got, want) <= ATTN_REL[torch.bfloat16]
    assert _row_rel(got, want) <= ATTN_ROW_REL[torch.bfloat16]


# SDXL-base at 1024x1024: 10 heads of 64 over the 64x64 level's 4096
# tokens, 20 over the 32x32 level's 1024, self and 77-key cross attention
XL_PACKED = [(2, 4096, 4096, 10, 64), (2, 4096, 77, 10, 64), (2, 1024, 1024, 20, 64),
             (2, 1024, 77, 20, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,heads,d", XL_PACKED)
def test_cuda_sdxl_packed_matches_plain(cuda, b, sq, sk, heads, d):
    """SDXL-base's four flash_packed shapes, bf16, on the wgmma variant, each
    counted under its call shape."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(b, s, heads * d, generator=g, device=cuda).to(torch.bfloat16)
               for s in (sq, sk, sk))
    key = (b, sq, sk, heads * d, heads, sk)
    n0, w0 = flash_packed.shapes[key], flash_packed.variants["wgmma"]
    got = flash_packed(q, k, v, heads=heads)
    torch.cuda.synchronize()
    assert flash_packed.shapes[key] == n0 + 1 and flash_packed.variants["wgmma"] == w0 + 1
    want = flash_packed_plain(q, k, v, heads=heads)
    assert _rel(got, want) <= ATTN_REL[torch.bfloat16]
    assert _row_rel(got, want) <= ATTN_ROW_REL[torch.bfloat16]


@pytest.mark.cuda
def test_cuda_hires_128_self_attention_matches_plain_over_row_chunks(cuda):
    """The hires 128x128 self attention (2, 16384, 16384, 320), 8 heads of
    40: its plain version's fp32 logits would be 17 GB, so it is taken over
    chunks of 2048 query rows with all keys each (rows are independent)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 16384, 320, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    got = flash_packed(q, k, v, heads=8)
    torch.cuda.synchronize()
    for i in range(0, 16384, 2048):
        want = flash_packed_plain(q[:, i:i + 2048], k, v, heads=8)
        part = got[:, i:i + 2048]
        assert _rel(part, want) <= ATTN_REL[torch.bfloat16]
        assert _row_rel(part, want) <= ATTN_ROW_REL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(32768, 1280, 320), (8192, 2560, 640), (2048, 5120, 1280),
                                   (4096, 1280, 320), (1024, 2560, 640), (256, 5120, 1280),
                                   (64, 5120, 1280)])
def test_cuda_hires_and_batch1_geglu_match_plain(cuda, m, k, n):
    """geglu at the hires fix's three new FF shapes and SD1.5's at batch 1,
    bf16, on the wgmma variant."""
    g = torch.Generator(device=cuda).manual_seed(0)
    gx, gate, w, b = _geglu_case(g, m, k, n, cuda)
    before = geglu_matmul.variants["wgmma"]
    got = geglu_matmul(gx, gate, w, b)
    torch.cuda.synchronize()
    assert geglu_matmul.variants["wgmma"] == before + 1
    want = geglu_matmul_plain(gx, gate, w, b)
    assert _rel(got, want) <= GEGLU_REL[torch.bfloat16]
    assert _row_rel(got, want) <= GEGLU_ROW_REL[torch.bfloat16]


@pytest.mark.cuda
def test_cuda_vae_encode_512_matches_cpu(cuda):
    """The SD VAE's encoder at full width on a 512x512 image in fp32, card
    (its mid attention through flash_bhsd's exact fp32 kernel) against the
    CPU: 1e-3 relative, as chip_smoke.py holds the UNet (fp32 with TF32
    off on both devices; summation order over ~30 layers)."""
    from tinyfusers_tpu_torch.models import vae
    from tinyfusers_tpu_torch.models.layers import init_weights

    gpu = vae.AutoencoderKL(vae.SD_VAE_CONFIG, device=cuda, dtype=torch.float32)
    init_weights(gpu, 5)
    cpu = vae.AutoencoderKL(vae.SD_VAE_CONFIG, device="cpu", dtype=torch.float32)
    cpu.load_state_dict(gpu.state_dict())
    x = torch.rand((1, 512, 512, 3), generator=torch.Generator().manual_seed(6)) * 2 - 1
    n0 = flash_bhsd.shapes[(1, 4096, 4096, 512)]
    with torch.inference_mode():
        got = vae.encode(gpu, x.to(cuda))
        torch.cuda.synchronize()
        want = vae.encode(cpu, x)
    assert flash_bhsd.shapes[(1, 4096, 4096, 512)] == n0 + 1
    assert tuple(got.shape) == (1, 64, 64, 4)
    assert _rel(got.cpu(), want) <= 1e-3


# The bf16 values where CUDA's erfcf and the CPU's give erfc results that
# round to different bf16 GELU outputs (counted on an H100; chip_smoke.py's
# [gelu] line prints them).
GELU_CARD_DIFFS = 0


@pytest.mark.cuda
def test_cuda_gelu_erf_bf16_equals_the_cpu(cuda):
    """ops.gelu_erf (the text towers' exact GELU, JAX's jit form) over every
    finite bf16 value on the card, against the CPU, which equals the JAX
    package at every normal value (tests/test_torch_ops.py)."""
    from tinyfusers_tpu_torch.ops import gelu_erf

    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = bits[torch.isfinite(bits)]
    got = gelu_erf(x.to(cuda)).cpu()
    want = gelu_erf(x)
    assert got.dtype == torch.bfloat16
    assert int((got.float() != want.float()).sum()) == GELU_CARD_DIFFS


def _serve_engine(cuda, slots=2, **kw):
    from tinyfusers_tpu_torch.pipeline import sd
    from tinyfusers_tpu_torch.serve import Engine

    model = sd.StableDiffusion(sd.TINY, device=cuda, dtype=torch.bfloat16, seed=4)
    return model, Engine(model, num_slots=slots, **kw)


def _serve_request(eng, seed, steps, tok=7):
    import numpy as np

    n = eng.cfg.clip.max_length
    return eng.make_request(np.full((n,), tok, np.int32), np.zeros((n,), np.int32),
                            num_steps=steps, seed=seed)


@pytest.mark.cuda
def test_cuda_serve_join_matches_solo(cuda):
    """On the card, in bf16: a request that joins a busy engine mid-flight
    gives the image it gives alone, bit for bit."""
    from tinyfusers_tpu_torch.serve import Engine

    model, eng = _serve_engine(cuda)
    eng.submit(_serve_request(eng, seed=1, steps=5, tok=3))
    eng.step()
    eng.step()
    late = _serve_request(eng, seed=5, steps=3)
    eng.submit(late)
    joined = {r.request_id: r.image for r in eng.run_until_idle()}[late.request_id]
    solo = Engine(model, num_slots=2)
    solo.submit(_serve_request(solo, seed=5, steps=3))
    alone = solo.run_until_idle()[0].image
    assert joined.shape == (32, 32, 3) and (joined == alone).all()


def _counts_since(before):
    """How much each kernel wrapper's (launches, shapes, variants) grew
    since ``before`` (a counters.snapshot())."""
    from tinyfusers_tpu_torch.kernels import counters

    return [(a[0] - b[0], a[1] - b[1], a[2] - b[2])
            for a, b in zip(counters.snapshot(), before)]


@pytest.mark.cuda
def test_cuda_serve_graph_replays_the_eager_step_bit_for_bit(cuda):
    """A 4-slot engine replays its captured slot step; beside it an engine
    on the same model runs the step eagerly (its graph dropped, as on a
    mesh). TINY at 64x64, so that the 32x32 latent's 1024 tokens take
    flash_packed and its FF tails geglu. Requests of 3 and 5 steps join and
    leave mid-run, a queue included: after every tick the latents are equal
    bit for bit, the replays are the ticks with an active slot, and the
    kernel wrappers' launches, shapes and variants grew as the eager
    engine's did. After a reset the same graph serves a new request."""
    from tinyfusers_tpu_torch.kernels import counters
    from tinyfusers_tpu_torch.pipeline import sd
    from tinyfusers_tpu_torch.serve import Engine

    cfg = dataclasses.replace(sd.TINY, height=64, width=64)
    model = sd.StableDiffusion(cfg, device=cuda, dtype=torch.bfloat16, seed=4)
    eng, eager = Engine(model, num_slots=4), Engine(model, num_slots=4)
    eager._graph = None
    assert eng._graph is not None
    assert (eng.stats["graph_steps"], eng.stats["eager_steps"]) == (0, 1)
    assert eager._rows.apart == eng._rows.apart
    joining = {0: [5, 3], 1: [3], 3: [5, 3, 3], 4: [5], 7: [3]}  # tick -> step counts
    grown = {id(eng): [], id(eager): []}
    images = {id(eng): {}, id(eager): {}}
    stepping, t = 0, 0
    while t <= max(joining) or eng.core.active() or eng.core.pending():
        for e in (eng, eager):
            before = counters.snapshot()
            for i, steps in enumerate(joining.get(t, [])):
                e.submit(_serve_request(e, seed=10 * t + i, steps=steps, tok=3 + i))
            if e is eng:
                stepping += bool(e.core.active() or e.core.pending())
            images[id(e)].update((r.request_id, r.image) for r in e.step())
            grown[id(e)].append(_counts_since(before))
        assert torch.equal(eng.latents, eager.latents), f"tick {t}"
        t += 1
    for e in (eng, eager):
        images[id(e)].update((r.request_id, r.image) for r in e.flush())
    assert stepping > 8 and eng.stats["graph_steps"] == stepping
    assert eng.stats["eager_steps"] == 1 and eager.stats["graph_steps"] == 0
    assert eager.stats["eager_steps"] == 1 + stepping
    assert grown[id(eng)] == grown[id(eager)]
    assert sum(g[0][0] for g in grown[id(eng)]) > 0 and sum(g[2][0] for g in grown[id(eng)]) > 0
    assert images[id(eng)].keys() == images[id(eager)].keys() and len(images[id(eng)]) == 8
    for rid, img in images[id(eng)].items():
        assert (img == images[id(eager)][rid]).all(), rid

    graph, replays = eng._graph, eng.stats["graph_steps"]
    for e in (eng, eager):
        e.reset()
        e.submit(_serve_request(e, seed=99, steps=3))
    again, want = eng.run_until_idle(), eager.run_until_idle()
    assert eng._graph is graph and eng.stats["graph_steps"] == replays + 3
    assert (again[0].image == want[0].image).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_cuda_quantized_serve_join_matches_solo(cuda, quant):
    """The same over a UNet quantized by quantize_params: its linears go
    to the quant kernels at tiles picked from M, its convs dequantize."""
    from tinyfusers_tpu_torch.io.quantize_tree import QDTYPES, quantize_params
    from tinyfusers_tpu_torch.serve import Engine

    model, _ = _serve_engine(cuda)
    quantize_params(model.unet, QDTYPES[quant])
    eng = Engine(model, num_slots=2)
    eng.submit(_serve_request(eng, seed=1, steps=5, tok=3))
    eng.step()
    eng.step()
    late = _serve_request(eng, seed=5, steps=3)
    eng.submit(late)
    launches = quant_matmul.launches + quant_matmul_int4.launches
    joined = {r.request_id: r.image for r in eng.run_until_idle()}[late.request_id]
    assert quant_matmul.launches + quant_matmul_int4.launches > launches
    solo = Engine(model, num_slots=2)
    solo.submit(_serve_request(solo, seed=5, steps=3))
    alone = solo.run_until_idle()[0].image
    assert joined.shape == (32, 32, 3) and (joined == alone).all()


@pytest.mark.cuda
def test_cuda_clip_scorer_matches_cpu(cuda):
    """The CLIP scorer in fp32 (TF32 off) at ViT-L/14's 224² patch geometry
    and a narrow width, on the card against the same weights on the CPU:
    the unnormalized image features within 1e-4 relative (exact fp32 on
    both, other summation orders; its 257-token attention takes the math
    route, no kernel), the scores within 1e-4."""
    import numpy as np

    from tinyfusers_tpu_torch.eval import clip_score, fid
    from tinyfusers_tpu_torch.models import clip, clip_vision

    tcfg = clip.CLIPConfig(dim=256, num_layers=2, num_heads=4, mlp_dim=1024, projection_dim=128)
    vcfg = clip_vision.CLIPVisionConfig(dim=256, num_layers=2, num_heads=4, mlp_dim=1024,
                                        projection_dim=128)
    gpu = clip_score.CLIPScorer(tcfg, vcfg, device=cuda, seed=3)
    cpu = clip_score.CLIPScorer(tcfg, vcfg, device="cpu", seed=None)
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (3, 512, 512, 3), dtype=np.uint8)
    ids = np.full((3, 77), 49407, np.int64)
    ids[:, 0] = 49406
    ids[:, 1:6] = rng.integers(1, 49406, (3, 5))
    flash0 = flash_packed.launches + flash_bhsd.launches
    got, want = fid.clip_features(gpu, images), fid.clip_features(cpu, images)
    assert flash_packed.launches + flash_bhsd.launches == flash0
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-4
    np.testing.assert_allclose(clip_score.clip_score(gpu, images, ids),
                               clip_score.clip_score(cpu, images, ids), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_serve_ticks_do_not_synchronize(cuda):
    """Every tick, the one admitting requests (and staging encodes past the
    stage window) included, runs under torch.cuda.set_sync_debug_mode
    ("error"): nothing in it reads the card back or synchronises a stream
    (a replay waits only for the step before it, on that step's event)."""
    _, eng = _serve_engine(cuda, stage_window=2)
    for i in range(5):
        eng.submit(_serve_request(eng, seed=i, steps=2))
    assert len(eng._staged) == 2 and len(eng._unstaged) == 3
    torch.cuda.synchronize()
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        while eng.core.active() or eng.core.pending():
            got += eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got += eng.flush()
    assert sorted(r.request_id for r in got) == [0, 1, 2, 3, 4]


@pytest.mark.cuda
def test_cuda_conv_rows_do_not_depend_on_their_position_under_row_invariance(cuda):
    """SD1.5's 3x3 conv with 1280 output channels at 16x16, batch 8 (the
    serving engine's 16x16 level): under ops.conv.RowInvariance, rolling the
    batch rolls the result bit for bit."""
    from tinyfusers_tpu_torch import ops
    from tinyfusers_tpu_torch.ops.conv import RowInvariance

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((8, 16, 16, 1280), generator=g, device=cuda).bfloat16()
    w = (torch.randn((3, 3, 1280, 1280), generator=g, device=cuda) / 100).bfloat16()
    b = torch.randn((1280,), generator=g, device=cuda).bfloat16()
    with RowInvariance() as policy:
        y = ops.conv2d(x, w, b, padding=1)
        rolled = ops.conv2d(x.roll(1, 0), w, b, padding=1)
    assert len(policy.apart) == 1
    assert torch.equal(rolled, y.roll(1, 0))


# -- training: gradients through the kernels -------------------------------------
# The autograd Functions' backward is the exact-math attention's / the exact-erf
# GEGLU's gradient recomputed from the saved inputs; against autograd through
# the plain versions (the base-2 prescale rounded to q's dtype, the A-S erf)
# the gradients differ in bf16 by the plain versions' own roundings (at most
# 6.2e-3 attention, 3.8e-3 GEGLU, measured on the CPU at these shapes' widths)
# and in fp32 by summation order (at most 7.5e-7).
GRAD_REL = {torch.bfloat16: 1.5e-2, torch.float32: 1e-5}


def _grads(fn, inputs, cot):
    leaves = [x.detach().requires_grad_() for x in inputs]
    fn(*leaves).backward(cot)
    return [x.grad for x in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,heads,c,kv_len", [
    (4, 4096, 4096, 8, 320, None), (4, 4096, 77, 8, 320, None),  # training batch 4
    (4, 1024, 1024, 8, 640, None), (4, 1024, 77, 8, 640, None),
    (1, 1152, 1152, 2, 128, 1101),  # kv_len: dk and dv zero past it
])
def test_cuda_sdpa_packed_gives_gradients_through_the_kernel(cuda, dtype, b, sq, sk, heads,
                                                             c, kv_len):
    """ops.sdpa_packed on CUDA launches flash_packed once and its gradients
    reach q, k and v: the plain versions' autograd's, within GRAD_REL."""
    from tinyfusers_tpu_torch import ops

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, cot = (torch.randn(b, s, c, generator=g, device=cuda).to(dtype)
                    for s in (sq, sk, sk, sq))
    n0 = flash_packed.launches
    got = _grads(lambda q, k, v: ops.sdpa_packed(q, k, v, heads=heads, kv_len=kv_len),
                 (q, k, v), cot)
    assert flash_packed.launches == n0 + 1
    want = _grads(lambda q, k, v: flash_packed_plain(q, k, v, heads=heads, kv_len=kv_len),
                  (q, k, v), cot)
    for name, gr, w in zip("qkv", got, want):
        assert gr is not None and gr.dtype == dtype and torch.isfinite(gr).all(), name
        assert gr.abs().sum() > 0 and _rel(gr, w) <= GRAD_REL[dtype], (name, _rel(gr, w))
    if kv_len is not None:
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_sdpa_gives_gradients_through_the_bhsd_kernel(cuda, dtype):
    from tinyfusers_tpu_torch import ops

    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, cot = (torch.randn(1, 1, 4096, 512, generator=g, device=cuda).to(dtype)
                    for _ in range(4))
    n0 = flash_bhsd.launches
    got = _grads(lambda q, k, v: ops.sdpa(q, k, v), (q, k, v), cot)
    assert flash_bhsd.launches == n0 + 1
    want = _grads(lambda q, k, v: flash_bhsd_plain(q, k, v), (q, k, v), cot)
    for name, gr, w in zip("qkv", got, want):
        assert gr is not None and gr.abs().sum() > 0, name
        assert _rel(gr, w) <= GRAD_REL[dtype], (name, _rel(gr, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(16384, 1280, 320), (4096, 2560, 640),
                                   (1024, 5120, 1280), (256, 5120, 1280)])
def test_cuda_geglu_linear_gives_gradients_through_the_kernel(cuda, dtype, m, k, n):
    """ops.geglu_linear on CUDA (the strided halves of one projection, as the
    UNet gives them) launches the GEGLU kernel once; gx, gate, w and b get
    the plain version's gradients within GRAD_REL."""
    from tinyfusers_tpu_torch import ops

    g = torch.Generator(device=cuda).manual_seed(2)
    proj = torch.randn(m, 2 * k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(k, n, generator=g, device=cuda) * k ** -0.5).to(dtype)
    bias = torch.randn(n, generator=g, device=cuda).to(dtype)
    cot = torch.randn(m, n, generator=g, device=cuda).to(dtype)

    def run(fn):
        p, w_, b_ = (x.detach().requires_grad_() for x in (proj, w, bias))
        gx, gate = p.chunk(2, dim=-1)
        fn(gx, gate, w_, b_).backward(cot)
        return p.grad[:, :k], p.grad[:, k:], w_.grad, b_.grad

    n0 = geglu_matmul.launches
    got = run(ops.geglu_linear)
    assert geglu_matmul.launches == n0 + 1
    want = run(geglu_matmul_plain)
    for name, gr, w_ in zip(("gx", "gate", "w", "b"), got, want):
        assert gr.dtype == dtype and gr.abs().sum() > 0, name
        assert _rel(gr, w_) <= GRAD_REL[dtype], (name, _rel(gr, w_))


@pytest.mark.cuda
def test_cuda_tiny_unet_train_step_through_the_kernels(cuda):
    """A TINY UNet at a 32x32 latent (1024 tokens: its first level takes
    flash_packed) in fp32: one remat train step launches each kernel twice
    per call site, every parameter gets a gradient, and the gradients are
    those of the same model with the kernels' plain versions in their place
    within 1e-4 per tensor (exact fp32 on both sides, other summation
    orders through the network)."""
    from tinyfusers_tpu_torch import train
    from tinyfusers_tpu_torch.kernels import flash_attention as fa
    from tinyfusers_tpu_torch.kernels import geglu_ff as gf
    from tinyfusers_tpu_torch.models import unet
    from tinyfusers_tpu_torch.models.layers import init_weights, set_trainable

    attention = sys.modules["tinyfusers_tpu_torch.ops.attention"]
    linear = sys.modules["tinyfusers_tpu_torch.ops.linear"]  # not ops.linear, the function

    model = unet.UNet(unet.TINY_CONFIG, device=cuda, dtype=torch.float32)
    init_weights(model, 0)
    params = train.params_of(set_trainable(model), trainable_only=True)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 32, 32, 4, generator=g, device=cuda)
    ctx = torch.randn(2, 77, unet.TINY_CONFIG.context_dim, generator=g, device=cuda)
    t = torch.tensor([10, 700], dtype=torch.int32, device=cuda)
    apply_fn = train.step.rematerialized(train.module_apply(model))

    def grads():
        return train.step.value_and_grad(lambda p: apply_fn(p, x, t, ctx).square().mean(),
                                         params)[1]

    f0, g0 = flash_packed.launches, geglu_matmul.launches
    got = grads()
    # with remat each call runs twice: 5 transformer blocks at the 1024-token
    # level (a self and a cross attention each), 11 FF tails in all
    assert flash_packed.launches - f0 == 2 * 2 * 5
    assert geglu_matmul.launches - g0 == 2 * 11
    orig = attention.flash_packed_diff, linear.geglu_matmul_diff
    attention.flash_packed_diff, linear.geglu_matmul_diff = (fa.flash_packed_plain,
                                                             gf.geglu_matmul_plain)
    try:
        want = grads()
    finally:
        attention.flash_packed_diff, linear.geglu_matmul_diff = orig
    assert set(got) == set(params)
    for name, gr in got.items():
        assert gr is not None and torch.isfinite(gr).all(), name
        assert _rel(gr, want[name]) <= 1e-4, (name, _rel(gr, want[name]))


@pytest.mark.cuda
@pytest.mark.parametrize("qname", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("m,k,n,bias", TRANSFORMER_QUANT_SHAPES)
def test_cuda_transformer_quant_shapes_run_on_wgmma(cuda, qname, m, k, n, bias):
    """bf16 at the quantized MMDiT's and DiT's shapes: the wgmma variant
    (K % 64 == 0, N % 8 == 0, g = 64) at _plan's tile and split, within the
    quant tolerances of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    dense = torch.randn(n, k, generator=g, device=cuda).t() * k ** -0.5
    b = torch.randn(n, generator=g, device=cuda).to(torch.bfloat16)
    if qname == "int4":
        w, fn, plain = quantize_int4(dense, axis=0), quant_matmul_int4, quant_matmul_int4_plain
        plan = _plan(torch.bfloat16, m, k, n, w.group_size)
    else:
        wdtype = torch.int8 if qname == "int8" else torch.float8_e4m3fn
        w, fn, plain = quantize(dense, wdtype), quant_matmul, quant_matmul_plain
        plan = _plan(torch.bfloat16, m, k, n)
    assert plan[0] == "wgmma"
    v0 = fn.variants["wgmma"]
    got = fn(x, w, b)
    torch.cuda.synchronize()
    assert fn.variants["wgmma"] == v0 + 1
    want = plain(x, w, b)
    assert _rel(got, want) <= QUANT_REL[torch.bfloat16]
    assert _row_rel(got, want) <= QUANT_ROW_REL[torch.bfloat16]


@pytest.fixture
def nccl_world1(cuda, tmp_path):
    """A one-rank NCCL process group and its (data 1, model 1) mesh."""
    import torch.distributed as dist

    from tinyfusers_tpu_torch import parallel

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield parallel.make_mesh(model=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_world1_mesh_unet_bit_equal(cuda, nccl_world1):
    """shard_params on a one-rank mesh changes nothing: the TINY UNet's
    bf16 output (through the flash and GEGLU kernels) is the unsharded one
    bit for bit."""
    from tinyfusers_tpu_torch import parallel
    from tinyfusers_tpu_torch.models import unet

    cfg = dataclasses.replace(unet.TINY_CONFIG, num_heads=2)
    model = unet.UNet(cfg, device=cuda, dtype=torch.bfloat16)
    init_weights(model, 0)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 64, 64, 4, generator=g, device=cuda).bfloat16()
    ctx = torch.randn(2, 77, cfg.context_dim, generator=g, device=cuda).bfloat16()
    t = torch.full((2,), 500.0, device=cuda)
    with torch.inference_mode():
        want = unet.apply(model, x, t, ctx)
        parallel.shard_params(model, nccl_world1)
        n0 = flash_packed.launches
        got = unet.apply(model, x, t, ctx)
    assert flash_packed.launches > n0
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("role", ["column", "row"])
def test_cuda_tp_linear_world1_is_dense(cuda, nccl_world1, role):
    """A Linear with a tensor-parallel role over a one-rank model group
    gives the dense product: the column one bit for bit, the row one (its
    bias added after the sum, where cuBLAS fuses it into the dense call)
    within fp32 rounding: measured 3.1e-6 at most on an H100."""
    from tinyfusers_tpu_torch.models.layers import Linear
    from tinyfusers_tpu_torch.parallel import mesh as pmesh

    leaf = Linear(320, 640, device=cuda)
    init_weights(leaf, 0)
    x = torch.randn(4, 77, 320, device=cuda)
    want = leaf(x)
    leaf.tp_role, leaf.tp_group = role, pmesh.axis(nccl_world1, "model")[2]
    got = leaf(x)
    if role == "column":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_world1_sharded_adafactor_update_bit_equal(cuda, nccl_world1):
    """One Adafactor step of the TINY UNet (bf16, factored from 8 wide, in
    the JAX layout) on a state placed on a one-rank NCCL mesh (TP rules,
    then FSDP at min_size 1) against the same step on the unsharded state:
    every parameter and statistic bit for bit."""
    from tinyfusers_tpu_torch import parallel, train
    from tinyfusers_tpu_torch.models import unet
    from tinyfusers_tpu_torch.models.layers import set_trainable
    from tinyfusers_tpu_torch.train import optim

    cfg = dataclasses.replace(unet.TINY_CONFIG, num_heads=2)

    def step_of(mesh):
        model = unet.UNet(cfg, device=cuda, dtype=torch.bfloat16)
        init_weights(model, 0)
        set_trainable(model)
        tx = optim.adafactor(1e-2, min_dim_size_to_factor=8,
                             layouts=train.param_layouts(model))
        placements = None if mesh is None else parallel.sharding_tree(
            parallel.shard_params(model, mesh), mesh)
        state = train.TrainState.create(train.params_of(model), tx, placements=placements)
        if mesh is not None:
            state = parallel.shard_fsdp(state, mesh, min_size=1)
        g = torch.Generator(device=cuda).manual_seed(1)
        batch = (torch.randn(2, 32, 32, 4, generator=g, device=cuda).bfloat16(),
                 torch.randn(2, 77, cfg.context_dim, generator=g, device=cuda).bfloat16())
        step = train.make_train_step(train.module_apply(model), tx)
        return step(state, batch, torch.Generator(device=cuda).manual_seed(2))

    want, want_m = step_of(None)
    got, got_m = step_of(nccl_world1)
    assert torch.equal(got_m["loss"], want_m["loss"])
    for k, v in want.params.items():
        assert torch.equal(got.params[k], v), k
    for field in ("v_row", "v_col", "v"):
        for k, v in getattr(want.opt_state[0], field).items():
            assert torch.equal(getattr(got.opt_state[0], field)[k], v), (field, k)
