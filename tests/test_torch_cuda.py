"""The port's CUDA kernels against their plain versions on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file
imports neither jax nor the JAX package, so it also runs on a machine
without them; there, skip tests/conftest.py (which sets up jax):

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Tolerances on ||kernel - plain|| / ||plain||: fp32 1e-5 (both exact fp32,
other summation order; TF32 is switched off); bf16 attention 1e-2 (the
kernel rounds P to bf16 against a running per-tile max, the plain version
against the row's global max); bf16 GEGLU 2e-3 (fp32 sums in another
order, then one bf16 rounding).
"""
import pytest
import torch

from tinyfusers_tpu_torch.kernels.flash_attention import (
    flash_bhsd, flash_bhsd_plain, flash_packed, flash_packed_plain)
from tinyfusers_tpu_torch.kernels.geglu_ff import geglu_matmul, geglu_matmul_plain
from tinyfusers_tpu_torch.ops.linear import geglu_linear


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


ATTN_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
GEGLU_REL = {torch.bfloat16: 2e-3, torch.float32: 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,heads,d,kv_len", [
    (2, 4096, 4096, 8, 40, None), (2, 4096, 77, 8, 40, None),
    (2, 1024, 1024, 8, 80, None), (2, 1024, 77, 8, 80, None),
    (1, 300, 80, 2, 40, 77), (1, 100, 200, 3, 128, 0),
    (2, 130, 70, 3, 36, 50),  # d % 8 != 0: element-wise tile loads
])
def test_cuda_packed_matches_plain(cuda, dtype, b, sq, sk, heads, d, kv_len):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, s, heads * d, generator=g, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    key = (b, sq, sk, heads * d, heads)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lead,sq,sk,d,causal,kv_len", [
    ((1, 1), 4096, 4096, 512, False, None), ((2, 3), 300, 300, 64, True, None),
    ((2,), 130, 300, 96, False, 250), ((1,), 256, 256, 200, True, 180),
    ((3,), 90, 150, 20, True, None),  # d % 8 != 0: element-wise tile loads
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
    assert _rel(got, flash_bhsd_plain(q, k, v, causal=causal, kv_len=kv_len)) \
        <= ATTN_REL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,bias", [
    (8192, 1280, 320, True), (2048, 2560, 640, True), (512, 5120, 1280, True),
    (128, 5120, 1280, True), (100, 96, 70, False),
    (70, 100, 33, True),  # K % 8 != 0 and odd N: element-wise loads and stores
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
    assert _rel(got, geglu_matmul_plain(gx, gate, w, b)) <= GEGLU_REL[dtype]


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_packed(x, x, x, heads=2)
    with pytest.raises(TypeError):
        geglu_matmul(x, x, torch.zeros(16, 4, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        flash_bhsd(x.float(), x.float(), x.float(), kv_len=9)
    with pytest.raises(ValueError):  # no plain fallback for a weight it cannot take
        geglu_linear(x.float(), x.float(), torch.zeros(2, 16, 4, device=cuda))
