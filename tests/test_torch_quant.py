"""The port's weight-only quantization against the JAX package's, on the
CPU: the quantizers bit for bit, the plain versions of the quant-matmul
kernels against the Pallas kernels (interpret=True, as
tests/test_kernels.py runs them), the quantized ops, quantize_params, the
quantized TINY UNet and TINY generate, and the bridge for quantized
trees. The CUDA kernels are tested on the card by tests/test_torch_cuda.py.

Tolerances: quantizers and dequantization exact; fp32 products rtol 1e-5
(same arithmetic, fp32 sums in another order); bf16 products one bf16 ulp
(rtol 2^-7), since both sides round the same fp32 epilogue once; both with
atol 1e-5 for outputs near zero, where sums of O(1) terms cancel; the UNet 1e-4 as test_unet_matches_jax;
uint8 images within 1.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu import ops as jops
from tinyfusers_tpu.io.quantize_tree import quantize_params as jquantize_params
from tinyfusers_tpu.kernels.quant_matmul import quant_matmul as pallas_qmm
from tinyfusers_tpu.kernels.quant_matmul import quant_matmul_int4 as pallas_qmm4
from tinyfusers_tpu.models import unet as junet
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu_torch import ops as tops
from tinyfusers_tpu_torch.io.from_jax import load_params, load_sd
from tinyfusers_tpu_torch.io.quantize_tree import quantize_params
from tinyfusers_tpu_torch.kernels import quant_matmul as qmm
from tinyfusers_tpu_torch.kernels.quant_matmul import (
    quant_matmul, quant_matmul_int4, quant_matmul_int4_plain, quant_matmul_plain)
from tinyfusers_tpu_torch.models import unet as tunet
from tinyfusers_tpu_torch.models.layers import Conv, Linear
from tinyfusers_tpu_torch.ops.quant import Int4Tensor, QuantizedTensor
from tinyfusers_tpu_torch.pipeline import sd as tsd

from torch_parity import few_torch_threads, random_tree  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=1e-5)
UNET = dict(rtol=1e-4, atol=1e-4)
QDTYPES = {"int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
           "e5m2": (jnp.float8_e5m2, torch.float8_e5m2),
           "int4": ("int4", "int4")}


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def to_t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def to_j(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def as_bytes(x) -> np.ndarray:
    """Raw bytes of a torch or JAX array, for bit-for-bit comparisons."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).contiguous().view(torch.uint8).numpy()
    a = np.asarray(x)
    return a.view(np.uint8)


def same_bits(got, want) -> bool:
    return np.array_equal(as_bytes(got).reshape(-1), as_bytes(want).reshape(-1))


def weight(seed, *shape):
    """Channels of very different magnitudes, and one all-zero channel
    (its scale is the 1e-12 floor)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape) * rng.uniform(0.01, 4.0, shape[-1])
    w[..., 1] = 0.0
    return w.astype(np.float32)


# -- quantizers ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["int8", "fp8", "e5m2"])
@pytest.mark.parametrize("shape", [(96, 40), (3, 3, 8, 16)])
def test_quantize_is_bit_identical_to_jax(name, shape):
    jd, td = QDTYPES[name]
    w = weight(0, *shape)
    want = jops.quantize(jnp.asarray(w), jd, axis=-1)
    got = tops.quantize(torch.from_numpy(w), td, axis=-1)
    assert got.values.dtype == td and got.shape == want.shape
    assert tuple(got.scales.shape) == want.scales.shape
    assert same_bits(got.values, want.values) and same_bits(got.scales, want.scales)
    assert same_bits(got.dequantize(), want.dequantize())


@pytest.mark.parametrize("shape,axis,group,want_group", [
    ((96, 40), 0, 64, 32),         # K = 96: the clipping halves 64 to 32
    ((256, 24), 0, 64, 64),
    ((3, 3, 4, 16), 2, 64, 4),     # conv_in-like: I = 4 gives groups of 4
    ((3, 3, 96, 8), 2, 64, 32),    # HWIO, packed on the input channels
])
def test_quantize_int4_is_bit_identical_to_jax(shape, axis, group, want_group):
    w = weight(1, *shape)
    want = jops.quantize_int4(jnp.asarray(w), axis=axis, group_size=group)
    got = tops.quantize_int4(torch.from_numpy(w), axis=axis, group_size=group)
    assert got.group_size == want.group_size == want_group
    assert (got.axis, got.orig_dim, got.shape) == (want.axis, want.orig_dim, want.shape)
    assert got.packed.dtype == torch.uint8
    assert tuple(got.packed.shape) == want.packed.shape
    assert tuple(got.scales.shape) == want.scales.shape
    assert same_bits(got.packed, want.packed) and same_bits(got.scales, want.scales)
    assert same_bits(got.dequantize(), want.dequantize())
    assert same_bits(got.dequantize(torch.bfloat16), want.dequantize(jnp.bfloat16))


def test_quantize_rejects_what_jax_rejects():
    with pytest.raises(ValueError):
        tops.quantize_int4(torch.zeros(7, 4), axis=0)
    with pytest.raises(ValueError):
        tops.quantize(torch.zeros(4, 4), torch.int16)
    assert not tops.is_quantized(torch.zeros(1))
    q = tops.quantize(torch.ones(64, 64))
    assert tops.is_quantized(q) and torch.equal(tops.dequantize(q), torch.ones(64, 64))


# -- plain kernels vs the Pallas kernels -------------------------------------------

@pytest.mark.parametrize("name", ["int8", "fp8", "e5m2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bias", [(2, 96, 40, True), (37, 160, 72, False),
                                        (37, 64, 32, True)])
def test_quant_matmul_plain_matches_pallas(name, dtype, m, k, n, bias):
    jd, td = QDTYPES[name]
    x, w, b = rand(0, m, k), weight(1, k, n) / k ** 0.5, rand(2, n) if bias else None
    jw = jops.quantize(jnp.asarray(w), jd, axis=-1)
    want = pallas_qmm(to_j(x, getattr(jnp, dtype)), jw, None if b is None else to_j(b),
                      block_m=64, block_n=128, block_k=128, interpret=True)
    got = quant_matmul_plain(to_t(x, getattr(torch, dtype)),
                             tops.quantize(torch.from_numpy(w), td),
                             None if b is None else to_t(b))
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    close(got, want, F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,g,bias", [
    (2, 96, 40, 64, True),     # clipped to groups of 32
    (37, 256, 72, 64, False),
    (37, 130, 32, 65, True),   # odd group: the Pallas K block spans 2 groups
])
def test_quant_matmul_int4_plain_matches_pallas(dtype, m, k, n, g, bias):
    x, w, b = rand(0, m, k), weight(1, k, n) / k ** 0.5, rand(2, n) if bias else None
    jw = jops.quantize_int4(jnp.asarray(w), axis=0, group_size=g)
    want = pallas_qmm4(to_j(x, getattr(jnp, dtype)), jw, None if b is None else to_j(b),
                       block_m=64, block_n=128, block_k=128, interpret=True)
    got = quant_matmul_int4_plain(to_t(x, getattr(torch, dtype)),
                                  tops.quantize_int4(torch.from_numpy(w), axis=0,
                                                     group_size=g),
                                  None if b is None else to_t(b))
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    close(got, want, F32 if dtype == "float32" else BF16)


def test_cpu_wrappers_use_the_plain_versions_and_count_nothing():
    counts = (quant_matmul.launches, quant_matmul_int4.launches)
    x, w, b = to_t(rand(0, 2, 5, 64)), torch.from_numpy(weight(1, 64, 24)), to_t(rand(2, 24))
    for td in (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2):
        q = tops.quantize(w, td)
        assert torch.equal(quant_matmul(x, q, b), quant_matmul_plain(x, q, b))
    q4 = tops.quantize_int4(w, axis=0, group_size=32)
    got = quant_matmul_int4(x, q4, b)
    assert got.shape == (2, 5, 24) and torch.equal(got, quant_matmul_int4_plain(x, q4, b))
    assert (quant_matmul.launches, quant_matmul_int4.launches) == counts


def test_wrappers_raise_on_bad_weights_on_any_device():
    x, w = torch.zeros(3, 64), torch.from_numpy(weight(0, 64, 16))
    with pytest.raises(ValueError, match="axis 0"):
        quant_matmul_int4(x, tops.quantize_int4(w.t().contiguous(), axis=1))
    with pytest.raises(ValueError, match="K mismatch"):
        quant_matmul_int4(x[:, :32], tops.quantize_int4(w, axis=0))
    with pytest.raises(ValueError, match="K mismatch"):
        quant_matmul(x[:, :32], tops.quantize(w))
    with pytest.raises(ValueError, match="per-output-channel"):
        quant_matmul(x, tops.quantize(w, axis=0))


# (M, K, N, g), dtype -> (variant, x rows per block, K splits) of the int4
# kernel. The 19 SD1.5 UNet shapes (bf16, g = 64) all run wgmma: n = 8 at
# M = 2, 64 at M = 154, 128 at M = 128 / 512, 160 above; K is split over a
# cluster toward about 100 blocks of at most 20 K steps each.
INT4_PLANS = [
    ((8192, 320, 320, 64), "bfloat16", ("wgmma", 160, 1)),
    ((154, 768, 320, 64), "bfloat16", ("wgmma", 64, 7)),
    ((8192, 320, 2560, 64), "bfloat16", ("wgmma", 160, 1)),
    ((8192, 1280, 320, 64), "bfloat16", ("wgmma", 160, 1)),
    ((2048, 640, 640, 64), "bfloat16", ("wgmma", 160, 1)),
    ((154, 768, 640, 64), "bfloat16", ("wgmma", 64, 3)),
    ((2048, 640, 5120, 64), "bfloat16", ("wgmma", 160, 1)),
    ((2048, 2560, 640, 64), "bfloat16", ("wgmma", 160, 2)),
    ((512, 1280, 1280, 64), "bfloat16", ("wgmma", 128, 1)),
    ((154, 768, 1280, 64), "bfloat16", ("wgmma", 64, 2)),
    ((512, 1280, 10240, 64), "bfloat16", ("wgmma", 128, 1)),
    ((512, 5120, 1280, 64), "bfloat16", ("wgmma", 128, 4)),
    ((128, 1280, 1280, 64), "bfloat16", ("wgmma", 128, 5)),
    ((128, 1280, 10240, 64), "bfloat16", ("wgmma", 128, 1)),
    ((128, 5120, 1280, 64), "bfloat16", ("wgmma", 128, 5)),
    ((2, 1280, 320, 64), "bfloat16", ("wgmma", 8, 8)),
    ((2, 1280, 640, 64), "bfloat16", ("wgmma", 8, 8)),
    ((2, 1280, 1280, 64), "bfloat16", ("wgmma", 8, 5)),
    ((2, 320, 1280, 64), "bfloat16", ("wgmma", 8, 5)),
    # the groups of scales a block holds (32) push the split up
    ((8192, 5120, 320, 32), "bfloat16", ("wgmma", 160, 5)),
    ((37, 768, 40, 64), "bfloat16", ("wgmma", 64, 8)),  # ragged M and N inside wgmma
    ((37, 96, 40, 32), "bfloat16", ("mma", 0, 1)),      # K % 64 != 0
    ((5, 72, 33, 64), "bfloat16", ("mma", 0, 1)),       # ragged K, odd N
    ((37, 130, 40, 2), "bfloat16", ("mma", 0, 1)),      # g = 2
    ((2, 1280, 320, 64), "float32", ("fma", 0, 1)),
]


@pytest.mark.parametrize("shape,dtype,want", INT4_PLANS)
def test_int4_plan(shape, dtype, want):
    m, k, n, g = shape
    plan = qmm._plan(getattr(torch, dtype), m, k, n, g)
    assert plan == want
    if plan[0] == "wgmma":  # the block's scales fit its shared memory
        assert qmm._groups(k, g, plan[2]) <= qmm._MAX_GROUPS


# (M, K, N), dtype -> (variant, x rows per block, K splits) of the int8 /
# fp8 kernel (no group size). The 19 SD1.5 UNet shapes (bf16) all run
# wgmma, with int4's tiles and at most 40 K steps a block (int4: 20), as
# the byte formats' sweep has it.
BYTE_PLANS = [
    ((8192, 320, 320), "bfloat16", ("wgmma", 160, 1)),
    ((154, 768, 320), "bfloat16", ("wgmma", 64, 7)),
    ((8192, 320, 2560), "bfloat16", ("wgmma", 160, 1)),
    ((8192, 1280, 320), "bfloat16", ("wgmma", 160, 1)),
    ((2048, 640, 640), "bfloat16", ("wgmma", 160, 1)),
    ((154, 768, 640), "bfloat16", ("wgmma", 64, 3)),
    ((2048, 640, 5120), "bfloat16", ("wgmma", 160, 1)),
    ((2048, 2560, 640), "bfloat16", ("wgmma", 160, 1)),  # int4: split 2
    ((512, 1280, 1280), "bfloat16", ("wgmma", 128, 1)),
    ((154, 768, 1280), "bfloat16", ("wgmma", 64, 2)),
    ((512, 1280, 10240), "bfloat16", ("wgmma", 128, 1)),
    ((512, 5120, 1280), "bfloat16", ("wgmma", 128, 2)),  # int4: split 4
    ((128, 1280, 1280), "bfloat16", ("wgmma", 128, 5)),
    ((128, 1280, 10240), "bfloat16", ("wgmma", 128, 1)),
    ((128, 5120, 1280), "bfloat16", ("wgmma", 128, 5)),
    ((2, 1280, 320), "bfloat16", ("wgmma", 8, 8)),
    ((2, 1280, 640), "bfloat16", ("wgmma", 8, 8)),
    ((2, 1280, 1280), "bfloat16", ("wgmma", 8, 5)),
    ((2, 320, 1280), "bfloat16", ("wgmma", 8, 5)),
    # no group budget: 80 K steps split toward at most 40 a block
    ((8192, 5120, 320), "bfloat16", ("wgmma", 160, 2)),
    ((37, 768, 40), "bfloat16", ("wgmma", 64, 8)),   # ragged M and N inside wgmma
    ((37, 96, 40), "bfloat16", ("mma", 0, 1)),       # K % 64 != 0
    ((5, 72, 33), "bfloat16", ("mma", 0, 1)),        # ragged K, odd N
    ((64, 1280, 36), "bfloat16", ("mma", 0, 1)),     # N % 8 != 0
    ((2, 1280, 320), "float32", ("fma", 0, 1)),
]


@pytest.mark.parametrize("shape,dtype,want", BYTE_PLANS)
def test_byte_plan(shape, dtype, want):
    assert qmm._plan(getattr(torch, dtype), *shape) == want


@pytest.mark.parametrize("variant,bias_dtype,want_dtype,same", [
    ("wgmma", torch.bfloat16, torch.bfloat16, True),  # a model's bias: read as it is
    ("wgmma", torch.float32, torch.float32, True),
    ("wgmma", torch.float16, torch.float32, False),   # other dtypes: an fp32 copy
    ("mma", torch.bfloat16, torch.float32, False),    # mma and fma read fp32 only
    ("fma", torch.float32, torch.float32, True),
])
def test_kernel_bias(variant, bias_dtype, want_dtype, same):
    """The bias the kernel reads: wgmma takes bf16 or fp32 in place (bf16
    -> fp32 is exact there), so a model's bf16 bias costs no cast launch."""
    x = torch.zeros(2, 64, dtype=torch.bfloat16)
    b = torch.arange(48, dtype=torch.float32).to(bias_dtype)
    got = qmm._kernel_bias(b, x, variant)
    assert got.dtype == want_dtype and got.shape == (48,) and got.is_contiguous()
    assert (got.data_ptr() == b.data_ptr()) == same
    assert torch.equal(got.float(), b.float())
    assert qmm._kernel_bias(None, x, variant) is None


# -- quantized ops -------------------------------------------------------------------

def _both(name, w, axis):
    """The JAX package's and the port's quantization of one numpy weight."""
    jd, td = QDTYPES[name]
    if name == "int4":
        return (jops.quantize_int4(jnp.asarray(w), axis=axis, group_size=32),
                tops.quantize_int4(torch.from_numpy(w), axis=axis, group_size=32))
    return jops.quantize(jnp.asarray(w), jd, axis=-1), tops.quantize(torch.from_numpy(w), td)


@pytest.mark.parametrize("name", ["int8", "fp8", "int4"])
def test_quantized_linear_and_geglu_linear_match_jax(name):
    x, gate, b = rand(0, 2, 7, 64), rand(1, 2, 7, 64), rand(2, 48)
    jw, tw = _both(name, weight(3, 64, 48) / 8.0, 0)  # fan-in 64
    close(tops.linear(to_t(x), tw, to_t(b)), jops.linear(jnp.asarray(x), jw, jnp.asarray(b)),
          F32)
    close(tops.geglu_linear(to_t(x), to_t(gate), tw, to_t(b)),
          jops.geglu_linear(jnp.asarray(x), jnp.asarray(gate), jw, jnp.asarray(b)), F32)


@pytest.mark.parametrize("name", ["int8", "fp8", "int4"])
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, (0, 1, 0, 1))])
def test_quantized_conv2d_matches_jax(name, stride, padding):
    x, b = rand(0, 2, 9, 9, 64), rand(1, 24)
    jw, tw = _both(name, weight(2, 3, 3, 64, 24) / 24.0, 2)  # fan-in 576
    want = jops.conv2d(jnp.asarray(x), jw, jnp.asarray(b), stride=stride, padding=padding)
    close(tops.conv2d(to_t(x), tw, to_t(b), stride=stride, padding=padding), want, F32)


@pytest.mark.parametrize("name", ["int8", "fp8", "int4"])
def test_quantized_conv2d_bf16_within_one_extra_rounding_of_jax(name):
    """bf16: the JAX package rounds the fp32 sum once, after the scale and
    the bias. The port's library conv rounds its output to bf16 first (an
    int8 / fp8 output before the scale; an int4 output with the bf16 bias),
    so the two may differ by that rounding, 2^-8 of |scaled sum| + |bias|,
    plus one ulp of the result for the last rounding on either side."""
    x, b = rand(0, 2, 9, 9, 64), rand(1, 24)
    jw, tw = _both(name, weight(2, 3, 3, 64, 24) / 24.0, 2)
    want = jops.conv2d(to_j(x, jnp.bfloat16), jw, jnp.asarray(b), padding=1)
    got = tops.conv2d(to_t(x, torch.bfloat16), tw, to_t(b), padding=1)
    assert got.dtype == torch.bfloat16
    scaled = tops.conv2d(to_t(x, torch.bfloat16).float(), tw, None, padding=1)  # fp32
    want = torch.from_numpy(np.asarray(want, np.float32))
    limit = 2 ** -8 * (scaled.abs() + to_t(b).abs()) + 2 ** -7 * want.abs() + 1e-6
    assert ((got.float() - want).abs() <= limit).all()


# -- quantize_params, the bridge, the UNet and the pipeline ----------------------------

@pytest.fixture(scope="module")
def tiny_unet():
    return random_tree(lambda k: junet.init(k, junet.TINY_CONFIG), 0)


@pytest.fixture(scope="module")
def jax_quantized(tiny_unet):
    """name -> the JAX package's quantize_params of tiny_unet, made once
    (eager JAX quantization compiles every op for every leaf shape)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = jquantize_params(tiny_unet, QDTYPES[name][0])
        return cache[name]

    return get


def _port_unet(params):
    model = tunet.UNet(tunet.TINY_CONFIG, device="cpu")
    load_params(model, params)
    return model


def _jax_quantized(tree, path=()):
    """Dotted paths (the port's module names) of the quantized leaves."""
    if isinstance(tree, dict):
        return {p for k, v in tree.items() for p in _jax_quantized(v, path + (k,))}
    if isinstance(tree, list):
        return {p for i, v in enumerate(tree) for p in _jax_quantized(v, path + (str(i),))}
    return {".".join(path[:-1])} if jops.is_quantized(tree) else set()


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_quantize_params_matches_jax(tiny_unet, jax_quantized, name):
    td = QDTYPES[name][1]
    jq = jax_quantized(name)
    model = quantize_params(_port_unet(tiny_unet), td)
    ours = {n for n, m in model.named_modules() if tops.is_quantized(getattr(m, "w", None))}
    assert ours == _jax_quantized(jq)
    kinds = {type(model.get_submodule(n)) for n in ours}
    assert kinds == {Linear, Conv}  # TINY quantizes at least one of each
    mods = dict(model.named_modules())
    assert any(n not in ours for n, m in mods.items() if isinstance(m, (Linear, Conv)))
    for n in sorted(ours)[:6]:  # a few leaves, bit for bit
        leaf = jq
        for part in n.split("."):
            leaf = leaf[int(part)] if isinstance(leaf, list) else leaf[part]
        got, want = mods[n].w, leaf["weight"]
        first = (got.packed, want.packed) if name == "int4" else (got.values, want.values)
        assert same_bits(*first) and same_bits(got.scales, want.scales)


def _unet_inputs():
    x, ctx = rand(1, 2, 8, 8, 4), rand(2, 2, 7, 16)
    return x, np.array([981.0, 1.0], np.float32), ctx


@pytest.mark.parametrize("name", ["int8", "fp8", "e5m2", "int4"])
def test_quantized_unet_matches_jax_and_the_bridge_carries_it(tiny_unet, jax_quantized,
                                                              name):
    td = QDTYPES[name][1]
    jq = jax_quantized(name)
    x, t, ctx = _unet_inputs()
    want = jax.jit(lambda *a: junet.apply(*a, junet.TINY_CONFIG))(
        jq, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    quantized_here = quantize_params(_port_unet(tiny_unet), td)
    bridged = _port_unet(jax.tree.map(np.asarray, jq))
    sd_here, sd_bridged = quantized_here.state_dict(), bridged.state_dict()
    assert sd_here.keys() == sd_bridged.keys()
    assert all(same_bits(sd_here[k], sd_bridged[k]) for k in sd_here)
    with torch.no_grad():
        got = tunet.apply(bridged, to_t(x), to_t(t), to_t(ctx))
    close(got, want, UNET)


def _with_middle_leaf(tree, name, leaf):
    """``tree`` with middle[0].<name>.weight replaced by ``leaf``."""
    mid = list(tree["middle"])
    mid[0] = dict(mid[0], **{name: dict(mid[0][name], weight=leaf)})
    return dict(tree, middle=mid)


def test_bridge_rejects_bad_quantized_leaves(jax_quantized):
    q4 = jax.tree.map(np.asarray, jax_quantized("int4"))
    conv = q4["middle"][0]["conv1"]["weight"]  # HWIO (3, 3, 64, 64), packed on I
    for bad in (type(conv)(conv.packed[:, :, :8], conv.scales, axis=2,
                           group_size=conv.group_size, orig_dim=conv.orig_dim),
                type(conv)(conv.packed, conv.scales, axis=3,
                           group_size=conv.group_size, orig_dim=conv.orig_dim)):
        with pytest.raises(ValueError, match="shape"):
            _port_unet(_with_middle_leaf(q4, "conv1", bad))
    q8 = jax.tree.map(np.asarray, jax_quantized("int8"))
    emb = q8["middle"][0]["emb"]["weight"]  # (128, 64) per output channel
    with pytest.raises(ValueError, match="shape"):
        _port_unet(_with_middle_leaf(q8, "emb", type(emb)(emb.values, emb.scales[:, :3])))
    with pytest.raises(ValueError, match="shape"):
        _port_unet(_with_middle_leaf(q8, "emb", type(emb)(emb.values[:, :32], emb.scales)))


def test_quantized_leaves_move_with_the_module_and_the_state_dict():
    lin = Linear(64, 64, device="cpu")
    lin.weight.data.copy_(torch.from_numpy(weight(0, 64, 64)))
    lin.bias.data.zero_()
    lin.set_weight(tops.quantize_int4(lin.w, axis=0))
    assert "weight" not in dict(lin.named_parameters())
    assert set(lin.state_dict()) == {"bias", "weight_packed", "weight_scales"}
    twin = Linear(64, 64, device="cpu")
    twin.set_weight(tops.quantize_int4(torch.zeros(64, 64), axis=0))
    twin.load_state_dict(lin.state_dict())
    x = to_t(rand(1, 3, 64))
    assert torch.equal(twin(x), lin(x))
    # a dtype cast leaves the quantized buffers as they are (fp32 scales)
    lin.to(torch.bfloat16)
    assert lin.bias.dtype == torch.bfloat16 and lin.weight_scales.dtype == torch.float32
    fp8 = Linear(64, 64, device="cpu")
    fp8.set_weight(tops.quantize(torch.from_numpy(weight(1, 64, 64)), torch.float8_e4m3fn))
    fp8.to(torch.float32)
    assert fp8.w.values.dtype == torch.float8_e4m3fn
    with pytest.raises(ValueError):
        lin.set_weight(tops.quantize(torch.zeros(32, 64)))


def test_generate_with_int4_unet_matches_jax():
    params = random_tree(lambda k: jsd.init(k, jsd.TINY), 0)
    model = tsd.StableDiffusion(tsd.TINY, device="cpu", seed=None)
    load_sd(model, params)
    quantize_params(model.unet, "int4")
    params = dict(params, unet=jquantize_params(params["unet"], "int4"))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 127, (1, 16)).astype(np.int32)
    uids = np.full((1, 16), 127, np.int32)
    uids[0, 0] = 0
    lat = rng.standard_normal((1, *tsd.TINY.latent_shape)).astype(np.float32)
    want = np.asarray(jsd.generate(params, jnp.asarray(ids), jnp.asarray(uids),
                                   jnp.asarray(lat), jnp.float32(7.5), num_steps=3,
                                   cfg=jsd.TINY))
    got = tsd.generate(model, torch.from_numpy(ids), torch.from_numpy(uids),
                       torch.from_numpy(lat), 7.5, num_steps=3).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# -- quantize_params on the stacked transformers ---------------------------------

def _tiny_transformers():
    """name -> (JAX init of a tiny model, the port's module of it): the
    MMDiT (also with SD3's 16 latent channels, so that its 2x2 patch_embed
    is quantized: int4 packs along its 16 input channels, its group of 64
    clipped to 16), the DiT and a CLIP tower with a text_projection."""
    import dataclasses

    from tinyfusers_tpu.models import clip as jclip
    from tinyfusers_tpu.models import dit as jdit
    from tinyfusers_tpu.models import mmdit as jmmdit
    from tinyfusers_tpu_torch.models import clip as tclip
    from tinyfusers_tpu_torch.models import dit as tdit
    from tinyfusers_tpu_torch.models import mmdit as tmmdit

    wide = dict(in_channels=16, out_channels=16)
    clip_kw = dict(vocab_size=128, max_length=8, dim=64, num_layers=2, num_heads=4,
                   mlp_dim=128, projection_dim=64)
    return {
        "mmdit": (lambda k: jmmdit.init(k, jmmdit.TINY_MMDIT),
                  lambda: tmmdit.MMDiT(tmmdit.TINY_MMDIT, device="cpu")),
        "mmdit16": (lambda k: jmmdit.init(k, dataclasses.replace(jmmdit.TINY_MMDIT, **wide)),
                    lambda: tmmdit.MMDiT(dataclasses.replace(tmmdit.TINY_MMDIT, **wide),
                                         device="cpu")),
        "dit": (lambda k: jdit.init(k, jdit.TINY_DIT),
                lambda: tdit.DiT(tdit.TINY_DIT, device="cpu", seed=None)),
        "clip": (lambda k: jclip.init(k, jclip.CLIPConfig(**clip_kw)),
                 lambda: tclip.CLIPTextModel(tclip.CLIPConfig(**clip_kw), device="cpu")),
    }


@pytest.mark.parametrize("name", ["int8", "int4"])
@pytest.mark.parametrize("model", ["mmdit", "mmdit16", "dit", "clip"])
def test_quantize_params_leaves_the_stacked_layers_dense_as_jax_does(model, name):
    """The JAX rule quantizes only 2-D / 4-D "weight" leaves, so the
    blocks it stacks for lax.scan (3-D leaves) stay dense: the port's
    quantized leaves are the JAX package's, and each is its bit for bit.
    The JAX rule also quantizes an embedding table of 4096 or more values
    (a CLIP's token_embedding), which its own gather cannot then read; the
    port leaves embeddings dense, as both packages' docstrings say."""
    jinit, make = _tiny_transformers()[model]
    params = random_tree(jinit, 40)
    jq = jquantize_params(params, QDTYPES[name][0])
    port = make()
    load_params(port, params)
    quantize_params(port, QDTYPES[name][1])
    ours = {n for n, m in port.named_modules() if tops.is_quantized(getattr(m, "w", None))}
    theirs = _jax_quantized(jq)
    embeddings = {n for n in theirs if n.endswith("_embedding")}
    assert embeddings == ({"token_embedding"} if model == "clip" else set())
    assert ours == theirs - embeddings
    stacked = "layers" if model == "clip" else "blocks"
    assert ours and not any(n.startswith(stacked + ".") for n in ours)
    if model == "mmdit16":
        assert "patch_embed" in ours
    mods = dict(port.named_modules())
    for n in ours:
        leaf = jq
        for part in n.split("."):
            leaf = leaf[part]
        got, want = mods[n].w, leaf["weight"]
        first = (got.packed, want.packed) if name == "int4" else (got.values, want.values)
        assert same_bits(*first) and same_bits(got.scales, want.scales), n


@pytest.mark.parametrize("name", ["int8", "int4"])
@pytest.mark.parametrize("model", ["mmdit16", "dit"])
def test_quantized_transformer_matches_jax(model, name):
    """fp32: the port's quantize_params of the module against the JAX
    package's of its tree, through both models' apply."""
    from tinyfusers_tpu.models import dit as jdit
    from tinyfusers_tpu.models import mmdit as jmmdit
    from tinyfusers_tpu_torch.models import dit as tdit
    from tinyfusers_tpu_torch.models import mmdit as tmmdit

    jinit, make = _tiny_transformers()[model]
    params = random_tree(jinit, 41)
    port = make()
    load_params(port, params)
    quantize_params(port, QDTYPES[name][1])
    jq = jquantize_params(params, QDTYPES[name][0])
    cfg = port.cfg
    x = rand(42, 2, cfg.input_size, cfg.input_size, cfg.in_channels)
    if model == "dit":
        t = np.array([981.0, 5.0], np.float32)
        want = jdit.apply(jq, jnp.asarray(x), jnp.asarray(t), jdit.DiTConfig(
            **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}))
        with torch.no_grad():
            got = tdit.apply(port, to_t(x), to_t(t))
    else:
        jcfg = jmmdit.MMDiTConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        t = np.array([0.9, 0.2], np.float32)
        ctx, pooled = rand(43, 2, cfg.context_len, cfg.context_dim), rand(44, 2, cfg.pooled_dim)
        want = jmmdit.apply(jq, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                            jnp.asarray(pooled), jcfg)
        with torch.no_grad():
            got = tmmdit.apply(port, to_t(x), to_t(t), to_t(ctx), to_t(pooled))
    close(got, want, UNET)
