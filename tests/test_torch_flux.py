"""FLUX.1 in the port against the benchmark's plain references on the CPU:
the transformer (models/flux.py) against h100bench/reference/flux.py, the
multi-axis RoPE against a rotation written out pair by pair, the
resolution-shifted schedule against BFL's ``time_shift``, the latent
packing, T5 (models/t5.py) against h100bench/reference/t5.py, a TINY
``pipeline.flux.generate`` against ``flux_pipeline.flux_image``, and the
transformer's spans inside ``generate.denoise``.

FLUX has no JAX counterpart, so its parity is against the plain float32
references, which import nothing of the port. Weights are the benchmark's
seeded draw (h100bench/lib/weights.py) on the CPU, every leaf non-zero.

Tolerances: the transformer and T5, 1e-4 absolute on outputs of unit
size (the same float32 arithmetic in another order through a few
layers; the same model in bf16 misses by more than 1e-2, which the
transformer's test asserts); RoPE 1e-6 (one float32 rounding of each
product); the schedule 1e-6 (the port's ladder is float32, BFL's
float64); packing exact (a permutation); images: at most 1 level anywhere,
where a value sits on a truncation boundary.
"""
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench.lib import weights  # noqa: E402
from h100bench.reference import flux as rflux, flux_pipeline, nn as rnn, t5 as rt5  # noqa: E402
from tinyfusers_tpu_torch import ops  # noqa: E402
from tinyfusers_tpu_torch.models import flux, t5  # noqa: E402
from tinyfusers_tpu_torch.pipeline import flux as pipe  # noqa: E402
from tinyfusers_tpu_torch.pipeline import rectified_flow as rf  # noqa: E402
from tinyfusers_tpu_torch.utils import profiling  # noqa: E402

from torch_parity import few_torch_threads  # noqa: E402,F401

TOL = dict(rtol=0.0, atol=1e-4)
SEED = 2 ** 31 + 23
CFG = json.loads((ROOT / "h100bench/tests/tiny_flux.json").read_text())


def _weights(spec, dtype=torch.float32):
    return weights.make(spec, SEED, "cpu", dtype)


@pytest.fixture(scope="module")
def tiny():
    """(the port's TINY Flux, the reference's weights W), the same numbers."""
    W = _weights(flux_pipeline.spec(CFG))
    model = pipe.Flux(pipe.TINY_FLUX_CFG, device="cpu")
    model.load_state_dict(W, strict=True)
    return model, W


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    m = CFG["transformer"]
    return (torch.randn(1, 16, 16, 4, generator=g), torch.tensor([0.73]),
            torch.randn(1, 12, m["joint_attention_dim"], generator=g),
            torch.randn(1, m["pooled_projection_dim"], generator=g), torch.tensor([3.5]))


def _reference_velocity(W, x, t, ctx, pooled, g):
    m = CFG["transformer"]
    pe = rflux.rope(rflux.ids(ctx.shape[1], 8, 8, "cpu"), m["axes_dims_rope"], m["theta"])
    v = rflux.forward(rnn.Prec("fp32"), W, m, "transformer", rflux.pack(x.permute(0, 3, 1, 2)),
                      ctx, pe, t, pooled, g)
    return rflux.unpack(v, 16, 16).permute(0, 2, 3, 1)


def test_transformer_matches_the_reference(tiny):
    model, W = tiny
    x, t, ctx, pooled, g = _inputs()
    want = _reference_velocity(W, x, t, ctx, pooled, g)
    got = flux.apply(model.transformer, x, t, ctx, pooled, g)
    assert want.abs().max() > 1.0
    torch.testing.assert_close(got, want, **TOL)
    # the guidance reaches the output
    assert (flux.apply(model.transformer, x, t, ctx, pooled, g + 1.0) - got).abs().max() > 1e-2
    # bf16 arithmetic misses the tolerance by far
    low = flux.FluxTransformer(flux.TINY_FLUX, device="cpu", dtype=torch.bfloat16)
    low.load_state_dict({k[len("transformer."):]: v for k, v in W.items()
                         if k.startswith("transformer.")})
    bf = flux.apply(low, x.bfloat16(), t, ctx, pooled, g).float()
    assert (bf - want).abs().max() > 100 * TOL["atol"]


def test_rope_rotates_interleaved_pairs():
    axes, theta = (4, 6, 6), 10000.0
    ids = flux.position_ids(3, 2, 3)
    assert ids[:3].abs().sum() == 0
    assert ids[3:].tolist() == [[0, i, j] for i in range(2) for j in range(3)]
    x = torch.randn(2, ids.shape[0], 3, sum(axes), generator=torch.Generator().manual_seed(1))
    got = ops.apply_rope(x, *ops.rope_table(ids, axes, theta))
    want = torch.empty_like(x)
    for n in range(ids.shape[0]):
        k = 0
        for axis, d in enumerate(axes):
            for j in range(d // 2):
                a = float(ids[n, axis]) * theta ** (-2.0 * j / d)
                c, s = math.cos(a), math.sin(a)
                x0, x1 = x[:, n, :, 2 * k], x[:, n, :, 2 * k + 1]
                want[:, n, :, 2 * k] = x0 * c - x1 * s
                want[:, n, :, 2 * k + 1] = x0 * s + x1 * c
                k += 1
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6)
    # text tokens (position 0 on every axis) pass unrotated
    assert torch.equal(got[:, :3], x[:, :3])


@pytest.mark.parametrize("tokens", [256, 1024, 4096])
def test_schedule_is_bfl_time_shift(tokens):
    mu = 0.5 + (1.15 - 0.5) / (4096 - 256) * (tokens - 256)
    t = np.linspace(1.0, 0.0, 29)
    with np.errstate(divide="ignore"):
        bfl = np.where(t > 0, math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0)), 0.0)
    got = rf.timesteps(28, pipe.shift_for(tokens)).double().numpy()
    np.testing.assert_allclose(got, bfl, rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(flux_pipeline.schedule(28, tokens, CFG), bfl, rtol=0.0, atol=1e-15)
    if tokens == 4096:
        assert abs(pipe.shift_for(tokens) - 3.1582) < 1e-4


def test_pack_is_bfl_rearrange_and_unpack_inverts_it():
    x = torch.arange(2 * 4 * 6 * 3, dtype=torch.float32).reshape(2, 4, 6, 3)  # (B, H, W, C)
    p = flux.pack(x)
    assert p.shape == (2, 6, 12)
    # b c (h ph) (w pw) -> b (h w) (c ph pw), from the NCHW latent
    assert torch.equal(p, rflux.pack(x.permute(0, 3, 1, 2)))
    assert torch.equal(p[0, 1], torch.stack([x[0, ph, 2 + pw, c] for c in range(3)
                                             for ph in range(2) for pw in range(2)]))
    assert torch.equal(flux.unpack(p, 4, 6), x)


def test_t5_matches_the_reference():
    c = dict(vocab_size=64, dim=32, ff_dim=48, num_layers=2, num_heads=4, head_dim=8,
             rel_buckets=8, rel_max_distance=16)
    W = _weights(rt5.spec(c, "t5"))
    model = t5.T5Encoder(t5.T5Config(**c), device="cpu")
    model.load_state_dict({k[3:]: v for k, v in W.items()})
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, 64, (2, 40)))
    want = rt5.forward(rnn.Prec("fp32"), W, c, "t5", ids)
    torch.testing.assert_close(t5.apply(model, ids), want, **TOL)
    assert torch.equal(rt5.buckets(40, c, "cpu").int(),
                       t5._relative_buckets(40, 40, t5.T5Config(**c)))


def _request(seed=5):
    rng = np.random.default_rng(seed)
    clip_ids = np.array([126, *rng.integers(0, 126, 4), 127, 127, 127])
    t5_ids = np.array([*rng.integers(2, 128, 6), 1, 0, 0, 0, 0, 0])
    lat = pipe.initial_latent(seed, 1, pipe.TINY_FLUX_CFG, device="cpu")
    assert lat.shape == (1, 16, 16, 4)
    return clip_ids, t5_ids, lat


def test_generate_matches_the_reference_pipeline(tiny):
    model, W = tiny
    clip_ids, t5_ids, lat = _request()
    got = pipe.generate(model, torch.as_tensor(clip_ids)[None], torch.as_tensor(t5_ids)[None], lat,
                        3.5, num_steps=3)
    want = flux_pipeline.Reference(CFG, W).flux_image(clip_ids, t5_ids, lat, 3, 3.5)
    assert got.dtype == torch.uint8 and got.shape == (1, 32, 32, 3)
    assert want.std() > 10.0
    assert (got[0].float() - want).abs().max() <= 1.0
    with pytest.raises(ValueError, match="max_sequence_length"):
        pipe.encode_text(model, torch.as_tensor(clip_ids)[None], torch.as_tensor(t5_ids)[None, :-1])


def test_flux_spans_nest_inside_denoise(tiny):
    model, _ = tiny
    clip_ids, t5_ids, lat = _request(6)
    with profiling.tracing():
        pipe.generate(model, torch.as_tensor(clip_ids)[None], torch.as_tensor(t5_ids)[None], lat,
                      3.5, num_steps=2)
        spans, _ = profiling.drain()
    denoise = [s for s in spans if s.name == "generate.denoise"]
    assert len(denoise) == 1
    for name in ("flux.double", "flux.single"):
        inner = [s for s in spans if s.name == name]
        assert len(inner) == 2   # one a step
        assert all(s.parent == denoise[0].id for s in inner)
        assert all(denoise[0].start_ns <= s.start_ns <= s.end_ns <= denoise[0].end_ns
                   for s in inner)
    order = sorted((s for s in spans if s.name.startswith("flux.")), key=lambda s: s.start_ns)
    assert [s.name for s in order] == ["flux.double", "flux.single"] * 2
