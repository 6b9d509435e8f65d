"""The plain reference against values worked out by hand at TINY sizes."""
import json
import math

import numpy as np
import pytest
import torch

from h100bench.lib import harness, weights
from h100bench.reference import clip, mmdit, nn, pipelines


def test_attention_by_hand():
    q = torch.tensor([[[[1.0, 0.0]]]])
    k = torch.tensor([[[[1.0, 0.0], [0.0, 1.0]]]])
    v = torch.tensor([[[[2.0, 0.0], [0.0, 4.0]]]])
    w = math.exp(1 / math.sqrt(2)) / (math.exp(1 / math.sqrt(2)) + 1.0)
    out = nn.attention(q, k, v)
    assert out[0, 0, 0].tolist() == pytest.approx([2.0 * w, 4.0 * (1 - w)], rel=1e-6)
    masked = nn.attention(q, k, v, torch.tensor([[0.0, float("-inf")]]))
    assert masked[0, 0, 0].tolist() == pytest.approx([2.0, 0.0])


def test_timestep_embedding_by_hand():
    e = nn.timestep_embedding(torch.tensor([0.0, 2.0]), 4)
    # freqs exp(-ln(1e4) * [0, 1] / 2) = [1, 0.01]
    assert e[0].tolist() == pytest.approx([1.0, 1.0, 0.0, 0.0])
    assert e[1].tolist() == pytest.approx([math.cos(2.0), math.cos(0.02), math.sin(2.0),
                                           math.sin(0.02)], rel=1e-6)


def test_ddim_rungs_and_alphas():
    assert pipelines.ddim_rungs(20).tolist() == list(range(1, 1000, 50))
    r30 = pipelines.ddim_rungs(30)
    assert len(r30) == 30 and r30[-1] == 958 and r30[1] == 34
    acp = pipelines.alphas_cumprod({"beta_start": 0.00085, "beta_end": 0.012,
                                    "num_train_timesteps": 1000})
    assert acp[0] == pytest.approx(1 - 0.00085) and acp[999] == pytest.approx(0.0047, abs=1e-4)


def test_flow_ladder():
    ts = pipelines.flow_ladder(2, 3.0)
    assert ts.tolist() == pytest.approx([1.0, 0.75, 0.0])  # 3 * 0.5 / (1 + 2 * 0.5)


def test_levels_truncate():
    x = torch.tensor([-2.0, -1.0, 0.0, 0.999, 2.0])
    assert nn.to_levels(x).tolist() == [0.0, 0.0, 127.0, 254.0, 255.0]


def test_fp8_control_rounds_to_e4m3():
    P = nn.Prec("fp8")
    x = torch.tensor([448.0, 1.0, 1.0625, 0.5])
    assert P.act(x).tolist() == [448.0, 1.0, 1.0, 0.5]   # 3 mantissa bits
    W = {"w": torch.tensor([[1.0, 1.1], [2.0, 0.3]])}
    # row 0's scale is 1.1 / 448: 1.0 maps to 407.3, whose e4m3 neighbours are 32 apart
    assert P.weight(W, "w")[0].tolist() == pytest.approx([416 * 1.1 / 448, 1.1])
    with pytest.raises(ValueError):
        nn.Prec("int3")


def test_pos_embed_by_hand():
    e = mmdit.pos_embed(2, 8, "cpu")   # quarter 2: w = [1, 0.01]
    row = lambda i: [math.sin(i), math.sin(0.01 * i), math.cos(i), math.cos(0.01 * i)]  # noqa: E731
    for k, (i, j) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        assert e[k].tolist() == pytest.approx(row(i) + row(j), rel=1e-6)


def test_clip_is_causal_and_pools_at_the_first_eot():
    cfg = json.loads((harness.HERE / "tests/tiny_sd3.json").read_text())
    W = weights.make(pipelines.sd3_spec(cfg), 1, "cpu", torch.float32)
    c = cfg["clip_l"]
    ids = torch.tensor([[126, 5, 9, 127, 127, 127, 127, 127]])
    other = ids.clone()
    other[0, 4] = 3                                   # after the first EOT
    a, b = (clip.forward(nn.Prec(), W, c, "clip_l", i) for i in (ids, other))
    assert torch.equal(a[0][:, :4], b[0][:, :4]) and not torch.equal(a[0], b[0])
    assert torch.equal(a[2], b[2])
    proj = W["clip_l.text_projection.weight"]
    assert a[2][0].tolist() == pytest.approx((a[0][0, 3] @ proj.T).tolist(), rel=1e-5)


def test_weights_are_seeded_and_scaled():
    cfg = json.loads((harness.HERE / "tests/tiny_sd.json").read_text())
    spec = pipelines.sd_spec(cfg)
    a = weights.make(spec, 11, "cpu", torch.float32)
    b = weights.make(spec, 11, "cpu", torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all((t != 0).all() for t in a.values())
    w = a["unet.input.1.0.conv1.weight"]
    assert float(w.std()) == pytest.approx(1 / np.sqrt(w[0].numel()), rel=0.1)
    assert float(a["unet.out_norm.weight"].mean()) == pytest.approx(1.0, abs=0.05)
