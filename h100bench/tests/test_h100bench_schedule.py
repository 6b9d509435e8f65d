"""The open loop's schedule: the same for the same seed, the same work in
another order for another seed, Poisson-like gaps of the stated rate."""
import json

import numpy as np
import pytest

from h100bench.drivers import engine_open_loop as drv
from h100bench.lib import harness

MIX = json.loads((harness.HERE / "traffic/poisson-8slot.json").read_text())


def _sched(seed, seconds=50.0):
    return drv.schedule(MIX, seed, seconds, 77, 49408)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 3 * 2 ** 40])
def test_same_seed_same_schedule(seed):
    a, b = _sched(seed), _sched(seed)
    assert len(a) == len(b) == round(MIX["rate_per_s"] * 50.0)
    for x, y in zip(a, b):
        assert x[0] == y[0] and x[1] == y[1] and x[3] == y[3] and (x[2] == y[2]).all()


def test_other_seed_same_work_other_order():
    a, b = _sched(1), _sched(2)
    assert [x[0] for x in a] != [x[0] for x in b]
    assert sorted(np.diff([x[0] for x in a])) == pytest.approx(sorted(np.diff([x[0] for x in b])),
                                                             abs=0.2)
    assert sorted(x[1] for x in a) == sorted(x[1] for x in b)
    lens = lambda s: sorted(int((x[2][1:] != 49407).sum()) for x in s)  # noqa: E731
    assert lens(a) == lens(b)


def test_arrivals_fill_the_window_at_the_rate():
    s = _sched(3)
    due = np.array([x[0] for x in s])
    assert due[0] == 0.0 and (np.diff(due) > 0).all() and due[-1] < 50.0
    gaps = np.diff(due)
    assert gaps.mean() == pytest.approx(1 / MIX["rate_per_s"], rel=0.05)
    assert np.std(gaps) == pytest.approx(gaps.mean(), rel=0.15)  # exponential: std = mean
    assert {x[1] for x in s} == set(MIX["steps"])


def test_prompts():
    for _, _, ids, _ in _sched(4):
        assert ids.shape == (77,) and ids[0] == 49406
        n = int((ids[1:] != 49407).sum())
        assert MIX["prompt_tokens"][0] <= n <= MIX["prompt_tokens"][1]
        assert (ids[1:1 + n] < 49406).all() and (ids[1 + n:] == 49407).all()
