"""The traffic generator: plans repeat for a seed, budgets are the same
multiset for every seed, sessions ask the mix's number of questions a
video."""

import itertools

import numpy as np
import pytest

from gvbench import harness, traffic
from gvbench.drivers import serve

MIXES = sorted({w["traffic"] for w in harness.benchmark()["workloads"]})


def first(mix, seed, client, n):
    return list(itertools.islice(traffic.plan(mix, seed, client, 96), n))


@pytest.mark.parametrize("name", MIXES)
def test_plan_repeats_for_a_seed(name):
    mix = harness.traffic(name)
    assert first(mix, 2 ** 31 + 11, 3, 20) == first(mix, 2 ** 31 + 11, 3, 20)
    assert first(mix, 5, 3, 20) != first(mix, 6, 3, 20)


@pytest.mark.parametrize("name", MIXES)
def test_budgets_are_stratified(name):
    mix = harness.traffic(name)
    k = len(mix["budgets"])
    want = sorted(mix["budgets"] * 2)
    for seed in (0, 1, 2 ** 31 + 5, 2 ** 40):
        for client in range(mix["clients"]):
            got = [p.budget for p in first(mix, seed, client, 2 * k)]
            assert sorted(got) == want


@pytest.mark.parametrize("name", MIXES)
def test_sessions(name):
    mix = harness.traffic(name)
    plan = first(mix, 9, 0, 12)
    per = mix["questions_per_video"]
    for i, p in enumerate(plan):
        assert p.session == i // per
        assert p.video == plan[(i // per) * per].video


def test_derived_videos_differ_and_repeat():
    mix = dict(harness.traffic(MIXES[0]))
    mix["videos"] = dict(mix["videos"], height=24, width=32)
    bases = traffic.bases(mix, 4, 16)
    specs = [p.video for p in first(mix, 4, 0, 6)]
    a = [traffic.derive(bases, s) for s in specs]
    assert all(x.shape == (16, 24, 32, 3) and x.dtype == np.uint8 for x in a)
    assert np.array_equal(a[0], traffic.derive(traffic.bases(mix, 4, 16),
                                               specs[0]))
    assert len({x.tobytes() for x in a}) == len(set(specs))


@pytest.mark.parametrize("name", MIXES)
def test_every_key_is_read(name):
    assert set(harness.traffic(name)) <= serve.MIX_KEYS


def test_a_key_nothing_reads_is_refused():
    mix = dict(harness.traffic(MIXES[0]), loop="open")
    with pytest.raises(ValueError, match="loop"):
        serve.ServeRun({}, mix, 1, "cpu")
