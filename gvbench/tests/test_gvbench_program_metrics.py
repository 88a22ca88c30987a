"""The readers of the program's serving counters against numbers worked out
by hand, their silence where the program has no such counter, the
starved-idle share on a hand-built trace, and gvbench/tools/program_spans
end to end on the CPU at the program's micro sizes."""

import pytest
import torch

from gvbench import harness
from gvbench.tests.util import micro_config, small_mix
from gvbench.tools import program_spans
from gvbench.trace import DeviceTrace

BENCH = harness.benchmark()
COUNTERS = {"submits": 8, "lock_wait": 2.0, "lock_hold": 0.6,
            "admissions": 10, "queue_wait": 0.25, "timed_steps": 40,
            "slot_tokens": 96, "feature_lookups": 12, "feature_hits": 8,
            "prefix_lookups": 9, "prefix_hits": 6}
# metric → its value on COUNTERS with a pool of 8, and the counters it reads
WANT = {
    "lock_wait_ms.serve": (250.0, ("submits", "lock_wait")),
    "lock_hold_ms.serve": (75.0, ("submits", "lock_hold")),
    "queue_wait_ms.serve": (25.0, ("admissions", "queue_wait")),
    "slot_occupancy.serve": (30.0, ("timed_steps", "slot_tokens")),
    "feature_hit_share.serve": (100 * 8 / 12, ("feature_lookups",)),
    "prefix_hit_share.serve": (100 * 6 / 9, ("prefix_lookups",)),
}


def ctx(counters, trace=None):
    return harness.Context({}, {"server": {"pool_size": 8}}, 0.0, 10.0, [],
                           dict(counters), [], trace)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_counter_ratio(metric):
    value, _ = WANT[metric]
    assert harness.reader(metric).read(ctx(COUNTERS)) == pytest.approx(value)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_silent_without_the_counters(metric):
    """The parent program has none of these counters: nothing is read."""
    m = harness.reader(metric)
    assert m.read(ctx({})) is None
    for key in WANT[metric][1]:
        less = {k: v for k, v in COUNTERS.items() if k != key}
        assert m.read(ctx(less)) is None, key


@pytest.mark.parametrize("metric", ["feature_hit_share.serve",
                                    "prefix_hit_share.serve"])
def test_no_hits_read_zero(metric):
    counters = {k: v for k, v in COUNTERS.items() if not k.endswith("hits")}
    assert harness.reader(metric).read(ctx(counters)) == 0.0


def test_entries_read_the_programs_counters():
    new = [m for m in BENCH["per_layer"] if m["name"] in WANT]
    assert len(new) == len(WANT)
    for m in new:
        assert m["source"] == "program_counter"
    cells = {m["name"]: m["workloads"] for m in new}
    assert cells["prefix_hit_share.serve"] == ["serve.repeat3-c8"]


def hand_trace():
    """A stretch of 100 ns: device busy [10, 30) and [50, 60), so idle
    [0, 10), [30, 50), [60, 100): 70 ns."""
    return DeviceTrace(0, 100, device=[("k", 10, 30), ("k", 50, 60)])


@pytest.mark.parametrize("waits,want", [
    ([], 0.0),
    ([(5, 40)], 15.0),                     # 5 of [0,10), 10 of [30,50)
    # merged to [5, 45) and clipped to [90, 100): 5 + 15 + 10
    ([(5, 40), (35, 45), (90, 150)], 30.0),
    ([(-20, 200)], 70.0),                  # every idle ns
    ([(12, 28), (52, 58)], 0.0),           # only while busy
])
def test_starved_share_by_hand(waits, want):
    trace = hand_trace()
    got = program_spans.starved_share(trace, waits)
    assert got == pytest.approx(want)
    idle = harness.reader("idle_share.serve").read(ctx({}, trace))
    assert idle == pytest.approx(70.0) and got <= idle


def test_tool_windows_on_the_cpu():
    """Two windows of one program, the log off then on, traced: the
    counters' metrics in both, the program's spans beside the harness's in
    the second."""
    cell = harness.cell("serve.repeat3-c8", BENCH)
    conf = micro_config(harness.config(cell["config"]))
    mix = small_mix(harness.traffic(cell["traffic"]))
    torch.set_num_threads(2)
    lines = []
    program_spans.one_seed(cell, conf, mix, BENCH, 2 ** 31 + 5, 2.0,
                           ["off", "on"], True, lines.append, device="cpu",
                           say=lambda *a: None)
    off, on = lines
    assert (off["log"], on["log"]) == ("off", "on")
    for line in lines:
        assert line["failed"] == 0 and line["requests_per_s"] > 0
        assert set(WANT) <= set(line["metrics"])
    assert "agreement" not in off
    a = on["agreement"]
    assert a["encodes"] == a["encode_spans"]
    assert a["prefixes"] == a["prefix_spans"]
    assert a["submit_ms.program"] > 0 and a["submit_ms.serve"] > 0
    assert 0.0 <= on["idle_starved_share"] \
        <= on["metrics"]["idle_share.serve"] + 1e-9
    assert on["per_request_ms"]["requests"] > 0 and on["spans"] > 0
