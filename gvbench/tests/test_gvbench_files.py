"""BENCHMARK.json resolves by name to the benchmark's files, and the
contract's limits on names and sizes hold."""

import json
import re

import pytest

from gvbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gvbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    conf = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    assert conf["name"] == cell["config"]
    assert harness.driver(mix["driver"]).run_cell
    assert (harness.HERE / "reference" / f"{conf['reference']}.py").exists()
    assert "max_logit_gap" in harness.limits(cell["name"])
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200 and "\n" not in cell["why"]
    e2e = {m["name"] for m in harness.metrics_of(cell["name"], "end_to_end",
                                                 BENCH)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(cell["name"], "per_layer", BENCH)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(conf):
    path = harness.ROOT / conf["file"]
    assert path.exists() and path.parent == harness.HERE / "configs"
    data = json.loads(path.read_text())
    assert data["reduced"] == conf["reduced"]
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    module = harness.reader(metric["name"])
    assert callable(module.read)
    moves = {m["name"] for m in BENCH["end_to_end"]}
    assert metric["moves"] in moves
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
