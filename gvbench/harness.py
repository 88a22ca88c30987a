"""What every cell shares: finding a cell's files by name, the per-layer
metric readers, and the result line.

A cell of BENCHMARK.json names a configuration (gvbench/configs/<name>.json,
its plain reference gvbench/reference/<its "reference">.py), a traffic mix
(gvbench/traffic/<name>.json, whose "driver" names gvbench/drivers/<it>.py)
and, through BENCHMARK.json's per_layer list, the metrics it reports, each
read by gvbench/metrics/<metric name>.py. The numbers its correctness check
compares are held to gvbench/limits/<cell name>.json.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "grounded_video_llm_tpu")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, bench: Optional[dict] = None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(name: str) -> dict:
    return json.loads((HERE / "limits" / f"{name}.json").read_text())


def driver(name: str):
    return importlib.import_module(f"gvbench.drivers.{name}")


def metrics_of(workload: str, kind: str, bench: Optional[dict] = None
               ) -> List[dict]:
    """The end_to_end or per_layer metrics this cell reports: those that
    list it; an end-to-end metric that lists no cells is every cell's. A
    per-layer metric always lists its cells."""
    bench = bench or benchmark()
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])]
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def reader(metric: str):
    """gvbench/metrics/<metric>.py's read(ctx)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gvbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Context:
    """What a per-layer reader may read. Host times are perf_counter
    seconds; the window is [t_start, t_end]."""
    conf: dict
    mix: dict
    t_start: float
    t_end: float
    spans: List[tuple] = field(default_factory=list)     # (name, t0, t1)
    counters: Dict[str, float] = field(default_factory=dict)
    done: List[dict] = field(default_factory=list)       # finished in window
    trace: object = None                                 # trace.DeviceTrace

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def in_window(self, name: str) -> List[tuple]:
        return [s for s in self.spans if s[0] == name
                and self.t_start <= s[2] <= self.t_end]


def read_metrics(ctx: Context, wanted: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in wanted:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules(modules) -> List[str]:
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})
