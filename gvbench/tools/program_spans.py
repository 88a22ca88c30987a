"""The program's own serving spans beside the harness's, and what the span
log costs: a cell's windows with ``ContinuousServer.span_log`` attached and
without, in turn, on one program per seed.

    python3 -m gvbench.tools.program_spans --workload serve.distinct-c8 \
        --seeds 3100000001,3100000003 [--order off,on,on,off] \
        [--seconds 51] [--trace 1] [--out build/program_spans.jsonl]

Each window is the benchmark's (gvbench/drivers/serve.ServeRun: the same
set-up, clients, window and traced stretch), without the check against the
reference. Printed per window, one JSON line: the end-to-end metrics, every
per-layer metric of the cell as the harness reads it, and, with the log
attached, the program's spans read beside the harness's:

- ``agreement``: (lock_wait + lock_hold + stage) / submits against
  ``submit_ms.serve``; the mean ``engine.preprocess`` span against
  ``resize_ms.serve``; the window's ``encodes`` and ``prefixes`` against the
  harness's ``encode`` and ``prefix`` spans;
- ``per_request_ms``: the mean of each span of a request over the requests
  whose submit began and whose decode ended in the window;
- ``hold_ms``: the lock's hold a submit and the engine's counted parts of
  it (preprocess, encode, prefix, tokenize);
- ``chunk_ms``: the mean ``scheduler.chunk`` span (a chunk's dispatch to
  its tokens read) that ended in the window, and their number;
- ``idle_starved_share``: the share of the traced stretch in which no
  device activity ran while the pool's loop waited on an empty queue
  (``scheduler.wait``), in %, beside ``idle_share.serve``.

First, ``record_ns``: the host cost of one ``obs/profiler.record`` call
with a log and without. Not run by the benchmark.
"""

import argparse
import faulthandler
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

REQUEST_SPANS = ("frontend.submit", "frontend.lock_wait", "frontend.hold",
                 "frontend.stage", "engine.preprocess", "engine.encode",
                 "engine.prefix", "engine.tokenize", "scheduler.queue",
                 "scheduler.admit", "scheduler.decode")


def merged(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def starved_share(trace, waits) -> float:
    """The share of the traced stretch [trace.t0, trace.t1] in which no
    device activity ran while a wait span (start, end; the trace's clock)
    was open, in %."""
    if trace.t1 <= trace.t0:
        return 0.0
    waits = merged((max(s, trace.t0), min(e, trace.t1)) for s, e in waits)
    both, i = 0, 0
    for gs, ge in trace.gaps():
        while i < len(waits) and waits[i][1] <= gs:
            i += 1
        j = i
        while j < len(waits) and waits[j][0] < ge:
            both += min(ge, waits[j][1]) - max(gs, waits[j][0])
            j += 1
    return 100.0 * both / (trace.t1 - trace.t0)


def record_cost(n: int = 200_000) -> Dict[str, float]:
    """ns a call of record() into a counter dict, without a log and with
    one."""
    from grounded_video_llm_tpu_torch.obs.profiler import SpanLog, record

    out = {}
    for name, log in (("off", None), ("on", SpanLog())):
        t = {}
        t0 = time.perf_counter_ns()
        for _ in range(n):
            record(t, "x", t0, count="n", log=log, name="s", request_id=1)
        out[name] = (time.perf_counter_ns() - t0) / n
    return out


def spans_by_request(log) -> Dict[int, Dict[str, Tuple[int, int]]]:
    out: Dict[int, Dict[str, Tuple[int, int]]] = {}
    for name, rid, _, t0, t1 in log.spans:
        if rid is not None:
            out.setdefault(rid, {})[name] = (t0, t1)
    return out


def program_readings(run, log, metrics: dict, trace) -> dict:
    """The log's spans over run's window (and trace's stretch), beside the
    harness's readings (metrics: name → value)."""
    lo, hi = int(run.t_start * 1e9), int(run.t_end * 1e9)
    c = run.counters
    n = c.get("submits", 0)
    pre = [t1 - t0 for name, _, _, t0, t1 in log.spans
           if name == "engine.preprocess" and lo <= t1 <= hi]
    harness = {name: sum(s[0] == name and run.t_start <= s[2] <= run.t_end
                         for s in run.spans) for name in ("encode", "prefix")}
    out = {"agreement": {
        "submit_ms.program": (1000.0 * (c.get("lock_wait", 0)
                                        + c.get("lock_hold", 0)
                                        + c.get("stage", 0)) / n
                              if n else None),
        "submit_ms.serve": metrics.get("submit_ms.serve"),
        "preprocess_ms.program": sum(pre) / len(pre) / 1e6 if pre else None,
        "resize_ms.serve": metrics.get("resize_ms.serve"),
        "encodes": c.get("encodes", 0), "encode_spans": harness["encode"],
        "prefixes": c.get("prefixes", 0), "prefix_spans": harness["prefix"]}}
    done = [s for s in spans_by_request(log).values()
            if "frontend.submit" in s and "scheduler.decode" in s
            and s["frontend.submit"][0] >= lo
            and s["scheduler.decode"][1] <= hi]
    per = {"requests": len(done)}
    for name in REQUEST_SPANS:
        if done:
            per[name] = sum(s[name][1] - s[name][0] for s in done
                            if name in s) / len(done) / 1e6
    out["per_request_ms"] = per
    chunks = [t1 - t0 for name, _, _, t0, t1 in log.spans
              if name == "scheduler.chunk" and lo <= t1 <= hi]
    out["chunk_ms"] = {"chunks": len(chunks),
                       "mean": sum(chunks) / len(chunks) / 1e6 if chunks
                       else None}
    if n:
        out["hold_ms"] = {k: 1000.0 * c.get(k, 0) / n for k in (
            "lock_hold", "preprocess", "encode", "prefix", "tokenize")}
    if trace is not None:
        waits = [(run.tracer.to_ns(t0 / 1e9), run.tracer.to_ns(t1 / 1e9))
                 for name, _, _, t0, t1 in log.spans
                 if name == "scheduler.wait"]
        out["idle_starved_share"] = starved_share(trace, waits)
    return out


def one_seed(cell, conf, mix, bench, seed, seconds, order, trace, emit,
             device="cuda", say=None):
    """One program, set up from seed, through a window per entry of order
    ("on": the span log attached); emit(line) for each."""
    from gvbench import harness
    from gvbench.drivers.serve import ServeRun
    from grounded_video_llm_tpu_torch.obs.profiler import SpanLog

    faulthandler.dump_traceback_later(600, exit=True)
    run = ServeRun(conf, mix, seed, device, say)
    wanted = harness.metrics_of(cell["name"], "per_layer", bench)
    try:
        t = time.perf_counter()
        run.setup()
        setup_s = time.perf_counter() - t
        for k, side in enumerate(order):
            faulthandler.dump_traceback_later(seconds + 600, exit=True)
            log = SpanLog() if side == "on" else None
            run.frontend.server.span_log = log
            run.records, run.spans = [], []
            run.window(seconds, trace)
            run.frontend.server.span_log = None
            ctx = run.context()
            metrics = harness.read_metrics(ctx, wanted)
            line = {"workload": cell["name"], "seed": seed, "window": k,
                    "log": side, "setup_s": setup_s,
                    **run.end_to_end(), "attempted": run.attempted,
                    "failed": run.failed(),
                    "metrics": {n: m["value"] for n, m in metrics.items()}}
            if log is not None:
                line.update(program_readings(run, log, line["metrics"],
                                             ctx.trace))
                line["spans"] = len(log.spans)
            if ctx.trace is not None:
                line["busy_s"] = ctx.trace.busy_s
                line["window_s"] = ctx.trace.window_s
            emit(line)
    finally:
        if getattr(run, "frontend", None) is not None:
            run.free_program()
        run.close()
        faulthandler.cancel_dump_traceback_later()
    gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--order", default="off,on,on,off")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from gvbench.run import print_card, set_environment

    set_environment()
    import torch

    from gvbench import harness

    if not torch.cuda.is_available():
        print("program_spans: needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    cell = harness.cell(args.workload, bench)
    conf = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    seconds = args.seconds or bench["run_seconds"]
    order = args.order.split(",")
    if set(order) - {"on", "off"}:
        raise SystemExit("--order takes on and off")
    out = open(args.out, "a") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out is not None:
            out.write(text + "\n")
            out.flush()

    emit({"workload": cell["name"], "record_ns": record_cost()})
    for seed in (int(s) for s in args.seeds.split(",")):
        one_seed(cell, conf, mix, bench, seed, seconds, order,
                 bool(args.trace), emit)
        torch.cuda.empty_cache()
    print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
