"""The serving driver: clients in a closed loop into one in-process
``ServingFrontend`` of the program, then the check against the reference.

Set-up makes the weights (gvbench/weights.py) and the base videos from the
seed, builds the engine and the frontend as the mix's "server" says, and
warms every shape the traffic uses with a few requests of the same kinds
through the same entry. The GPU host has no video decoder, so the
engine's ``preprocess_video`` is replaced by a hook that hands it the
frames of a placeholder file (which gives the feature cache its key) and
resizes them with the engine's own ``preprocess_frames``: the host resize
stays in the served path.

The window: every client runs its plan (gvbench/traffic.py), each request
timed from before ``submit`` to its last token, until the window's end;
requests in flight then finish outside it. A traced run goes on at the
same load for the mix's trace stretch after the window, under the
profiler, so its spans and counters are the window's, taken with the
profiler off; the profiler is stopped once the clients have returned
(trace.Tracer). The harness's spans (submit,
resize, encode, prefix) and the pool's own counters (``timings``) feed the
per-layer readers. Afterwards the program's state is freed and a sample of
the finished requests goes through the reference (gvbench/check.py).
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import math
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

from .. import check, harness, traffic, weights
from ..reference.vlm import IMAGE_SLOT, grounding_prompt_ids
from ..trace import Tracer

PIECES = ("clip", "video_encoder", "mm_projector", "video_projector", "llm",
          "extras")
# every key a mix under this driver may hold: a closed loop, so a key that
# asks for anything else is refused rather than ignored
MIX_KEYS = {"about", "sources", "driver", "clients", "mode", "videos",
            "questions_per_video", "budgets", "questions", "server", "check",
            "trace"}
WARMUP_CLIENT = 1_000_000


def port_config(conf: dict):
    """The program's VLMConfig from the configuration file."""
    from grounded_video_llm_tpu_torch.core import config as C

    llm = dict(conf["llm"])
    for k in ("rope_scaling_short", "rope_scaling_long"):
        llm[k] = tuple(llm.get(k) or ())
    top = {f.name: conf[f.name] for f in dataclasses.fields(C.VLMConfig)
           if f.name in conf and f.name not in ("clip", "video", "llm")}
    return C.VLMConfig(clip=C.CLIPVisionConfig(**conf["clip"]),
                       video=C.InternVideo2Config(**conf["video"]),
                       llm=C.LLMConfig(**llm), **top)


def make_weights(conf: dict, cfg, seed: int, device) -> dict:
    from grounded_video_llm_tpu_torch.models import vlm

    dtype = getattr(torch, conf["dtype"])
    layout = vlm.init_params(cfg, generator=None, device="meta", dtype=dtype,
                             skip=frozenset((p,) for p in PIECES))
    return weights.fill(layout, conf["init"], seed, device, dtype)


def p90(values: List[float]) -> float:
    """The nearest-rank 90th percentile: the ceil(0.9 n)-th smallest."""
    s = sorted(values)
    return s[max(math.ceil(0.9 * len(s)), 1) - 1]


class ServeRun:
    def __init__(self, conf: dict, mix: dict, seed: int, device, log=None):
        unknown = set(mix) - MIX_KEYS
        if unknown:
            raise ValueError(f"the serve driver does not read "
                             f"{sorted(unknown)}")
        self.conf, self.mix, self.seed = conf, mix, seed
        self.device = torch.device(device)
        self.log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
        self.spans: List[tuple] = []
        self.videos: Dict[str, tuple] = {}
        self.records: List[dict] = []
        self._ids = itertools.count()
        self._restore = []

    # -- set-up ---------------------------------------------------------

    def span(self, name: str, t0: float) -> None:
        self.spans.append((name, t0, time.perf_counter()))

    def setup(self) -> None:
        from grounded_video_llm_tpu_torch.core.config import GenerateConfig
        from grounded_video_llm_tpu_torch.serve import engine as engine_mod
        from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine
        from grounded_video_llm_tpu_torch.serve.server import ServingFrontend
        from grounded_video_llm_tpu_torch.text.tokenizer import load_tokenizer

        conf, srv = self.conf, self.mix["server"]
        self.cfg = cfg = port_config(conf)
        t = time.perf_counter()
        self.weights = make_weights(conf, cfg, self.seed, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.log(f"[setup] weights {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        self.bases = traffic.bases(self.mix, self.seed, cfg.num_frames)
        self.log(f"[setup] base videos {time.perf_counter() - t:.2f} s")
        self.vdir = Path(tempfile.mkdtemp(prefix="gvbench-videos-"))
        tok = load_tokenizer(cfg.llm_name, None, cfg.num_temporal_tokens)
        gen = GenerateConfig(max_new_tokens=srv["max_new_tokens"],
                             do_sample=False, temperature=0.0)
        eng = InferenceEngine(
            self.weights, cfg, tok, gen, seed=self.seed % 2 ** 63,
            device=self.device,
            feature_cache_size=srv["feature_cache_size"],
            prefix_kv_cache_size=srv["prefix_kv_cache_size"])
        eng.preprocess_video = self._preprocess_video
        encode = eng.encode_features

        def encode_features(temporal, spatial):
            t0 = time.perf_counter()
            out = encode(temporal, spatial)
            self.span("encode", t0)
            return out

        eng.encode_features = encode_features
        build_prefix = engine_mod.build_prefix_kv

        def build_prefix_kv(*a, **k):
            t0 = time.perf_counter()
            out = build_prefix(*a, **k)
            self.span("prefix", t0)
            return out

        engine_mod.build_prefix_kv = build_prefix_kv
        self._restore.append(
            lambda: setattr(engine_mod, "build_prefix_kv", build_prefix))
        self.engine = eng
        t = time.perf_counter()
        self.frontend = ServingFrontend(
            eng, pool_size=srv["pool_size"], prompt_len=srv["prompt_len"],
            max_new_tokens=srv["max_new_tokens"], chunk=srv["chunk"],
            prefix_cache=srv["prefix_cache"])
        self.log(f"[setup] frontend {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        self.warmup()
        self.log(f"[setup] warm-up {time.perf_counter() - t:.2f} s")

    def _preprocess_video(self, path: str):
        frames, duration = self.videos[path]
        t0 = time.perf_counter()
        temporal, spatial = self.engine.preprocess_frames(frames)
        self.span("resize", t0)
        return temporal, spatial, duration

    def _placeholder(self, tag: str) -> str:
        path = self.vdir / f"{tag}-{next(self._ids)}.mp4"
        path.write_bytes(b"placeholder")
        return str(path)

    def warmup(self) -> None:
        """Every kind of request the traffic sends, one after another at the
        largest budget: a session of the mix's questions a video (2 at
        most) on two videos, so each path runs, its kernels load and the
        pool's chunk graphs are captured."""
        srv = self.mix["server"]
        for v in range(2):
            it = traffic.plan(self.mix, self.seed, WARMUP_CLIENT + v,
                              self.cfg.num_frames)
            path = None
            for _ in range(min(self.mix["questions_per_video"], 2)):
                p = next(it)
                if path is None:
                    path = self._placeholder(f"warm{v}")
                    self.videos[path] = (traffic.derive(self.bases, p.video),
                                         p.video.duration)
                fut, _ = self.frontend.submit(path, p.question,
                                              self.mix["mode"],
                                              srv["max_new_tokens"])
                fut.result(timeout=600)
            self.videos.pop(path, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- the window ---------------------------------------------------------

    def _client(self, c: int, t_end: float) -> None:
        it = traffic.plan(self.mix, self.seed, c, self.cfg.num_frames)
        session, path = None, None
        while True:
            p = next(it)
            if p.session != session:
                self.videos.pop(path, None)
                session = p.session
                path = self._placeholder(f"c{c}")
                self.videos[path] = (traffic.derive(self.bases, p.video),
                                     p.video.duration)
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            rec = {"plan": p, "t0": t0}
            try:
                fut, _ = self.frontend.submit(path, p.question,
                                              self.mix["mode"], p.budget)
                self.span("submit", t0)
                rec["tokens"] = [int(t) for t in fut.result(timeout=300)]
            except Exception as e:  # noqa: BLE001 — a failed request counts
                rec["error"] = f"{type(e).__name__}: {e}"
            rec["t1"] = time.perf_counter()
            self.records.append(rec)
        self.videos.pop(path, None)

    def window(self, seconds: float, trace: bool) -> None:
        """The measured window, then, with trace, a stretch of the mix's
        "trace" seconds under the profiler at the same load (the clients
        go on sending), so the window's spans and counters are taken with
        the profiler off."""
        timings = self.frontend.server.timings
        self.t_start = time.perf_counter()
        self.t_end = self.t_start + seconds
        traced = self.mix["trace"]["seconds"] if trace else 0.0
        before = dict(timings)
        clients = [threading.Thread(target=self._client,
                                    args=(c, self.t_end + traced),
                                    daemon=True)
                   for c in range(self.mix["clients"])]
        for th in clients:
            th.start()
        time.sleep(max(0.0, self.t_end - time.perf_counter()))
        after = dict(timings)
        self.tracer = None
        if trace:
            self.tracer = Tracer()
            self.tracer.start()
            time.sleep(traced)
            self.tracer.end()
        for th in clients:
            th.join(timeout=600)
        self.hung = sum(th.is_alive() for th in clients)
        if trace:
            # every request has returned, so the pool's thread is idle
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.tracer.stop()
        self.counters = {k: after.get(k, 0) - before.get(k, 0)
                         for k in set(after) | set(before)}
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)
        else:
            self.memory_peak = 0

    # -- readings -----------------------------------------------------------

    def finished(self) -> List[dict]:
        return [r for r in self.records
                if "tokens" in r and r["t1"] <= self.t_end]

    def end_to_end(self) -> Dict[str, float]:
        done = self.finished()
        out = {"requests_per_s": len(done) / (self.t_end - self.t_start)}
        if done:
            out["latency_p90_s"] = p90([r["t1"] - r["t0"] for r in done])
        return out

    def context(self) -> harness.Context:
        done = []
        for r in self.finished():
            ids = grounding_prompt_ids(self.conf, r["plan"].question)
            slot = ids.index(IMAGE_SLOT)
            done.append({"pre": slot, "post": len(ids) - slot - 1,
                         "served": len(r["tokens"]), "t0": r["t0"],
                         "t1": r["t1"]})
        return harness.Context(
            self.conf, self.mix, self.t_start, self.t_end, list(self.spans),
            dict(self.counters), done,
            self.tracer.read(self.spans) if self.tracer is not None else None)

    @property
    def attempted(self) -> int:
        return sum(r["t0"] < self.t_end for r in self.records)

    def failed(self, window_only: bool = True) -> int:
        """Requests that raised (sent in the window, or at any time) and
        clients that never returned."""
        return self.hung + sum("error" in r for r in self.records
                               if r["t0"] < self.t_end or not window_only)

    # -- after the window ---------------------------------------------------

    def free_program(self) -> None:
        self.frontend.shutdown()
        for undo in self._restore:
            undo()
        self.frontend = self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sampled(self) -> List[check.Served]:
        """The finished requests the check compares, drawn from the seed."""
        served = [check.Served(r["plan"].video, r["plan"].question,
                               r["tokens"]) for r in self.finished()]
        idx = check.sample(served, self.mix["check"]["sample"], self.seed)
        return [served[i] for i in idx]

    def check(self, control: bool = False, requests=None) -> dict:
        """The readings of the sampled requests, or of ``requests``
        (check.gaps)."""
        return check.gaps(self.conf, self.weights,
                          self.sampled() if requests is None else requests,
                          lambda spec: traffic.derive(self.bases, spec),
                          self.device, control=control)

    def close(self) -> None:
        shutil.rmtree(self.vdir, ignore_errors=True)


def run_cell(workload: dict, conf: dict, mix: dict, seed: int,
             seconds: float, trace: bool, device, t_process: float,
             bench: dict, limits: dict, log=None) -> dict:
    """One run of a serving cell → the result line's dict."""
    run = ServeRun(conf, mix, seed, device, log)
    try:
        run.setup()
        setup_s = time.perf_counter() - t_process
        run.window(seconds, trace)
        name = workload["name"]
        if trace:
            wanted = harness.metrics_of(name, "per_layer", bench)
            ctx = run.context()
            metrics = harness.read_metrics(ctx, wanted)
        else:
            ctx = None
            e2e = dict(run.end_to_end(), setup_s=setup_s)
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in harness.metrics_of(name, "end_to_end", bench)
                       if m["name"] in e2e}
        dev = device_info(run.device, run.memory_peak)
        result = {"correct": False, "attempted": run.attempted,
                  "failed": run.failed(), "metrics": metrics, "device": dev}
        if ctx is not None and ctx.trace is not None:
            dev["busy_s"] = ctx.trace.busy_s
            dev["window_s"] = ctx.trace.window_s
            result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                                   "idle_gaps": ctx.trace.top_gaps()}
        run.log(f"[window] {len(run.finished())} requests finished in "
                f"{seconds} s, {run.attempted} attempted, {run.failed()} "
                "failed")
        run.free_program()
        t = time.perf_counter()
        readings = run.check()
        run.log(f"[check] {readings['tokens']} served tokens compared in "
                f"{time.perf_counter() - t:.1f} s")
        checks = check.verdict(
            {"max_logit_gap": readings["gap"],
             "failed_requests": run.failed(window_only=False)},
            {"max_logit_gap": limits["max_logit_gap"], "failed_requests": 0})
        result["correct"] = bool(readings["tokens"] > 0
                                 and check.passed(checks))
        result["checks"] = checks
        return result
    finally:
        run.close()


def device_info(device: torch.device, memory_peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(memory_peak)}
