"""HTTP serving front-end over continuous batching — the production surface
(port of grounded_video_llm_tpu/serve/server.py; same endpoints, status
codes and SSE format).

The reference ships only a CLI demo (reference inference.py:137-190); this is
the beyond-parity serving axis: an OpenAI-style JSON API (stdlib
http.server — no external deps in this image) over ContinuousScheduler's
slot pool, with per-token SSE streaming through the incremental detokenizer.
Video encode rides the engine's feature cache, so repeated videos skip the
dual-stream encoders at admission.

Endpoints:
  GET  /healthz      → {"status": "ok", ...}
  GET  /v1/models    → model card (family, quantization, pool shape)
  POST /v1/generate  → body {"video_path", "prompt", "mode"?: "qa"|
                       "grounding"|"referring", "max_new_tokens"?,
                       "stream"?: false}
      stream=false → {"text", "parsed", "intervals", "duration",
                      "num_tokens"}
      stream=true  → text/event-stream; `data: {"delta": ...}` per text
                     fragment, then `data: {"done": true, "text", "parsed",
                     ...}`, then `data: [DONE]`.

Run: python -m grounded_video_llm_tpu_torch.cli.server --llm phi3.5
--port 8321 (on the card; --debug_tiny --device cpu for a random-weight
smoke server on the CPU).
"""

from __future__ import annotations

import json
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..obs.profiler import record
from ..text.streaming import TokenTextStream
from .continuous import ContinuousScheduler, ContinuousServer
from .engine import InferenceEngine


class ServingFrontend:
    """Engine + continuous-batching scheduler behind a thread-safe submit().

    prompt_len/max_new_tokens/pool_size fix the pool's shapes (per-request
    budgets ≤ max_new_tokens ride the ragged retirement path)."""

    def __init__(self, engine: InferenceEngine, pool_size: int = 4,
                 prompt_len: int = 256, max_new_tokens: int = 64,
                 chunk: int = 8, spec_draft_len: int = 0,
                 prefix_cache: bool = False, shared_prefix_pool: bool = False,
                 chunk_long: int = 0, pipeline_chunks: bool = False,
                 warmup: Optional[bool] = None):
        g = engine.gen_cfg
        self.engine = engine
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.prefix_cache = prefix_cache
        if shared_prefix_pool and not prefix_cache:
            raise ValueError("--shared_prefix_pool requires --prefix_cache "
                             "(every request must be prefix-backed)")
        prefix_len = None
        if prefix_cache:
            # prefix-backed admission (Request.prefix): the pool must also
            # hold the per-video [pre-image text | video tokens] head. Its
            # length is template-constant — measure it once.
            from ..text.templates import IMAGE_TOKEN_INDEX
            from ..text.tokenizer import tokenize_with_image

            seq = tokenize_with_image(engine.build_prompt("x", "qa", 1.0),
                                      engine.tokenizer)
            prefix_len = (seq.index(IMAGE_TOKEN_INDEX)
                          + engine.cfg.num_video_tokens)
        self.server = ContinuousServer(
            engine.params, engine.cfg, pool_size=pool_size,
            prompt_len=prompt_len, max_new_tokens=max_new_tokens,
            chunk=chunk, temperature=g.temperature, top_p=g.top_p,
            do_sample=g.do_sample,
            eos_token_id=engine.tokenizer.eos_token_id,
            pad_token_id=engine.tokenizer.pad_token_id,
            spec_draft_len=spec_draft_len, prefix_len=prefix_len,
            shared_prefix=shared_prefix_pool, chunk_long=chunk_long,
            pipeline_chunks=pipeline_chunks)
        # build the pool's kernels at startup rather than inside the first
        # live requests. Default: warm whenever chunk_long is set (as the
        # JAX package does); pass True/False to force.
        if warmup if warmup is not None else chunk_long > 0:
            self.server.warmup(
                kind="prefix" if prefix_cache else "feats")
        self.scheduler = ContinuousScheduler(self.server)
        self._lock = threading.Lock()  # engine cache + rng aren't thread-safe
        # the counters added outside _lock: before it is taken (preprocess,
        # preprocesses, preprocess_joins) and after it is released (stage,
        # submits); and the request ids
        self._count_lock = threading.Lock()
        self._next_request_id = 0
        # a video's feature-cache key → Future of its preprocessed pixels,
        # from the first submit that missed the cache until that submit's
        # hold ends (its features are in the LRU by then)
        self._preps: dict = {}
        self._preps_lock = threading.Lock()

    def submit(self, video_path: str, prompt: str, mode: str = "qa",
               max_new_tokens: Optional[int] = None, on_token=None):
        """→ (Future[np.int32 tokens], duration). A video the feature cache
        lacks is decoded and resized (``engine.preprocess_video``) on the
        calling thread before the frontend's lock, so clients resize at
        the same time; a submit of a video another submit is preparing
        waits for that one's pixels and does not resize again. Under the
        lock run the feature LRU (the encode on a miss), the prefix build
        and tokenization, also on the calling thread; admission and decode
        run on the scheduler thread.

        Adds to the pool's ``timings``: ``preprocess`` seconds and
        ``preprocesses`` (the resizes run) and ``preprocess_joins`` (the
        submits that took another's), ``lock_wait`` and ``lock_hold``
        seconds (waiting for the lock, holding it) and the engine's
        counters under the hold, then ``stage`` seconds (the staged
        transfers and the queue put) and ``submits``. The request's id,
        drawn here, marks its spans in the pool's ``span_log`` where one is
        attached: frontend.submit, engine.preprocess (before the lock
        wait), frontend.lock_wait, .hold, .stage."""
        log = self.server.span_log
        t0 = time.perf_counter_ns()
        with self._count_lock:
            rid = self._next_request_id
            self._next_request_id += 1
        key, prepped, owner = self._prepare(video_path, rid)
        tw = t0 if prepped is None else time.perf_counter_ns()
        try:
            with self._lock:
                t1 = record(self.server.timings, "lock_wait", tw, log=log,
                            name="frontend.lock_wait", request_id=rid)
                try:
                    if (prepped is None
                            and key not in self.engine._feature_cache):
                        # evicted since _prepare found it: resize here, not
                        # in the engine, so the count takes _count_lock as
                        # the resizes outside the lock do
                        prepped = self._preprocess(video_path, rid)
                    req, duration = self.engine.make_continuous_request(
                        video_path, prompt, mode=mode,
                        prompt_len=self.prompt_len,
                        max_new_tokens=max_new_tokens, on_token=on_token,
                        prefix_rope_hint=(self.server.max_len
                                          if self.prefix_cache else None),
                        timings=self.server.timings, span_log=log,
                        request_id=rid, prepped=prepped)
                finally:
                    record(self.server.timings, "lock_hold", t1, log=log,
                           name="frontend.hold", request_id=rid)
        finally:
            if owner:
                with self._preps_lock:
                    del self._preps[key]
        if req.prefix is not None:
            # validate HERE so an oversized prefix fails only THIS caller —
            # the same check inside _admit would take down every in-flight
            # request through the scheduler's pool-reset error path
            Sp = req.prefix[0].shape[2]
            need = (Sp + self.prompt_len + self.max_new_tokens
                    + self.server._chunk_margin)
            if need > self.server.max_len:
                raise ValueError(
                    f"prefix ({Sp} slots) + question bucket "
                    f"({self.prompt_len}) + budget need {need} cache slots "
                    f"but the pool has max_len={self.server.max_len}; this "
                    "video's pre-image prompt head is longer than the one "
                    "the server was sized for")
        t2 = time.perf_counter_ns()
        fut = self.scheduler.submit(req)
        with self._count_lock:
            record(self.server.timings, "stage", t2, count="submits",
                   log=log, name="frontend.stage", request_id=rid)
        record(None, None, t0, log=log, name="frontend.submit",
               request_id=rid)
        return fut, duration

    def _prepare(self, video_path: str, rid: int):
        """Outside the frontend's lock: → (the video's feature-cache key,
        its (temporal, spatial, duration) or None where the features are
        cached, whether this call owns the in-flight entry and so removes
        it). The cache is only peeked at (no counter, no LRU reorder): a
        wrong answer costs time, never tokens."""
        key = self.engine._video_key(video_path)
        with self._preps_lock:
            fut = self._preps.get(key)
            owner = fut is None
            if owner:
                if key in self.engine._feature_cache:
                    return key, None, False
                fut = self._preps[key] = Future()
        if not owner:
            with self._count_lock:
                t = self.server.timings
                t["preprocess_joins"] = t.get("preprocess_joins", 0) + 1
            return key, fut.result(), False
        try:
            prepped = self._preprocess(video_path, rid)
        except BaseException as e:
            # every waiter gets this error; the next submit resizes anew
            with self._preps_lock:
                del self._preps[key]
            fut.set_exception(e)
            raise
        fut.set_result(prepped)
        return key, prepped, True

    def _preprocess(self, video_path: str, rid: int):
        t0 = time.perf_counter_ns()
        prepped = self.engine.preprocess_video(video_path)
        with self._count_lock:
            record(self.server.timings, "preprocess", t0,
                   count="preprocesses", log=self.server.span_log,
                   name="engine.preprocess", request_id=rid)
        return prepped

    def result_payload(self, tokens: np.ndarray, duration: float) -> dict:
        eos = self.engine.tokenizer.eos_token_id
        ids = [int(t) for t in tokens if int(t) != eos]
        text = self.engine.tokenizer.decode(
            ids, skip_special_tokens=True).strip()
        r = self.engine._result(text, duration)
        return {"text": r.text, "parsed": r.parsed,
                "intervals": r.intervals, "duration": r.duration,
                "num_tokens": len(ids)}

    def shutdown(self):
        self.scheduler.shutdown()


def make_handler(frontend: ServingFrontend):
    eng = frontend.engine

    class Handler(BaseHTTPRequestHandler):
        # quiet default request logging (one line per request on stderr
        # interferes with bench output parsing)
        def log_message(self, fmt, *args):  # noqa: A003
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._json(200, {"status": "ok",
                                 "model": eng.cfg.llm_name,
                                 "pool_size": frontend.server.pool_size})
            elif self.path == "/v1/models":
                self._json(200, {"data": [{
                    "id": f"grounded-video-llm-{eng.cfg.llm_name}",
                    "family": eng.cfg.llm_name,
                    "num_frames": eng.cfg.num_frames,
                    "num_video_tokens": eng.cfg.num_video_tokens,
                    "max_new_tokens": frontend.max_new_tokens,
                    "modes": ["qa", "grounding", "referring"]}]})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                video_path = body["video_path"]
                prompt = body["prompt"]
                mode = body.get("mode", "qa")
                budget = body.get("max_new_tokens")
                stream = bool(body.get("stream", False))
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e!r}"})
                return
            try:
                if not stream:
                    fut, duration = frontend.submit(video_path, prompt,
                                                    mode, budget)
                    tokens = fut.result(timeout=600)
                    self._json(200, frontend.result_payload(tokens,
                                                            duration))
                    return
                self._stream(video_path, prompt, mode, budget)
            except FileNotFoundError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — surface to the client
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def _stream(self, video_path, prompt, mode, budget):
            deltas: "queue_mod.Queue" = queue_mod.Queue()
            ts = TokenTextStream(eng.tokenizer,
                                 on_text=lambda d: deltas.put(d))
            fut, duration = frontend.submit(video_path, prompt, mode, budget,
                                            on_token=ts.push)
            fut.add_done_callback(lambda _: deltas.put(None))
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            # headers are out: from here NOTHING may raise into do_POST —
            # its error handler would send_response() a SECOND time on the
            # same connection (corrupt wire output)
            try:
                while True:
                    d = deltas.get()
                    if d is None:
                        break
                    self.wfile.write(
                        b"data: " + json.dumps({"delta": d}).encode()
                        + b"\n\n")
                    self.wfile.flush()
                tail = ts.flush()
                if tail:
                    self.wfile.write(
                        b"data: " + json.dumps({"delta": tail}).encode()
                        + b"\n\n")
                payload = frontend.result_payload(fut.result(), duration)
                payload["done"] = True
                self.wfile.write(b"data: " + json.dumps(payload).encode()
                                 + b"\n\n")
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                return  # client went away mid-stream
            except Exception as e:  # noqa: BLE001 — surface in-band
                try:
                    self.wfile.write(
                        b"data: " + json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}).encode()
                        + b"\n\ndata: [DONE]\n\n")
                    self.wfile.flush()
                except OSError:
                    pass

    return Handler


def serve_http(frontend: ServingFrontend, host: str = "127.0.0.1",
               port: int = 8321) -> ThreadingHTTPServer:
    """Bind and return the server (caller runs serve_forever, or uses the
    returned object's shutdown() — tests drive it from a thread)."""
    return ThreadingHTTPServer((host, port), make_handler(frontend))
