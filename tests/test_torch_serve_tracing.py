"""The serving path's spans and counters on the CPU (micro_vlm_config, fp32,
greedy; no JAX): a ServingFrontend with prefix_cache=True serves 2 videos ×
3 questions from 2 client threads, once with an obs/profiler.SpanLog
attached to the pool and once without.

- Counters in the pool's ``timings``: submits, the feature and prefix LRUs'
  lookups and hits, encodes and prefix builds, admissions; lock_wait,
  lock_hold, stage and queue_wait non-negative and, with the log, equal to
  the sums of their spans; slot_tokens within pool_size × timed_steps and
  equal to the tokens the chunks gave the requests.
- Spans: one id a request from submit to retirement, nested as the code
  runs (hold inside submit, the engine's spans inside the hold, queue
  before admission before decode); the pool's thread owns the scheduler's.
- Without a log nothing is recorded, and the tokens equal the logged run's.
- SpanLog and record on their own.
"""

import sys
import threading
import time

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu_torch.cli.dryrun_multichip import micro_params
from grounded_video_llm_tpu_torch.core.config import (GenerateConfig,
                                                      micro_vlm_config)
from grounded_video_llm_tpu_torch.obs.profiler import SpanLog, record
from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine
from grounded_video_llm_tpu_torch.serve.server import ServingFrontend
from grounded_video_llm_tpu_torch.text.tokenizer import build_test_tokenizer

POOL, MAX_NEW = 2, 6
BUDGETS = (2, 6, 4)
QUESTIONS = ("when does the man open the door?", "when is the light on?",
             "when does the person sit down?")
FRONTEND = ("frontend.submit", "frontend.lock_wait", "frontend.hold",
            "frontend.stage")
EVERY_REQUEST = FRONTEND + ("engine.tokenize", "scheduler.queue",
                            "scheduler.admit", "scheduler.decode")


@pytest.fixture(scope="module")
def micro():
    cfg = micro_vlm_config("phi3.5")
    return cfg, micro_params(cfg, 0)


@pytest.fixture(scope="module")
def clips(micro, tmp_path_factory):
    """Two placeholder files (the feature LRU's keys) and their frames."""
    cfg, _ = micro
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(5)
    out = {}
    for v in range(2):
        path = d / f"v{v}.mp4"
        path.write_bytes(b"placeholder %d" % v)
        out[str(path)] = rng.integers(
            0, 256, size=(cfg.num_frames, 36, 48, 3), dtype=np.uint8)
    return out


def frontend(micro, clips, log):
    cfg, params = micro
    eng = InferenceEngine(
        params, cfg, build_test_tokenizer("phi3.5"),
        GenerateConfig(max_new_tokens=MAX_NEW, do_sample=False,
                       temperature=0.0),
        feature_cache_size=4, prefix_kv_cache_size=2)
    eng.preprocess_video = lambda path: (*eng.preprocess_frames(clips[path]),
                                         10.0)
    fe = ServingFrontend(eng, pool_size=POOL, prompt_len=32,
                         max_new_tokens=MAX_NEW, chunk=2, prefix_cache=True)
    fe.server.span_log = log
    return fe


def serve_round(micro, clips, log):
    """Each of 2 client threads asks 3 questions about its own video, one
    after another → (pool timings, {(video, question): tokens}, the
    frontend's pool)."""
    fe = frontend(micro, clips, log)
    tokens, errors = {}, []

    def client(v, path):
        try:
            for q, (question, budget) in enumerate(zip(QUESTIONS, BUDGETS)):
                fut, _ = fe.submit(path, question, "grounding", budget)
                tokens[(v, q)] = fut.result(timeout=300)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(v, p))
               for v, p in enumerate(clips)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
    finally:
        fe.shutdown()
    assert not errors, errors
    return dict(fe.server.timings), tokens, fe.server


@pytest.fixture(scope="module")
def rounds(micro, clips):
    log = SpanLog()
    return {"logged": (*serve_round(micro, clips, log), log),
            "unlogged": (*serve_round(micro, clips, None), None)}


def by_request(log):
    out = {}
    for name, rid, thread, t0, t1 in log.spans:
        if rid is not None:
            out.setdefault(rid, {}).setdefault(name, []).append(
                (t0, t1, thread))
    return out


@pytest.mark.parametrize("run", ["logged", "unlogged"])
def test_cache_and_request_counters(rounds, run):
    t = rounds[run][0]
    assert t["submits"] == 6 and t["admissions"] == 6
    assert t["feature_lookups"] == 6 and t["feature_hits"] == 4
    assert t["prefix_lookups"] == 6 and t["prefix_hits"] == 4
    assert t["encodes"] == 2 and t["prefixes"] == 2
    for key in ("lock_wait", "lock_hold", "stage", "queue_wait",
                "preprocess", "encode", "prefix", "tokenize", "admit",
                "chunk"):
        assert t[key] >= 0.0, key


@pytest.mark.parametrize("run", ["logged", "unlogged"])
def test_slot_tokens_are_the_chunks_tokens(rounds, run):
    """Each request's first token comes from its admission, the rest from
    chunks; a request that stopped short of its budget ended on an EOS,
    which its chunk gave too."""
    t, tokens = rounds[run][0], rounds[run][1]
    assert t["slot_tokens"] <= POOL * t["timed_steps"]
    want = sum(len(tokens[(v, q)]) - 1 + (len(tokens[(v, q)]) < BUDGETS[q])
               for v in range(2) for q in range(3))
    assert t["slot_tokens"] == want


@pytest.mark.parametrize("key,span", [
    ("lock_wait", "frontend.lock_wait"), ("lock_hold", "frontend.hold"),
    ("stage", "frontend.stage"), ("queue_wait", "scheduler.queue"),
    ("preprocess", "engine.preprocess"), ("encode", "engine.encode"),
    ("prefix", "engine.prefix"), ("tokenize", "engine.tokenize"),
    ("admit", "scheduler.admit"), ("chunk", "scheduler.chunk")])
def test_counters_are_their_spans_summed(rounds, key, span):
    t, _, _, log = rounds["logged"]
    spans = [(t0, t1) for name, _, _, t0, t1 in log.spans if name == span]
    assert spans and all(t1 >= t0 for t0, t1 in spans)
    assert t[key] == pytest.approx(sum(t1 - t0 for t0, t1 in spans) / 1e9,
                                   rel=1e-9, abs=1e-12)


def test_spans_share_one_id_and_nest(rounds):
    _, _, server, log = rounds["logged"]
    reqs = by_request(log)
    assert sorted(reqs) == list(range(6))
    scheduler_threads = set()
    for rid, spans in reqs.items():
        assert set(EVERY_REQUEST) <= set(spans), (rid, sorted(spans))
        for name in EVERY_REQUEST:
            assert len(spans[name]) == 1, (rid, name)
        (s0, s1, client), = spans["frontend.submit"]
        (w0, w1, _), = spans["frontend.lock_wait"]
        (h0, h1, _), = spans["frontend.hold"]
        (g0, g1, _), = spans["frontend.stage"]
        assert s0 == w0 <= w1 == h0 <= h1 <= g0 <= g1 <= s1
        for name in ("engine.preprocess", "engine.encode", "engine.prefix",
                     "engine.tokenize"):
            for t0, t1, th in spans.get(name, ()):
                assert h0 <= t0 <= t1 <= h1 and th == client, (rid, name)
        (q0, q1, _), = spans["scheduler.queue"]
        (a0, a1, sched), = spans["scheduler.admit"]
        (d0, d1, _), = spans["scheduler.decode"]
        # the decode starts at the first token, which ends the admission
        # but for its host bookkeeping
        assert g0 <= q0 <= g1 and q0 <= q1 == a0 <= d0 <= a1 and d0 <= d1
        assert all(th == client for n in FRONTEND for _, _, th in spans[n])
        assert sched != client
        scheduler_threads.add(sched)
    # the first request of each video built its features and prefix
    assert sum("engine.encode" in s for s in reqs.values()) == 2
    assert sum("engine.prefix" in s for s in reqs.values()) == 2
    assert sum("engine.preprocess" in s for s in reqs.values()) == 2
    assert len(scheduler_threads) == 1
    loose = {name for name, rid, *_ in log.spans if rid is None}
    assert loose == {"scheduler.chunk", "scheduler.wait"}
    assert {th for name, _, th, _, _ in log.spans
            if name in ("scheduler.chunk", "scheduler.wait")} \
        == scheduler_threads


def test_no_log_records_nothing_and_serves_the_same_tokens(rounds):
    _, want, _, log = rounds["logged"]
    t, got, server, none = rounds["unlogged"]
    assert none is None and server.span_log is None
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the counters are the logged run's, whatever the timing
    counts = ("submits", "admissions", "feature_lookups", "feature_hits",
              "prefix_lookups", "prefix_hits", "encodes", "prefixes",
              "slot_tokens")
    assert {k: t[k] for k in counts} == \
        {k: rounds["logged"][0][k] for k in counts}


@pytest.mark.parametrize("case", ["counter", "count", "span", "none"])
def test_record(case):
    log = SpanLog()
    t = {"x": 0.5}
    t0 = time.perf_counter_ns()
    kw = {"counter": dict(key="x"), "count": dict(key="x", count="n"),
          "span": dict(key=None, log=log, name="s", request_id=3),
          "none": dict(key="x")}[case]
    t1 = record(None if case == "none" else t, t0=t0, t1=t0 + 2_000_000,
                **kw)
    assert t1 == t0 + 2_000_000
    want = {"counter": {"x": 0.502}, "count": {"x": 0.502, "n": 1},
            "span": {"x": 0.5}, "none": {"x": 0.5}}[case]
    assert t == pytest.approx(want)
    assert list(log.spans) == ([("s", 3, threading.current_thread().name,
                                 t0, t0 + 2_000_000)]
                               if case == "span" else [])


def test_span_log_keeps_the_newest():
    log = SpanLog(limit=3)
    for i in range(5):
        log.add(f"s{i}", i, i, i + 1)
    assert [s[0] for s in log.spans] == ["s2", "s3", "s4"]


def test_record_returns_now_when_open():
    t, t0 = {}, time.perf_counter_ns()
    t1 = record(t, "x", t0)
    assert t0 <= t1 <= time.perf_counter_ns()
    assert t["x"] == pytest.approx((t1 - t0) / 1e9)


def test_counters_lose_no_update_under_many_clients(micro, clips):
    """16 client threads, 2 one-token requests each, thread switches every
    10 µs: every request is counted once, and logged once a span."""
    log, n, errors = SpanLog(), 16, []
    fe = frontend(micro, clips, log)
    paths = list(clips)

    def client(c):
        try:
            for q in range(2):
                fe.submit(paths[c % 2], QUESTIONS[q], "grounding",
                          1)[0].result(timeout=300)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
        fe.shutdown()
    assert not errors and not any(th.is_alive() for th in threads)
    t = fe.server.timings
    assert t["submits"] == t["admissions"] == 2 * n
    assert t["feature_lookups"] == t["prefix_lookups"] == 2 * n
    assert t["feature_hits"] == t["prefix_hits"] == 2 * n - 2
    names = [s[0] for s in log.spans]
    for name in EVERY_REQUEST:
        assert names.count(name) == 2 * n, name
    assert t["stage"] == pytest.approx(
        sum(t1 - t0 for name, _, _, t0, t1 in log.spans
            if name == "frontend.stage") / 1e9, rel=1e-9)
