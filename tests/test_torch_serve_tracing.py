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
  runs (hold inside submit; the preprocess inside submit before the lock
  wait, the engine's other spans inside the hold; queue before admission
  before decode); the pool's thread owns the scheduler's.
- The preprocess outside the lock: two uncached videos resize at once;
  8 submits of one uncached video resize once and take the same tokens as
  a serial run; a resize that raises fails every waiter with its error and
  leaves the next submit to resize anew.
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
    assert t["preprocesses"] == 2 and "preprocess_joins" not in t
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
        assert s0 <= w0 <= w1 == h0 <= h1 <= g0 <= g1 <= s1
        # the resize runs on the client's thread before the lock wait; a
        # request that ran none waits for the lock from its start
        for t0, t1, th in spans.get("engine.preprocess", ()):
            assert s0 <= t0 <= t1 <= w0 and th == client, rid
        if "engine.preprocess" not in spans:
            assert s0 == w0, rid
        for name in ("engine.encode", "engine.prefix", "engine.tokenize"):
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
    assert t["preprocesses"] == 2
    names = [s[0] for s in log.spans]
    for name in EVERY_REQUEST:
        assert names.count(name) == 2 * n, name
    assert t["stage"] == pytest.approx(
        sum(t1 - t0 for name, _, _, t0, t1 in log.spans
            if name == "frontend.stage") / 1e9, rel=1e-9)


def wait_for_joins(fe, n, timeout=60.0):
    """Block until n submits wait on another's preprocess."""
    deadline = time.monotonic() + timeout
    while fe.server.timings.get("preprocess_joins", 0) < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{n} joins not seen in {timeout} s")
        time.sleep(0.005)


def run_clients(target, n):
    """n threads running target(i) → the exceptions they raised, by i."""
    errors = {}

    def client(i):
        try:
            target(i)
        except Exception as e:  # noqa: BLE001 — returned to the test
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not any(th.is_alive() for th in threads)
    return errors


def test_uncached_videos_preprocess_at_once(micro, clips):
    """Each resize waits at a barrier that only two resizes running at the
    same time pass: under the frontend's lock the second never starts."""
    fe = frontend(micro, clips, None)
    resize, barrier = fe.engine.preprocess_video, threading.Barrier(2, timeout=30)

    def hook(path):
        barrier.wait()
        return resize(path)

    fe.engine.preprocess_video = hook
    paths = list(clips)
    try:
        errors = run_clients(lambda i: fe.submit(
            paths[i], QUESTIONS[i], "grounding", 2)[0].result(timeout=300),
            2)
    finally:
        fe.shutdown()
    assert not errors, errors
    t = fe.server.timings
    assert t["preprocesses"] == t["encodes"] == 2
    assert "preprocess_joins" not in t


def test_concurrent_misses_of_one_video_resize_once(micro, clips):
    """8 submits of one uncached video: the first resizes while the other
    7 wait for its pixels; one encode; every client's tokens are a serial
    run's."""
    n, path = 8, list(clips)[0]
    asks = [(QUESTIONS[i % 3], BUDGETS[i % 3]) for i in range(n)]
    serial = frontend(micro, clips, None)
    try:
        want = [serial.submit(path, q, "grounding", b)[0].result(timeout=300)
                for q, b in asks]
    finally:
        serial.shutdown()
    fe = frontend(micro, clips, SpanLog())
    resize, calls = fe.engine.preprocess_video, []

    def hook(p):
        calls.append(p)
        if len(calls) == 1:
            wait_for_joins(fe, n - 1)
        return resize(p)

    fe.engine.preprocess_video = hook
    got = {}

    def client(i):
        question, budget = asks[i]
        got[i] = fe.submit(path, question, "grounding",
                           budget)[0].result(timeout=300)

    try:
        errors = run_clients(client, n)
    finally:
        fe.shutdown()
    assert not errors, errors
    t = fe.server.timings
    assert t["preprocesses"] == 1 and t["encodes"] == 1
    assert t["preprocess_joins"] == n - 1
    assert t["feature_lookups"] == n and t["feature_hits"] == n - 1
    assert len(calls) == 1 and [s[0] for s in fe.server.span_log.spans
                                ].count("engine.preprocess") == 1
    assert not fe._preps
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i])


def test_failed_preprocess_reaches_every_waiter(micro, clips):
    """A resize that raises: its submit and the 3 waiting on it fail with
    that error, nothing stays in flight, and the next submit of the video
    resizes anew and is served."""
    n, path = 4, list(clips)[1]
    fe = frontend(micro, clips, None)
    resize, calls = fe.engine.preprocess_video, []
    boom = RuntimeError("the decoder failed")

    def hook(p):
        calls.append(p)
        if len(calls) == 1:
            wait_for_joins(fe, n - 1)
            raise boom
        return resize(p)

    fe.engine.preprocess_video = hook
    try:
        errors = run_clients(lambda i: fe.submit(
            path, QUESTIONS[0], "grounding", 2), n)
        assert sorted(errors) == list(range(n))
        assert all(e is boom for e in errors.values())
        t = fe.server.timings
        assert t["preprocess_joins"] == n - 1
        assert "preprocesses" not in t and "feature_lookups" not in t
        assert not fe._preps
        tokens = fe.submit(path, QUESTIONS[0], "grounding",
                           2)[0].result(timeout=300)
    finally:
        fe.shutdown()
    assert len(calls) == 2 and len(tokens) >= 1
    assert t["preprocesses"] == t["encodes"] == 1


def test_video_evicted_after_the_peek_resizes_under_the_lock(micro, clips):
    """A video the peek finds cached but the LRU drops before the lock is
    taken is resized under the lock, counted once, and takes the tokens a
    serial run gives."""
    path = list(clips)[0]
    asks = list(zip(QUESTIONS[:2], BUDGETS[:2]))
    serial = frontend(micro, clips, None)
    try:
        want = [serial.submit(path, q, "grounding", b)[0].result(timeout=300)
                for q, b in asks]
    finally:
        serial.shutdown()
    fe = frontend(micro, clips, SpanLog())
    lock = fe._lock

    class EvictingLock:
        def __enter__(self):
            fe.engine._feature_cache.clear()
            return lock.__enter__()

        def __exit__(self, *exc):
            return lock.__exit__(*exc)

    got = []
    try:
        for i, (question, budget) in enumerate(asks):
            if i == 1:
                fe._lock = EvictingLock()
            got.append(fe.submit(path, question, "grounding",
                                 budget)[0].result(timeout=300))
    finally:
        fe.shutdown()
    t = fe.server.timings
    assert t["preprocesses"] == t["encodes"] == 2
    assert t["feature_lookups"] == 2 and "feature_hits" not in t
    spans = by_request(fe.server.span_log)
    (h0, h1, _), = spans[1]["frontend.hold"]
    (p0, p1, _), = spans[1]["engine.preprocess"]
    assert h0 <= p0 <= p1 <= h1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
