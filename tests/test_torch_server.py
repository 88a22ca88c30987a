"""The port's serving front ends against the JAX package on the CPU
(micro_vlm_config, fp32, greedy): the threaded ContinuousScheduler, the
incremental detokenizer (text/streaming.TokenTextStream), the
dynamic-batching Scheduler, the engine's continuous requests
(make_continuous_request, prefix_kv_cached), the HTTP server
(serve/server.py: ServingFrontend, serve_http) and cli/server.py.

Tolerances: tokens and HTTP payloads exactly equal (to JAX's
ServingFrontend over the same weights and a cv2-written mp4, to the port's
own ContinuousServer.serve, engine.run or plain-pool frontend); HTTP status
codes equal to JAX's; streamed text deltas assemble the whole decode.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu.core.config import GenerateConfig as JGen
from grounded_video_llm_tpu.core.config import micro_vlm_config
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.serve import engine as jengine
from grounded_video_llm_tpu.serve import server as jserver
from grounded_video_llm_tpu.text import streaming as jstreaming
from grounded_video_llm_tpu.text.templates import IMAGE_TOKEN_INDEX
from grounded_video_llm_tpu.text.tokenizer import \
    build_test_tokenizer as jtokenizer
from grounded_video_llm_tpu.text.tokenizer import \
    load_tokenizer as jload_tokenizer
from grounded_video_llm_tpu_torch.core.config import GenerateConfig as TGen
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.serve import continuous as tcont
from grounded_video_llm_tpu_torch.serve import engine as tengine
from grounded_video_llm_tpu_torch.serve import server as tserver
from grounded_video_llm_tpu_torch.serve.scheduler import Scheduler
from grounded_video_llm_tpu_torch.text.streaming import TokenTextStream
from grounded_video_llm_tpu_torch.text.tokenizer import \
    build_test_tokenizer as ttokenizer
from grounded_video_llm_tpu_torch.text.tokenizer import load_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS, PAD = 2, 0
MAX_NEW = 6
GREEDY = dict(temperature=0.0, do_sample=False, eos_token_id=EOS,
              pad_token_id=PAD)


@pytest.fixture(scope="module")
def micro():
    cfg = micro_vlm_config("phi3.5")
    jp = jvlm.init_params(jax.random.key(0), cfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, tp


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """tests/test_server.py's clip and a second, longer one."""
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("vids")
    paths = []
    for v, n in enumerate((24, 30)):
        p = str(d / f"v{v}.mp4")
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 64))
        for i in range(n):
            f = np.zeros((64, 64, 3), np.uint8)
            f[:] = (30 + 60 * v, 20 + 5 * (i % 8), 180)
            w.write(f)
        w.release()
        paths.append(p)
    return paths


def _engines(micro, **kw):
    cfg, jp, tp = micro
    j = jengine.InferenceEngine(
        jp, cfg, jtokenizer("phi3.5"),
        JGen(max_new_tokens=MAX_NEW, do_sample=False, temperature=0.0),
        feature_cache_size=4, **kw)
    t = tengine.InferenceEngine(
        tp, cfg, ttokenizer("phi3.5"),
        TGen(max_new_tokens=MAX_NEW, do_sample=False, temperature=0.0),
        feature_cache_size=4, **kw)
    return j, t


# ---------------------------------------------------------------------------
# The threaded scheduler
# ---------------------------------------------------------------------------


def _pixel_requests(cfg, n):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        ids = rng.integers(3, 50, size=(10,)).astype(np.int32)
        ids[2] = IMAGE_TOKEN_INDEX
        out.append(tcont.Request(
            ids, np.ones((10,), np.int32),
            rng.normal(size=(cfg.num_segs, 336, 336, 3)).astype(
                np.float32) * 0.1,
            rng.normal(size=(cfg.num_frames, 224, 224, 3)).astype(
                np.float32) * 0.1))
    return out


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["plain", "pipelined"])
def test_scheduler_matches_serve(micro, pipeline):
    """Futures submitted together through ContinuousScheduler resolve to
    serve()'s tokens for the same requests and pool shape."""
    cfg, _, tp = micro
    reqs = _pixel_requests(cfg, 3)
    kw = dict(pool_size=2, prompt_len=10, max_new_tokens=5, chunk=2,
              pipeline_chunks=pipeline, **GREEDY)
    want = tcont.ContinuousServer(tp, cfg, **kw).serve(reqs)
    sched = tcont.ContinuousScheduler(tcont.ContinuousServer(tp, cfg, **kw))
    try:
        outs = [f.result(timeout=300) for f in
                [sched.submit(r) for r in reqs]]
    finally:
        sched.shutdown()
    assert not sched._thread.is_alive()
    for got, w in zip(outs, want):
        np.testing.assert_array_equal(got, w)


def test_scheduler_recovers_after_admission_error(micro):
    """An admission that fails (a prefix past the pool's envelope) fails its
    future with the error, resets the pool, and a later request completes
    with serve()'s tokens."""
    from grounded_video_llm_tpu_torch.serve.generate import build_prefix_kv

    cfg, _, tp = micro
    reqs = _pixel_requests(cfg, 2)
    kw = dict(pool_size=1, prompt_len=10, max_new_tokens=4, chunk=2,
              **GREEDY)
    server = tcont.ContinuousServer(tp, cfg, **kw)
    long_pre = torch.from_numpy(np.random.default_rng(0).integers(
        3, 50, size=(1, 160)))
    feats = torch.zeros(1, cfg.num_video_tokens, cfg.llm.hidden_size)
    prefix = build_prefix_kv(tp, cfg, long_pre, torch.ones_like(long_pre),
                             feats, server.max_len)
    bad = reqs[0]._replace(input_ids=reqs[0].input_ids[3:],
                           attn_mask=reqs[0].attn_mask[3:],
                           spatial_pixels=None, temporal_pixels=None,
                           prefix=prefix)
    sched = tcont.ContinuousScheduler(server)
    try:
        with pytest.raises(ValueError, match="overflow"):
            sched.submit(bad).result(timeout=120)
        assert not server._busy()
        got = sched.submit(reqs[1]).result(timeout=300)
    finally:
        sched.shutdown()
    want = tcont.ContinuousServer(tp, cfg, **kw).serve([reqs[1]])[0]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Incremental detokenization
# ---------------------------------------------------------------------------


TEXTS = ("hello world, 12.5 seconds", "温度 is 25°C — ok ✓",
         "emoji 🎥🎬 end")


@pytest.mark.parametrize("text", TEXTS, ids=["ascii", "cjk", "emoji"])
def test_token_text_stream_matches_whole_decode(text):
    """Deltas concatenated == whole-sequence decode, no replacement char in
    a delta, and the same deltas as the JAX package's stream."""
    tok = load_tokenizer("phi3.5", None, 300)
    ids = tok.encode(text)
    stream = TokenTextStream(tok)
    deltas = [stream.push(t) for t in ids]
    final = "".join(deltas) + stream.flush()
    assert final == tok.decode(ids, skip_special_tokens=True)
    assert all("�" not in d for d in deltas)
    jtok = jload_tokenizer("phi3.5", None, 300)
    assert jtok.encode(text) == ids
    jstream = jstreaming.TokenTextStream(jtok)
    assert [jstream.push(t) for t in ids] == deltas


def test_token_text_stream_callback():
    tok = load_tokenizer("phi3.5", None, 300)
    got = []
    stream = TokenTextStream(tok, on_text=got.append)
    ids = tok.encode("streaming ok")
    assert stream.push_many(ids[:3]) == "".join(got)
    for t in ids[3:]:
        stream.push(t)
    stream.flush()
    assert "".join(got) == tok.decode(ids, skip_special_tokens=True)
    assert stream.text == "".join(got)


# ---------------------------------------------------------------------------
# The engine's continuous requests and the dynamic-batching scheduler
# ---------------------------------------------------------------------------


def test_make_continuous_request(micro, videos):
    """Feature-backed requests through the feature cache (one encode for a
    repeated video), a fixed bucket holding one image token, equal to the
    JAX engine's request, servable; a bucket that cuts the image slot is
    refused; prefix-backed requests share one LRU entry per video."""
    cfg, _, tp = micro
    jeng, teng = _engines(micro)
    calls = []
    orig = teng.encode_features
    teng.encode_features = lambda *a: calls.append(1) or orig(*a)
    r1, d1 = teng.make_continuous_request(videos[0], "what happens?",
                                          prompt_len=256)
    r2, d2 = teng.make_continuous_request(videos[0], "when exactly?",
                                          prompt_len=256)
    jr1, jd1 = jeng.make_continuous_request(videos[0], "what happens?",
                                            prompt_len=256)
    assert len(calls) == 1 and d1 == d2 == jd1
    assert r1.input_ids.shape == (256,) and r1.attn_mask.shape == (256,)
    np.testing.assert_array_equal(r1.input_ids, jr1.input_ids)
    np.testing.assert_array_equal(r1.attn_mask, jr1.attn_mask)
    assert int(np.sum(r1.input_ids == IMAGE_TOKEN_INDEX)) == 1
    assert r1.features is not None and r1.spatial_pixels is None
    np.testing.assert_allclose(r1.features.numpy(), jr1.features, rtol=2e-4,
                               atol=1e-5)
    out = tcont.ContinuousServer(tp, cfg, pool_size=2, prompt_len=256,
                                 max_new_tokens=4, chunk=2,
                                 **GREEDY).serve([r1, r2])
    assert len(out) == 2 and all(o.dtype == np.int32 for o in out)
    with pytest.raises(ValueError, match="image"):
        teng.make_continuous_request(videos[0], "what happens?",
                                     prompt_len=8)
    p1, _ = teng.make_continuous_request(videos[0], "what happens?",
                                         prompt_len=64, prefix_rope_hint=640)
    p2, _ = teng.make_continuous_request(videos[0], "when exactly?",
                                         prompt_len=64, prefix_rope_hint=640)
    jp1, _ = jeng.make_continuous_request(videos[0], "what happens?",
                                          prompt_len=64,
                                          prefix_rope_hint=640)
    assert p1.prefix is p2.prefix and len(teng._prefix_cache) == 1
    np.testing.assert_array_equal(p1.input_ids, jp1.input_ids)
    np.testing.assert_allclose(p1.prefix[0].float().numpy(),
                               np.asarray(jp1.prefix[0], np.float32),
                               rtol=2 ** -7, atol=1e-5)
    np.testing.assert_array_equal(p1.prefix[2].numpy(),
                                  np.asarray(jp1.prefix[2]))
    teng.prefix_kv_cache_size = 1
    teng.make_continuous_request(videos[1], "what happens?", prompt_len=64,
                                 prefix_rope_hint=640)
    assert len(teng._prefix_cache) == 1      # the LRU evicted video 0's


def test_dynamic_scheduler_matches_engine_run(micro, videos):
    """The dynamic-batching Scheduler (bucket 4 padded by repeating the last
    request) resolves each future to engine.run's result."""
    cfg, _, tp = micro
    _, eng = _engines(micro)
    sched = Scheduler(eng, max_batch=4, batch_window_s=0.5)
    asks = [(videos[0], "what happens?"), (videos[1], "what is shown?"),
            (videos[0], "where is it?")]
    try:
        futs = [sched.submit(v, p, mode="qa") for v, p in asks]
        got = [f.result(timeout=300) for f in futs]
    finally:
        sched.shutdown()
    for (v, p), r in zip(asks, got):
        assert r == eng.run(v, p, mode="qa")


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


class _Http:
    """A ServingFrontend behind serve_http on 127.0.0.1:0, on a thread."""

    def __init__(self, module, engine, **kw):
        self.frontend = module.ServingFrontend(engine, **kw)
        self.httpd = module.serve_http(self.frontend, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.frontend.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=300) as r:
        return r.status, json.loads(r.read())


def _post(url, body, raw=None):
    req = urllib.request.Request(
        url, data=raw if raw is not None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def _status(fn, *args):
    try:
        return fn(*args)[0]
    except urllib.error.HTTPError as e:
        return e.code


def _stream(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    deltas, final = [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "text/event-stream"
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                break
            obj = json.loads(payload)
            if obj.get("done"):
                final = obj
            else:
                deltas.append(obj["delta"])
    return deltas, final


@pytest.fixture(scope="module")
def servers(micro):
    """The JAX package's and the port's ServingFrontend over the same
    weights, tests/test_server.py's shape (pool 2, bucket 32, 6 tokens,
    chunk 2)."""
    jeng, teng = _engines(micro)
    kw = dict(pool_size=2, prompt_len=32, max_new_tokens=MAX_NEW, chunk=2)
    j, t = _Http(jserver, jeng, **kw), _Http(tserver, teng, **kw)
    yield j, t
    j.close()
    t.close()


def test_http_health_and_models(servers):
    j, t = servers
    for path in ("/healthz", "/v1/models"):
        assert _get(t.base + path) == _get(j.base + path)
    code, h = _get(t.base + "/healthz")
    assert code == 200 and h == {"status": "ok", "model": "phi3.5",
                                 "pool_size": 2}


@pytest.mark.parametrize("mode", ["grounding", "qa", "referring"])
def test_http_generate_matches_jax(servers, videos, mode):
    """The non-streamed payload equal to the JAX server's; a repeat (a
    feature-cache hit) equal to the first; the streamed deltas assemble
    the same text."""
    j, t = servers
    body = {"video_path": videos[0], "prompt": "what happens?", "mode": mode}
    code, got = _post(t.base + "/v1/generate", body)
    assert code == 200
    assert got == _post(j.base + "/v1/generate", body)[1]
    assert set(got) == {"text", "parsed", "intervals", "duration",
                        "num_tokens"}
    assert got["num_tokens"] > 0 and got["duration"] > 0
    assert _post(t.base + "/v1/generate", body)[1] == got
    deltas, final = _stream(t.base + "/v1/generate", body)
    assert final is not None and final["done"]
    assert "".join(deltas).strip() == final["text"] == got["text"]


def test_http_tokens_match_jax(servers, videos):
    """The frontends' token arrays (submit → future) equal, with ragged
    budgets, submitted together."""
    j, t = servers
    asks = [(videos[i % 2], f"query {i}?", ("qa", "grounding")[i % 2],
             (3, None, 5)[i]) for i in range(3)]
    got = [t.frontend.submit(*a)[0] for a in asks]
    want = [j.frontend.submit(*a)[0] for a in asks]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.result(timeout=300),
                                      w.result(timeout=300))


BAD = {
    "missing_video_path": ("POST", "/v1/generate", {"prompt": "no video"}),
    "bad_json": ("POST", "/v1/generate", b"{not json"),
    "missing_file": ("POST", "/v1/generate",
                     {"video_path": "/nonexistent.mp4", "prompt": "x"}),
    "unknown_mode": ("POST", "/v1/generate", "mode"),
    "post_unknown_path": ("POST", "/nope", {}),
    "get_unknown_path": ("GET", "/nope", None),
}


@pytest.mark.parametrize("case", list(BAD))
def test_http_bad_requests_match_jax(servers, videos, case):
    j, t = servers
    method, path, body = BAD[case]
    if body == "mode":
        body = {"video_path": videos[0], "prompt": "x", "mode": "bogus"}

    def status(base):
        if method == "GET":
            return _status(_get, base + path)
        if isinstance(body, bytes):
            return _status(_post, base + path, None, body)
        return _status(_post, base + path, body)

    code = status(t.base)
    assert code == status(j.base)
    assert code in (400, 404, 500)


def test_http_prefix_cache_matches_plain(micro, videos):
    """prefix_cache=True (prefix-KV admission) and the shared-prefix pool
    give the plain frontend's text (a bucket holding the whole prompt), and
    the repeat reuses the cached prefix."""
    _, teng = _engines(micro)
    body = {"video_path": videos[0], "prompt": "what happens?", "mode": "qa"}
    texts = {}
    for name, prefix, shared in (("plain", False, False),
                                 ("prefix", True, False),
                                 ("shared", True, True)):
        h = _Http(tserver, teng, pool_size=2, prompt_len=256,
                  max_new_tokens=MAX_NEW, chunk=2, prefix_cache=prefix,
                  shared_prefix_pool=shared)
        try:
            texts[name] = _post(h.base + "/v1/generate", body)[1]["text"]
            assert _post(h.base + "/v1/generate", body)[1]["text"] \
                == texts[name]
        finally:
            h.close()
    assert len(teng._prefix_cache) == 1
    assert texts["prefix"] == texts["plain"] == texts["shared"]
    with pytest.raises(ValueError, match="prefix_cache"):
        tserver.ServingFrontend(teng, shared_prefix_pool=True)


def test_cli_server_starts_on_the_cpu():
    """cli/server.py --debug_tiny --device cpu binds an ephemeral port,
    prints it, and answers /healthz."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "grounded_video_llm_tpu_torch.cli.server",
         "--debug_tiny", "--device", "cpu", "--port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving phi3.5 on http://127.0.0.1:"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(line.split("127.0.0.1:")[1].split()[0])
        code, h = _get(f"http://127.0.0.1:{port}/healthz")
        assert code == 200 and h["status"] == "ok"
        assert h["model"] == "phi3.5" and h["pool_size"] == 4
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    assert proc.returncode is not None
