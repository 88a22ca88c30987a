"""The feature-cache and batched serving routes of the port against the JAX
package on the CPU: generate_tokens_from_features and its speculative form
against the pixels-in programs, and the engine's encode_video_cached LRU,
run_stream_cached (dedup, input order, eviction, its speculative route),
generate_prepped, run_batch and run_stream, on cv2-written mp4s.

Greedy tokens (and the texts they decode to) must equal JAX's and the
port's own pixels-in or per-request route exactly, on the seeds of
tests/test_feature_cache.py; the encodes are counted by wrapping
encode_features, as the JAX tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu.core.config import GenerateConfig as JGen
from grounded_video_llm_tpu.core.config import micro_vlm_config
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.serve import engine as jengine
from grounded_video_llm_tpu.serve import generate as jgen
from grounded_video_llm_tpu.serve import speculative as jspec
from grounded_video_llm_tpu.text.templates import IMAGE_TOKEN_INDEX
from grounded_video_llm_tpu.text.tokenizer import build_test_tokenizer
from grounded_video_llm_tpu_torch.core.config import GenerateConfig as TGen
from grounded_video_llm_tpu_torch.models import vlm as tvlm
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.serve import generate as tgen
from grounded_video_llm_tpu_torch.serve import speculative as tspec
from grounded_video_llm_tpu_torch.serve.engine import (
    InferenceEngine as TEngine)

GREEDY = dict(max_new_tokens=4, do_sample=False, temperature=0.0)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def micro():
    cfg = micro_vlm_config("phi3.5")
    jp = jvlm.init_params(jax.random.key(0), cfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, tp, build_test_tokenizer("phi3.5")


@pytest.fixture(scope="module")
def two_videos(tmp_path_factory):
    """tests/test_feature_cache.py's two videos (distinct durations)."""
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("vids")
    paths = []
    for v, n_frames in enumerate((20, 30)):
        p = str(d / f"v{v}.mp4")
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 64))
        for i in range(n_frames):
            f = np.zeros((64, 64, 3), np.uint8)
            f[:] = (10 + 60 * v, 20 + 5 * (i % 8), 200 - 60 * v)
            x = (5 * i) % 40
            f[10:30, x:x + 12] = 255
            w.write(f)
        w.release()
        paths.append(p)
    return paths


def _pixel_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    B, S = 2, 10
    ids = rng.integers(3, 50, size=(B, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    mask = np.ones((B, S), np.int32)
    spatial = rng.normal(size=(B, cfg.num_segs, 336, 336, 3)).astype(
        np.float32)
    temporal = rng.normal(size=(B, cfg.num_frames, 224, 224, 3)).astype(
        np.float32)
    return ids, mask, spatial, temporal


def test_from_features_matches_fused_generate(micro):
    """generate_tokens_from_features on encode_video's features gives the
    pixels-in generate_tokens' greedy tokens, and JAX's."""
    cfg, jp, tp, tok = micro
    ids, mask, spatial, temporal = _pixel_inputs(cfg, 0)
    kw = dict(max_new_tokens=5, temperature=0.0, do_sample=False,
              eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
    jf = jvlm.encode_video_jit(jp, cfg, jnp.asarray(spatial),
                               jnp.asarray(temporal))
    want, want_len = jgen.generate_tokens_from_features(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), jf, jax.random.key(7),
        **kw)
    targs = (tp, cfg, _t(ids).long(), _t(mask).long())
    fused = tgen.generate_tokens(*targs, _t(spatial), _t(temporal), None,
                                 **kw)
    with torch.inference_mode():
        feats = tvlm.encode_video(tp, cfg, _t(spatial), _t(temporal))
    timings = {}
    got = tgen.generate_tokens_from_features(*targs, feats, None,
                                             timings=timings, **kw)
    assert set(timings) == {"prefill", "decode", "decode_steps"}
    for tokens, lengths in (fused, got):
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_len))


def test_spec_from_features_matches_fused(micro):
    cfg, jp, tp, tok = micro
    ids, mask, spatial, temporal = _pixel_inputs(cfg, 1)
    kw = dict(max_new_tokens=6, draft_len=3, do_sample=False,
              eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
    jf = jvlm.encode_video_jit(jp, cfg, jnp.asarray(spatial),
                               jnp.asarray(temporal))
    want, want_len = jspec.generate_tokens_spec_from_features(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), jf, jax.random.key(3),
        **kw)
    targs = (tp, cfg, _t(ids).long(), _t(mask).long())
    fused = tspec.generate_tokens_spec(*targs, _t(spatial), _t(temporal),
                                       None, **kw)
    with torch.inference_mode():
        feats = tvlm.encode_video(tp, cfg, _t(spatial), _t(temporal))
    got = tspec.generate_tokens_spec_from_features(*targs, feats, None, **kw)
    for tokens, lengths in (fused, got):
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_len))


def _counting_engine(micro, cache_size, **gen_kw):
    cfg, _, tp, tok = micro
    eng = TEngine(tp, cfg, tok, gen_cfg=TGen(**GREEDY, **gen_kw),
                  feature_cache_size=cache_size)
    calls = []
    orig = eng.encode_features
    eng.encode_features = lambda t, s: (calls.append(1), orig(t, s))[1]
    return eng, calls


def _jax_engine(micro, **gen_kw):
    cfg, jp, _, tok = micro
    return jengine.InferenceEngine(jp, cfg, tok,
                                   gen_cfg=JGen(**GREEDY, **gen_kw),
                                   feature_cache_size=4)


def test_run_stream_cached_dedups_and_preserves_order(micro, two_videos):
    """Each unique video is encoded once; results return in input order;
    the texts equal those with the cache off (every query encoding), the
    JAX engine's, and row by row the tokens of the same queries through
    generate_from_features."""
    v0, v1 = two_videos
    paths = [v0, v1, v0, v1, v0]
    prompts = [f"what happens in query {i}?" for i in range(len(paths))]
    base_eng, base_calls = _counting_engine(micro, 0)
    base = base_eng.run_stream_cached(paths, prompts, mode="qa",
                                      batch_size=2)
    assert len(base_calls) == 5
    eng, calls = _counting_engine(micro, 4)
    out = eng.run_stream_cached(paths, prompts, mode="qa", batch_size=2)
    assert len(calls) == 2
    t = eng.last_timings
    assert t["encodes"] == 2 and t["decode_steps"] >= 3
    assert set(t) >= {"encode", "prefill", "decode", "preprocess",
                      "prompt_len", "new_tokens"}
    want = _jax_engine(micro).run_stream_cached(paths, prompts, mode="qa",
                                                batch_size=2)
    assert [r.text for r in out] == [r.text for r in base]
    assert [r.text for r in out] == [r.text for r in want]
    durs = [r.duration for r in out]
    assert durs[0] == durs[2] == durs[4] and durs[1] == durs[3]
    assert durs[0] != durs[1]
    assert durs == [r.duration for r in want]
    # the tokens, in input order, against the same queries batched by hand
    tokens, lengths = eng.last_tokens
    assert tuple(tokens.shape) == (5, 4)
    f0, d0 = eng.encode_video_cached(v0)
    assert len(calls) == 2                               # a cache hit
    texts = eng.generate_from_features(
        [eng.build_prompt(prompts[i], "qa", d0) for i in (0, 2)], f0)
    assert texts == [out[0].text, out[2].text]
    assert torch.equal(eng.last_tokens[0], tokens[[0, 2]])


def test_feature_cache_lru_eviction(micro, two_videos):
    v0, v1 = two_videos
    paths, prompts = [v0, v1, v0], ["a", "b", "c"]
    # unsorted at batch 1 keeps the alternation: with one entry v1 evicts
    # v0, so the third query encodes again; with two it does not
    for size, encodes in ((1, 3), (2, 2)):
        eng, calls = _counting_engine(micro, size)
        eng.run_stream_cached(paths, prompts, mode="qa", batch_size=1,
                              sort_by_video=False, pad_last=False)
        assert len(calls) == encodes
        assert len(eng._feature_cache) == size


def test_feature_cache_key_follows_the_file(micro, two_videos, tmp_path):
    """The key holds mtime and size: an overwritten file encodes anew."""
    import shutil

    eng, calls = _counting_engine(micro, 4)
    path = str(tmp_path / "clip.mp4")
    shutil.copy(two_videos[0], path)
    f0, d0 = eng.encode_video_cached(path)
    eng.encode_video_cached(path)
    assert len(calls) == 1
    shutil.copy(two_videos[1], path)
    f1, d1 = eng.encode_video_cached(path)
    assert len(calls) == 2 and d1 != d0


def test_run_stream_cached_spec_route(micro, two_videos):
    """spec_draft_len routes the batches through the speculative
    from-features program: encodes still deduplicated, texts equal to the
    JAX engine's."""
    v0, v1 = two_videos
    eng, calls = _counting_engine(micro, 4, spec_draft_len=2)
    out = eng.run_stream_cached([v0, v0, v1], ["a", "b", "c"], mode="qa",
                                batch_size=2)
    assert len(calls) == 2 and eng.last_timings["verify_passes"] >= 2
    want = _jax_engine(micro, spec_draft_len=2).run_stream_cached(
        [v0, v0, v1], ["a", "b", "c"], mode="qa", batch_size=2)
    assert [r.text for r in out] == [r.text for r in want]


def test_run_batch_and_run_stream_match_per_request_run(micro, two_videos):
    """run_batch (one batch) and run_stream (batches of 2, the last padded)
    give each request the text of its own run(), and the JAX engine's
    run_batch texts; generate_prepped drops its pad rows."""
    cfg, _, tp, tok = micro
    v0, v1 = two_videos
    paths = [v0, v1, v0]
    prompts = ["What happens?", "When does it move?", "Where is it?"]
    eng = TEngine(tp, cfg, tok, gen_cfg=TGen(**GREEDY))
    single = [eng.run(p, q, mode="qa").text for p, q in zip(paths, prompts)]
    batch = eng.run_batch(paths, prompts, mode="qa")
    assert [r.text for r in batch] == single
    assert eng.last_timings["preprocess"] > 0
    stream = eng.run_stream(paths, prompts, mode="qa", batch_size=2)
    assert [r.text for r in stream] == single
    assert tuple(eng.last_tokens[0].shape) == (3, 4)
    assert eng.last_timings["decode_steps"] >= 2
    want = _jax_engine(micro).run_batch(paths, prompts, mode="qa")
    assert [r.text for r in want] == single
    prep = [eng.preprocess_video(v0)]
    out = eng.generate_prepped(prep, ["Q?"], mode="qa", pad_to=2)
    assert len(out) == 1 and tuple(eng.last_tokens[0].shape) == (1, 4)
