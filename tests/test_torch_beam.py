"""Beam search (serve/beam.py) against the JAX package on the CPU
(micro_vlm_config, fp32; the int8 case on the widened micro LLM of
tests/test_torch_int8_serving.py):

- num_beams=1 gives generate_tokens' greedy tokens exactly;
- num_beams=4 gives JAX beam_search_tokens' tokens and lengths, with no EOS
  and with an EOS that fires (so finished beams freeze); the best beam's
  score equals the sequence's log-prob under the JAX model, scored by one
  teacher-forced forward, within rtol 1e-5 (fp32 sums of 4-8 log-probs in
  another order);
- the engine's generate(num_beams=4) text equals the JAX engine's, and its
  feature-cached and prefix routes still refuse beams;
- a weight-only int8 tree: tokens and lengths equal to JAX's;
- cli/inference.py --num_beams 2 runs.

JAX's beam decodes one position past generate's (serve/beam.py:93,
``positions + 1``); the port decodes at generate's position. On these
inputs JAX's own num_beams=1 equals its greedy tokens (asserted below), so
the shift does not move JAX's tokens here, and the scores are held to the
teacher-forced log-prob at the true positions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu.core.config import GenerateConfig as JGen
from grounded_video_llm_tpu.core.config import micro_vlm_config, replace
from grounded_video_llm_tpu.models import llm as jllm
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.serve import engine as jengine
from grounded_video_llm_tpu.serve import generate as jgen
from grounded_video_llm_tpu.serve import quantize as jq
from grounded_video_llm_tpu.serve.beam import beam_search_tokens as jbeam
from grounded_video_llm_tpu.text.templates import IMAGE_TOKEN_INDEX
from grounded_video_llm_tpu.text.tokenizer import build_test_tokenizer
from grounded_video_llm_tpu_torch.core.config import GenerateConfig as TGen
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.serve import generate as tgen
from grounded_video_llm_tpu_torch.serve.beam import beam_search_tokens as tbeam
from grounded_video_llm_tpu_torch.serve.engine import (
    InferenceEngine as TEngine)

NEW = 8
SCORE_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(cfg, seed):
    """Two rows, the second left-padded by 2; float pixels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 50, size=(2, 10)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    mask = np.ones((2, 10), np.int32)
    mask[1, :2] = 0
    spatial = rng.normal(size=(2, cfg.num_segs, 336, 336, 3)).astype(
        np.float32)
    temporal = rng.normal(size=(2, cfg.num_frames, 224, 224, 3)).astype(
        np.float32)
    return ids, mask, spatial, temporal


# the JAX tree's init, compiled once (its eager form takes ~3x as long)
_init = jax.jit(jvlm.init_params, static_argnums=1)


@pytest.fixture(scope="module")
def micro():
    cfg = micro_vlm_config("phi3.5")
    jp = _init(jax.random.key(0), cfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, tp


@functools.partial(jax.jit, static_argnums=1)
def _jax_token_logp(jp, cfg, ids, mask, spatial, temporal, tok):
    """Each token's log-prob after the prompt and the tokens before it: one
    teacher-forced forward of the JAX model → [B, T]."""
    feats = jvlm.encode_video(jp, cfg, spatial, temporal)
    embeds, _, m = jvlm.splice_multimodal(ids, None, mask, feats,
                                          jp["llm"]["embed"])
    full = jnp.concatenate(
        [embeds, jllm.embed_lookup(jp["llm"]["embed"], tok[:, :-1])
         .astype(embeds.dtype)], axis=1)
    fmask = jnp.concatenate([m, jnp.ones_like(tok[:, :-1], m.dtype)], axis=1)
    logits = jllm.forward_logits(jp["llm"], cfg.llm, full, fmask)
    S = embeds.shape[1]
    logp = jax.nn.log_softmax(logits[:, S - 1:].astype(jnp.float32), -1)
    return jnp.take_along_axis(logp, tok[..., None], -1)[..., 0]


def _jax_logprob(jp, cfg, ids, mask, spatial, temporal, tokens, eos):
    """Teacher-forced log-prob of each row's tokens under the JAX model, up
    to and including its first EOS (after it a beam only adds pad at 0)."""
    picked = np.asarray(_jax_token_logp(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(spatial),
        jnp.asarray(temporal), jnp.asarray(tokens)))
    out = []
    for row, lp in zip(np.asarray(tokens), picked):
        hit = np.nonzero(row == eos)[0]
        n = hit[0] + 1 if len(hit) else len(row)
        out.append(float(lp[:n].sum(dtype=np.float64)))
    return np.asarray(out)


@pytest.mark.parametrize("eos,seed", [("none", 0), ("fires", 1)])
def test_beam_matches_jax(micro, eos, seed):
    cfg, jp, tp = micro
    ids, mask, spatial, temporal = _inputs(cfg, seed)
    targs = (tp, cfg, _t(ids).long(), _t(mask).long(), _t(spatial),
             _t(temporal))
    jargs = (jp, cfg, jnp.asarray(ids), jnp.asarray(mask),
             jnp.asarray(spatial), jnp.asarray(temporal))
    greedy_kw = dict(max_new_tokens=NEW, do_sample=False, temperature=0.0,
                     pad_token_id=0)
    want1, _ = tgen.generate_tokens(*targs, None, eos_token_id=-2,
                                    **greedy_kw)
    # an EOS that fires: row 0's greedy third token ends it early
    eos_id = -2 if eos == "none" else int(want1[0, 2])
    kw = dict(max_new_tokens=NEW, eos_token_id=eos_id, pad_token_id=0)
    if eos != "none":
        want1, _ = tgen.generate_tokens(*targs, None, eos_token_id=eos_id,
                                        **greedy_kw)

    # num_beams=1 is greedy decoding, in both packages on these inputs
    got1, len1 = tbeam(*targs, num_beams=1, **kw)
    np.testing.assert_array_equal(got1.numpy(), want1.numpy())
    j1, _ = jbeam(*jargs, num_beams=1, **kw)
    np.testing.assert_array_equal(np.asarray(j1), want1.numpy())

    timings = {}
    got, lengths, scores = tbeam(*targs, num_beams=4, return_scores=True,
                                 timings=timings, **kw)
    want, want_len = jbeam(*jargs, num_beams=4, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_len))
    assert set(timings) == {"encode", "prefill", "decode", "decode_steps"}
    if eos == "fires":
        assert (got[0] == eos_id).any() and timings["decode_steps"] < NEW
    else:
        assert timings["decode_steps"] == NEW - 1
    np.testing.assert_allclose(
        scores.double().numpy(),
        _jax_logprob(jp, cfg, ids, mask, spatial, temporal, np.asarray(want),
                     eos_id), rtol=SCORE_RTOL)


def test_engine_beam_matches_jax_engine(micro):
    """generate(num_beams=4) through both engines on uint8 frames: equal
    texts; the feature-cached and prefix routes refuse beams."""
    cfg, jp, tp = micro
    tok = build_test_tokenizer("phi3.5")
    rng = np.random.default_rng(3)
    temporal = rng.integers(0, 256, (cfg.num_frames, 224, 224, 3), np.uint8)
    spatial = rng.integers(0, 256, (cfg.num_segs, 336, 336, 3), np.uint8)
    prompts = ["<image>\nwhen does it happen?", "describe <image> briefly"]
    g = dict(max_new_tokens=6, do_sample=False, num_beams=4)
    teng = TEngine(tp, cfg, tok, TGen(**g))
    jeng = jengine.InferenceEngine(jp, cfg, tok, JGen(**g))
    texts = teng.generate(prompts, temporal, spatial)
    assert texts == jeng.generate(prompts, temporal, spatial)
    assert teng.last_timings["decode_steps"] >= 1
    tokens, lengths = teng.last_tokens
    assert tokens.shape == (2, 6) and lengths.shape == (2,)
    with pytest.raises(NotImplementedError):
        teng.generate_from_features(prompts, torch.zeros(
            cfg.num_video_tokens, cfg.llm.hidden_size))
    with pytest.raises(NotImplementedError):
        teng.run_stream_prefix(["a.mp4"], ["q"])


def test_beam_int8_weight_only_matches_jax():
    """A weight-only int8 tree (bf16 activations and cache) on the widened
    micro LLM: tokens and lengths equal to JAX's."""
    cfg = micro_vlm_config("phi3.5")
    cfg = replace(cfg, llm=replace(cfg.llm, hidden_size=512,
                                   intermediate_size=512, num_heads=8,
                                   num_kv_heads=8, head_dim=64))
    jp = _init(jax.random.key(2), cfg)
    jp = dict(jp, llm=jq.quantize_llm_for_serving(jp["llm"]))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    rng = np.random.default_rng(2)
    ids, mask, _, _ = _inputs(cfg, 2)
    sp = rng.integers(0, 256, (2, cfg.num_segs, 336, 336, 3), dtype=np.uint8)
    tm = rng.integers(0, 256, (2, cfg.num_frames, 224, 224, 3),
                      dtype=np.uint8)
    kw = dict(max_new_tokens=6, num_beams=4, eos_token_id=-2, pad_token_id=0)
    got, lengths = tbeam(tp, cfg, _t(ids).long(), _t(mask).long(), _t(sp),
                         _t(tm), **kw)
    want, want_len = jbeam(jp, cfg, jnp.asarray(ids), jnp.asarray(mask),
                           jnp.asarray(sp), jnp.asarray(tm), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_len))


def test_cli_inference_num_beams(tmp_path, capsys):
    """cli/inference.py --num_beams 2 on a cv2 mp4 runs its three modes."""
    cv2 = pytest.importorskip("cv2")
    from grounded_video_llm_tpu_torch.cli import inference

    path = tmp_path / "clip.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (64, 48))
    rng = np.random.default_rng(0)
    for _ in range(30):
        w.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    w.release()
    results = inference.main(["--debug_tiny", "--device", "cpu",
                              "--video_path", str(path), "--num_beams", "2",
                              "--max_new_tokens", "4", "--no-do_sample"])
    assert set(results) == {"grounding", "qa", "referring"}
    out = capsys.readouterr().out
    assert out.count("raw:") == 3
