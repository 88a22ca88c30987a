"""The whole ported slice against the JAX package on the CPU, fp32, micro
config: the weight bridge, the composite forward (encode → splice →
prefill, rtol 5e-4, the repo's composite bar), greedy token equality for
left-padded batches, and the engine's text and parse."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_llm_tpu.core.config import (GenerateConfig,
                                                micro_vlm_config)
from grounded_video_llm_tpu.models import llm as jllm
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.ops.preprocess import (
    dual_stream_resize_host as j_resize)
from grounded_video_llm_tpu.serve.engine import InferenceEngine as JEngine
from grounded_video_llm_tpu.serve.generate import (
    generate_tokens as j_generate)
from grounded_video_llm_tpu.text.tokenizer import (build_test_tokenizer,
                                                   pad_batch_generate,
                                                   tokenize_with_image)
from grounded_video_llm_tpu_torch.models import llm as tllm
from grounded_video_llm_tpu_torch.models import vlm as tvlm
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.ops.preprocess import (
    dual_stream_resize_host as t_resize)
from grounded_video_llm_tpu_torch.serve.engine import (
    InferenceEngine as TEngine)
from grounded_video_llm_tpu_torch.serve.generate import (
    generate_tokens as t_generate)

COMPOSITE_RTOL, COMPOSITE_ATOL = 5e-4, 5e-5


@pytest.fixture(scope="module")
def model():
    cfg = micro_vlm_config("phi3.5")
    jparams = jvlm.init_params(jax.random.key(1), cfg)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_jax(np_tree, cfg, "cpu")
    tok = build_test_tokenizer("phi3.5")
    return cfg, jparams, np_tree, tparams, tok


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_params_from_jax_uses_every_leaf_once(model):
    cfg, _, np_tree, tparams, _ = model
    j_leaves, t_leaves = _leaves(np_tree), _leaves(tparams)
    assert len(j_leaves) == len(t_leaves) == len(
        jax.tree_util.tree_leaves(np_tree))
    assert len({id(t) for t in t_leaves}) == len(t_leaves)
    for a, b in zip(jax.tree_util.tree_leaves(np_tree),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(lambda t: t.numpy(), tparams))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_params_from_jax_fails_loudly(model, fault):
    cfg, _, np_tree, _, _ = model
    bad = jax.tree_util.tree_map(lambda a: a, np_tree)
    if fault == "missing":
        del bad["extras"]["sub_GN"]
    elif fault == "extra":
        bad["extras"]["stray"] = np.zeros(3, np.float32)
    else:
        bad["llm"]["final_norm_w"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError):
        params_from_jax(bad, cfg, "cpu")


def _frames(seed, n, h=60, w=80):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def _batch(cfg, tok, prompts):
    seqs = [tokenize_with_image(p, tok) for p in prompts]
    return pad_batch_generate(seqs, tok.pad_token_id, cfg.max_txt_len)


def test_composite_prefill_logits_match_jax(model):
    """encode (uint8 pixels) → splice → prefill, the slice's forward."""
    cfg, jp, _, tp, tok = model
    temporal, spatial = t_resize(_frames(2, cfg.num_frames), cfg.num_segs)
    ids, mask = _batch(cfg, tok, ["<image>\nwhat is shown?",
                                  "a longer question <image> about it"])
    B = ids.shape[0]
    sp = np.broadcast_to(spatial[None], (B, *spatial.shape)).copy()
    tm = np.broadcast_to(temporal[None], (B, *temporal.shape)).copy()

    fj = jvlm.encode_video(jp, cfg, jnp.asarray(sp), jnp.asarray(tm))
    ej, _, mj = jvlm.splice_multimodal(jnp.asarray(ids), None,
                                       jnp.asarray(mask), fj,
                                       jp["llm"]["embed"])
    lj, _ = jllm.prefill(jp["llm"], cfg.llm, ej, mj,
                         jllm.KVCache.create(cfg.llm, B, ej.shape[1] + 8,
                                             jnp.float32))
    ft = tvlm.encode_video(tp, cfg, torch.from_numpy(sp), torch.from_numpy(tm))
    et, _, mt = tvlm.splice_multimodal(torch.from_numpy(ids).long(), None,
                                       torch.from_numpy(mask).long(), ft,
                                       tp["llm"]["embed"])
    lt, _ = tllm.prefill(tp["llm"], cfg.llm, et, mt,
                         tllm.KVCache.create(cfg.llm, B, et.shape[1] + 8,
                                             torch.float32))
    for a, b in ((ft, fj), (et, ej), (lt, lj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=COMPOSITE_RTOL, atol=COMPOSITE_ATOL)


def test_greedy_tokens_equal_jax_left_padded(model):
    cfg, jp, _, tp, tok = model
    ids, mask = _batch(cfg, tok, ["<image>\nwhen does it happen?",
                                  "describe <image> briefly"])
    assert mask[:, 0].tolist() != [1, 1]   # one row is left-padded
    rng = np.random.default_rng(3)
    B = ids.shape[0]
    sp = rng.integers(0, 256, (B, cfg.num_segs, 336, 336, 3), dtype=np.uint8)
    tm = rng.integers(0, 256, (B, cfg.num_frames, 224, 224, 3),
                      dtype=np.uint8)
    kw = dict(max_new_tokens=6, do_sample=False,
              eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
    tj, lj = j_generate(jp, cfg, jnp.asarray(ids), jnp.asarray(mask),
                        jnp.asarray(sp), jnp.asarray(tm), jax.random.key(0),
                        **kw)
    tt, lt = t_generate(tp, cfg, torch.from_numpy(ids).long(),
                        torch.from_numpy(mask).long(), torch.from_numpy(sp),
                        torch.from_numpy(tm), None, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_engine_text_and_parse_match_jax(model):
    cfg, jp, _, tp, tok = model
    gen = GenerateConfig(max_new_tokens=8, do_sample=False)
    frames = _frames(4, cfg.num_frames)
    duration = 12.5
    prompt = "When does the person open the door?"

    teng = TEngine(tp, cfg, tok, gen)
    tres = teng.run_frames(frames, duration, prompt, mode="grounding")

    jeng = JEngine(jp, cfg, tok, gen)
    temporal, spatial = j_resize(frames, cfg.num_segs)
    t_temporal, t_spatial = teng.preprocess_frames(frames)
    np.testing.assert_array_equal(t_temporal, temporal)
    np.testing.assert_array_equal(t_spatial, spatial)
    text_prompt = jeng.build_prompt(prompt, "grounding", duration)
    assert teng.build_prompt(prompt, "grounding", duration) == text_prompt
    jtexts = jeng.generate([text_prompt], temporal, spatial)
    jres = jeng._result(jtexts[0], duration)
    assert (tres.text, tres.parsed, tres.intervals) == (
        jres.text, jres.parsed, jres.intervals)
    assert set(teng.last_timings) >= {"preprocess", "encode", "prefill",
                                      "decode"}


@pytest.mark.parametrize("field,value", [("num_beams", 2),
                                         ("spec_draft_len", 4),
                                         ("quantize_cache", True)])
def test_engine_refuses_unported_modes(model, field, value):
    """Beam search, the int8 cache, speculative decoding and static
    activation scales are ported (a beam request runs its decode steps, a
    speculative request its verify passes); static scales without
    int8_full's W8A8 encoders are refused when the engine is made."""
    cfg, _, _, tp, tok = model
    gen = GenerateConfig(max_new_tokens=2, **{field: value})
    with pytest.raises(ValueError, match="int8_full"):
        TEngine(tp, cfg, tok, gen, quantize="int8", static_scales=True)
    assert TEngine(tp, cfg, tok, gen, quantize="int8_full",
                   static_scales=True).calibrations == 0
    if field == "quantize_cache":
        return
    eng = TEngine(tp, cfg, tok, gen)
    eng.run_frames(_frames(5, cfg.num_frames), 5.0, "hi", mode="qa")
    if field == "spec_draft_len":
        assert eng.last_timings["verify_passes"] >= 1
    else:
        assert eng.last_timings["decode_steps"] >= 1
