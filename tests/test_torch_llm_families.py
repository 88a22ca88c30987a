"""llama3 and vicuna through the port against the JAX package on the CPU,
and the clip-chunked InternVideo2 encode (``encoder_chunk_clips``).

fp32 on ``micro_vlm_config(name)`` (llama wiring: CLIP features pooled
24x24 → 8x8 before the mm_projector, the stored ``image_newline`` as each
segment's newline, GQA, rope θ = 500,000), weights from the JAX init
through the weight bridge:

  - the bridge uses every leaf once, ``image_newline`` included;
  - ``encode_video`` within rtol 2e-4 (the per-module bar), the composite
    prefill logits within rtol 5e-4;
  - greedy tokens exactly equal to the JAX package's: ``generate_tokens``
    unquantized, and both engines in ``int8_full`` (llama3 also ``int8``)
    with the int8 cache. The int8 cases widen the micro LLM (hidden 512, 8
    heads of 64; llama3 4 KV heads, vicuna 8) and IV2 (embed 128) so every
    weight meets the JAX int8 kernels' tiling, as
    tests/test_torch_int8_serving.py does for Phi-3.5, and set LayerScale
    to 1 so static scales move the output;
  - on llama3, once each: speculative decoding, the fused W8A8 IV2 blocks
    (``GVLLM_FUSED_IV2=1``) and static activation scales, greedy tokens
    equal to the JAX package's;
  - the full-width llama3 and vicuna trees quantize on the meta device
    with the lm_head's ragged vocabulary in rows padded to 16 bytes, and
    the decode wrapper plans every decode shape of them;
  - ``cli/inference.py --llm llama3|vicuna --debug_tiny --device cpu``.

Chunking: with ``encoder_chunk_clips=2`` over 4 clips the port runs
InternVideo2 twice on 2 clips, its features equal the whole encode's
(rtol 1e-5, as the JAX package's own test) and lie within rtol 2e-4 of
JAX's with the same field, for phi3.5 and llama3.
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
from grounded_video_llm_tpu.serve import speculative as jspec
from grounded_video_llm_tpu.serve.generate import (
    generate_tokens as j_generate)
from grounded_video_llm_tpu.text.tokenizer import (build_test_tokenizer,
                                                   pad_batch_generate,
                                                   tokenize_with_image)
from grounded_video_llm_tpu_torch.core.config import GenerateConfig as TGen
from grounded_video_llm_tpu_torch.core.config import vlm_config
from grounded_video_llm_tpu_torch.models import internvideo2 as tiv2
from grounded_video_llm_tpu_torch.models import llm as tllm
from grounded_video_llm_tpu_torch.models import vlm as tvlm
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.ops import int8_matmul as mm
from grounded_video_llm_tpu_torch.serve import quantize as tq
from grounded_video_llm_tpu_torch.serve import speculative as tspec
from grounded_video_llm_tpu_torch.serve.engine import (
    InferenceEngine as TEngine)
from grounded_video_llm_tpu_torch.serve.generate import (
    generate_tokens as t_generate)

FAMILIES = ["llama3", "vicuna"]
RTOL, ATOL = 2e-4, 2e-5                     # per module
COMPOSITE_RTOL, COMPOSITE_ATOL = 5e-4, 5e-5
PROMPTS = ["<image>\nwhen does it happen?", "describe <image> briefly please"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _pixels(cfg, B, seed):
    rng = np.random.default_rng(seed)
    sp = rng.integers(0, 256, (B, cfg.num_segs, 336, 336, 3), dtype=np.uint8)
    tm = rng.integers(0, 256, (B, cfg.num_frames, 224, 224, 3),
                      dtype=np.uint8)
    return sp, tm


def _ids(cfg, tok):
    seqs = [tokenize_with_image(p, tok) for p in PROMPTS]
    return pad_batch_generate(seqs, tok.pad_token_id, cfg.max_txt_len)


@functools.lru_cache(maxsize=None)
def _family(name):
    cfg = micro_vlm_config(name)
    jp = jvlm.init_params(jax.random.key(7), cfg)
    np_tree = _np(jp)
    return name, cfg, jp, np_tree, params_from_jax(np_tree, cfg, "cpu")


@pytest.fixture(params=FAMILIES)
def family(request):
    return _family(request.param)


def test_llama3_video_token_count():
    cfg = vlm_config("llama3", stage="inference")
    assert cfg.spatial_tokens_per_seg == 64 and cfg.tokens_per_seg == 193
    assert cfg.num_video_tokens == 12 * 193 == 2316
    assert vlm_config("vicuna").num_video_tokens == 2316


def test_params_from_jax_uses_every_leaf_once(family):
    name, cfg, _, np_tree, tp = family
    assert set(tp["extras"]) == {"image_newline"}
    assert tuple(tp["extras"]["image_newline"].shape) == (
        cfg.llm.hidden_size,)
    assert tuple(tp["mm_projector"]["fc1"]["kernel"].shape) == (
        cfg.clip.hidden_size, cfg.llm.hidden_size)
    j_leaves, t_leaves = (jax.tree_util.tree_leaves(np_tree),
                          _leaves(tp))
    assert len(j_leaves) == len(t_leaves)
    assert len({id(t) for t in t_leaves}) == len(t_leaves)
    for a, b in zip(j_leaves, jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(), tp))):
        np.testing.assert_array_equal(a, b)
    # the port's own init makes the same tree
    own = tvlm.init_params(cfg, generator=None, device="meta")
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, own)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0,
                                                            np_tree))


def test_encode_and_prefill_match_jax(family):
    """encode_video (rtol 2e-4), then splice → prefill logits (5e-4)."""
    name, cfg, jp, _, tp = family
    tok = build_test_tokenizer(name)
    ids, mask = _ids(cfg, tok)
    sp, tm = _pixels(cfg, ids.shape[0], 3)
    fj = jvlm.encode_video(jp, cfg, jnp.asarray(sp), jnp.asarray(tm))
    ft = tvlm.encode_video(tp, cfg, torch.from_numpy(sp),
                           torch.from_numpy(tm))
    assert tuple(ft.shape) == (2, cfg.num_video_tokens, cfg.llm.hidden_size)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=RTOL,
                               atol=ATOL)
    B = ids.shape[0]
    ej, _, mj = jvlm.splice_multimodal(jnp.asarray(ids), None,
                                       jnp.asarray(mask), fj,
                                       jp["llm"]["embed"])
    lj, _ = jllm.prefill(jp["llm"], cfg.llm, ej, mj,
                         jllm.KVCache.create(cfg.llm, B, ej.shape[1] + 8,
                                             jnp.float32))
    et, _, mt = tvlm.splice_multimodal(torch.from_numpy(ids).long(), None,
                                       torch.from_numpy(mask).long(), ft,
                                       tp["llm"]["embed"])
    lt, _ = tllm.prefill(tp["llm"], cfg.llm, et, mt,
                         tllm.KVCache.create(cfg.llm, B, et.shape[1] + 8,
                                             torch.float32))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                               rtol=COMPOSITE_RTOL, atol=COMPOSITE_ATOL)


def test_greedy_tokens_equal_jax(family):
    name, cfg, jp, _, tp = family
    tok = build_test_tokenizer(name)
    ids, mask = _ids(cfg, tok)
    sp, tm = _pixels(cfg, ids.shape[0], 4)
    kw = dict(max_new_tokens=8, do_sample=False,
              eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
    tj, lj = j_generate(jp, cfg, jnp.asarray(ids), jnp.asarray(mask),
                        jnp.asarray(sp), jnp.asarray(tm), jax.random.key(0),
                        **kw)
    tt, lt = t_generate(tp, cfg, torch.from_numpy(ids).long(),
                        torch.from_numpy(mask).long(), torch.from_numpy(sp),
                        torch.from_numpy(tm), None, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


# ---------------------------------------------------------------------------
# int8 serving: both engines on a widened micro model
# ---------------------------------------------------------------------------


def _wide_cfg(name):
    cfg = micro_vlm_config(name)
    return replace(
        cfg, llm=replace(cfg.llm, hidden_size=512, intermediate_size=512,
                         num_heads=8, head_dim=64,
                         num_kv_heads=4 if name == "llama3" else 8),
        video=replace(cfg.video, embed_dim=128, num_heads=2, mlp_ratio=4.0))


@functools.lru_cache(maxsize=None)
def _wide(name):
    cfg = _wide_cfg(name)
    jp = jvlm.init_params(jax.random.key(8), cfg)
    # LayerScale 1: at its init of 1e-5 no block moves the residual, so no
    # W8A8 rounding or activation scale of the trunk could change a token
    blocks = dict(jp["video_encoder"]["blocks"])
    for leg in ("ls1", "ls2"):
        blocks[leg] = jnp.ones_like(blocks[leg])
    jp = dict(jp, video_encoder=dict(jp["video_encoder"], blocks=blocks))
    tok = build_test_tokenizer(name)
    rng = np.random.default_rng(5)
    sp = rng.integers(0, 256, (cfg.num_segs, 336, 336, 3), dtype=np.uint8)
    tm = rng.integers(0, 256, (cfg.num_frames, 224, 224, 3), dtype=np.uint8)
    return name, cfg, jp, params_from_jax(_np(jp), cfg, "cpu"), tok, sp, tm


def _engines_equal(monkeypatch, wide_model, quantize, gen, *,
                   static_scales=False):
    """The JAX and the port InferenceEngine, each quantizing the same fp32
    tree itself: greedy tokens for PROMPTS, token for token."""
    _, cfg, jp, tp, tok, sp, tm = wide_model
    captured = {}
    j_gen = jengine.generate_tokens

    def capture(*a, **kw):
        out = j_gen(*a, **kw)
        captured["tokens"] = np.asarray(out[0])
        return out

    monkeypatch.setattr(jengine, "generate_tokens", capture)
    jeng = jengine.InferenceEngine(jp, cfg, tok, quantize=quantize,
                                   static_scales=static_scales)
    jeng.generate(PROMPTS, tm, sp, JGen(**gen))
    teng = TEngine(tp, cfg, tok, quantize=quantize,
                   static_scales=static_scales)
    teng.generate(PROMPTS, tm, sp, TGen(**gen))
    np.testing.assert_array_equal(teng.last_tokens[0].numpy(),
                                  captured["tokens"])
    return teng


@pytest.mark.parametrize("name,quantize", [("llama3", "int8"),
                                           ("llama3", "int8_full"),
                                           ("vicuna", "int8_full")])
def test_engine_int8_greedy_equals_jax_engine(name, quantize, monkeypatch):
    teng = _engines_equal(monkeypatch, _wide(name), quantize,
                          dict(max_new_tokens=8, do_sample=False,
                               quantize_cache=True))
    layers = teng.params["llm"]["layers"]
    assert all(layers[k].w8a8 == (quantize == "int8_full")
               for k in tq.QUANT_KERNELS)
    assert teng.last_timings["decode_steps"] == 7


def test_llama3_static_scales_greedy_equals_jax_engine(monkeypatch):
    teng = _engines_equal(monkeypatch, _wide("llama3"), "int8_full",
                          dict(max_new_tokens=8, do_sample=False,
                               quantize_cache=True), static_scales=True)
    assert teng.calibrations == 1
    blocks = teng.params["video_encoder"]["blocks"]
    assert blocks["fc2"]["kernel"].x_scale is not None


def test_llama3_fused_iv2_greedy_equals_jax_engine(monkeypatch):
    wide = _wide("llama3")
    monkeypatch.setenv("GVLLM_FUSED_IV2", "1")
    calls = []
    fused = tiv2._block_fused_int8

    def count(*a, **kw):
        calls.append(1)
        return fused(*a, **kw)

    monkeypatch.setattr(tiv2, "_block_fused_int8", count)
    _engines_equal(monkeypatch, wide, "int8_full",
                   dict(max_new_tokens=8, do_sample=False,
                        quantize_cache=True))
    assert len(calls) == wide[1].video.num_blocks_used


def test_llama3_spec_decode_equals_jax():
    name, cfg, jp, _, tp = _family("llama3")
    tok = build_test_tokenizer(name)
    ids, mask = _ids(cfg, tok)
    sp, tm = _pixels(cfg, ids.shape[0], 6)
    kw = dict(max_new_tokens=6, do_sample=False, temperature=0.0,
              eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
    jt, jlen = jspec.generate_tokens_spec(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(sp),
        jnp.asarray(tm), jax.random.key(0), draft_len=3, **kw)
    timings = {}
    tt, tlen = tspec.generate_tokens_spec(
        tp, cfg, torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
        torch.from_numpy(sp), torch.from_numpy(tm), None, draft_len=3,
        timings=timings, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert timings["verify_passes"] >= 1


@pytest.mark.parametrize("name,padded", [("llama3", 128560),
                                         ("vicuna", 32304)])
def test_full_width_tree_quantizes_with_padded_lm_head(name, padded):
    """The full-width LLM on the meta device: every projection an int8
    weight with per-channel scales, the lm_head's ragged vocabulary (+302
    temporal tokens) in rows padded to 16 bytes, and the decode wrapper's
    plan taking every decode shape (M 1 and 6) of the tree."""
    cfg = vlm_config(name, stage="inference")
    llm = tllm.init_params(cfg.llm, generator=None, device="meta",
                           dtype=torch.bfloat16)
    q = tq.quantize_llm_for_serving(llm, w8a8=True)
    V = cfg.llm.padded_vocab_size
    head = q["lm_head"]
    assert V % 16 and -(-V // 16) * 16 == padded
    assert tuple(head.q.shape) == (cfg.llm.hidden_size, V)
    assert head.q.stride() == (padded, 1) and not head.w8a8
    assert tuple(q["embed"].q.shape) == (V, cfg.llm.hidden_size)
    L = cfg.llm
    for k in tq.QUANT_KERNELS:
        w = q["layers"][k]
        assert w.w8a8 and w.q.dtype == torch.int8
        assert w.scale.shape == (L.num_layers, w.q.shape[-1])
        for M in (1, 6):
            assert mm.int8_matmul_plan(M, *w.q.shape[1:], True) is not None
    for M in (1, 6):
        assert mm.int8_matmul_plan(M, L.hidden_size, V, False) is not None


# ---------------------------------------------------------------------------
# encoder_chunk_clips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["phi3.5", "llama3"])
def test_encoder_chunk_clips(name, monkeypatch):
    cfg = micro_vlm_config(name)
    chunked = replace(cfg, encoder_chunk_clips=2)
    jp = jvlm.init_params(jax.random.key(9), cfg)
    tp = params_from_jax(_np(jp), cfg, "cpu")
    sp, tm = _pixels(cfg, 2, 10)                  # 2 x 2 segments = 4 clips
    whole = tvlm.encode_video(tp, cfg, torch.from_numpy(sp),
                              torch.from_numpy(tm))
    sizes = []
    features = tiv2.features

    def count(params, vcfg, clips, *a, **kw):
        sizes.append(clips.shape[0])
        return features(params, vcfg, clips, *a, **kw)

    monkeypatch.setattr(tiv2, "features", count)
    got = tvlm.encode_video(tp, chunked, torch.from_numpy(sp),
                            torch.from_numpy(tm))
    assert sizes == [2, 2]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)
    want = jvlm.encode_video(jp, chunked, jnp.asarray(sp), jnp.asarray(tm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # a chunk that does not divide the clips, or covers them all, encodes
    # them in one call, as in the JAX package
    for c in (3, 4):
        sizes.clear()
        tvlm.encode_video(tp, replace(cfg, encoder_chunk_clips=c),
                          torch.from_numpy(sp), torch.from_numpy(tm))
        assert sizes == [4]


@pytest.mark.parametrize("name,quantize", [("llama3", ""),
                                           ("vicuna", "int8_full")])
def test_cli_inference_debug_tiny_serves_family(name, quantize, tmp_path,
                                                capsys):
    cv2 = pytest.importorskip("cv2")
    from grounded_video_llm_tpu_torch.cli import inference

    path = tmp_path / "clip.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (64, 48))
    rng = np.random.default_rng(1)
    for _ in range(30):
        w.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    w.release()
    results = inference.main(["--llm", name, "--debug_tiny", "--device",
                              "cpu", "--quantize", quantize,
                              "--max_new_tokens", "4", "--no-do_sample",
                              "--video_path", str(path)])
    out = capsys.readouterr().out
    assert set(results) == {"grounding", "qa", "referring"}
    for mode in results:
        assert f"[{mode}] raw:" in out and f"[{mode}] parsed:" in out
