"""The int8 serving slice of the port against the JAX package on the CPU:
the weight bridge for serving-int8 trees, the port's own quantization, the
prefill logits and greedy tokens for the three serving modes, the
engine's refusals, and the engine serving a LoRA tree (bf16 overlay;
merged before int8_full) token-equal to the JAX engine.

  A  int8_full (W8A8 encoders, W8A8 prefill, w8a8 decode projections) with
     the int8 KV cache;
  B  int8 (weight-only) with the int8 KV cache;
  C  int8 (weight-only) with the bf16 KV cache.

The micro LLM is widened (hidden 512, intermediate 512, 8 heads of 64) so
every projection meets the Pallas tiling of the JAX int8 kernels (D % 32,
O % 512) and JAX runs the kernels' math, not its dequantize-first branch.

Both packages run the int8 path in bf16 activations (the int8 embedding
implies bf16), so the bars are bf16-level: prefill logits within a relative
L2 of 3e-2 (measured 0.6e-2 weight-only, 1.5e-2 int8_full: ~one bf16 ulp of
rounding difference per op over two layers, amplified by W8A8's per-row
activation rounding) and greedy tokens exactly equal over 8 new tokens for
two left-padded prompts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu.core.config import GenerateConfig as \
    JGenerateConfig
from grounded_video_llm_tpu.core.config import micro_vlm_config, replace
from grounded_video_llm_tpu.models import llm as jllm
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.serve import engine as jengine
from grounded_video_llm_tpu.serve import quantize as jq
from grounded_video_llm_tpu.serve.generate import (
    generate_tokens as j_generate)
from grounded_video_llm_tpu.train import lora as jlora
from grounded_video_llm_tpu.text.tokenizer import (build_test_tokenizer,
                                                   pad_batch_generate,
                                                   tokenize_with_image)
from grounded_video_llm_tpu_torch.core.config import \
    GenerateConfig as TGenerateConfig
from grounded_video_llm_tpu_torch.models import llm as tllm
from grounded_video_llm_tpu_torch.models import vlm as tvlm
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.ops.int8_matmul import (Int8Embedding,
                                                         Int8Weight)
from grounded_video_llm_tpu_torch.serve import quantize as tq
from grounded_video_llm_tpu_torch.serve.engine import (
    InferenceEngine as TEngine)
from grounded_video_llm_tpu_torch.serve.generate import (
    generate_tokens as t_generate)

LOGITS_REL_L2 = 3e-2
# (quantize, quantize_cache) of modes A, B, C
MODES = {"A_int8_full_int8_cache": ("int8_full", True),
         "B_int8_int8_cache": ("int8", True),
         "C_int8_bf16_cache": ("int8", False)}


def _jax_serving_tree(jp, quantize):
    out = dict(jp)
    out["llm"] = jq.quantize_llm_for_serving(jp["llm"],
                                             w8a8=quantize == "int8_full")
    if quantize == "int8_full":
        out["video_encoder"] = jq.quantize_video_encoder_for_serving(
            jp["video_encoder"])
        out["clip"] = jq.quantize_clip_for_serving(jp["clip"])
    return out


@pytest.fixture(scope="module")
def model():
    cfg = micro_vlm_config("phi3.5")
    cfg = replace(cfg, llm=replace(cfg.llm, hidden_size=512,
                                   intermediate_size=512, num_heads=8,
                                   num_kv_heads=8, head_dim=64))
    jp = jvlm.init_params(jax.random.key(2), cfg)
    trees = {}
    for quantize in ("int8", "int8_full"):
        jtree = _jax_serving_tree(jp, quantize)
        np_tree = jax.tree_util.tree_map(np.asarray, jtree)
        trees[quantize] = (jtree, np_tree,
                           params_from_jax(np_tree, cfg, "cpu"))
    tok = build_test_tokenizer("phi3.5")
    seqs = [tokenize_with_image(p, tok) for p in
            ["<image>\nwhen does it happen?", "describe <image> briefly please"]]
    ids, mask = pad_batch_generate(seqs, tok.pad_token_id, cfg.max_txt_len)
    assert mask[:, 0].tolist() != [1, 1]      # one row is left-padded
    rng = np.random.default_rng(2)
    B = ids.shape[0]
    sp = rng.integers(0, 256, (B, cfg.num_segs, 336, 336, 3), dtype=np.uint8)
    tm = rng.integers(0, 256, (B, cfg.num_frames, 224, 224, 3),
                      dtype=np.uint8)
    fp32 = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, fp32, trees, tok, ids, mask, sp, tm


def _pairs(tree, prefix=()):
    """(path, leaf) of a port parameter tree, int8 weights as leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_params_from_jax_maps_serving_int8_tree_exactly(model):
    _, _, _, trees, *_ = model
    jtree, np_tree, tp = trees["int8_full"]
    n_int8 = 0
    for path, leaf in _pairs(tp):
        src = _get(np_tree, path)
        if isinstance(leaf, (Int8Weight, Int8Embedding)):
            n_int8 += 1
            assert leaf.q.dtype == torch.int8
            assert leaf.scale.dtype == torch.float32
            np.testing.assert_array_equal(leaf.q.numpy(), src["q"])
            np.testing.assert_array_equal(leaf.scale.numpy(), src["scale"])
            if isinstance(leaf, Int8Weight):
                assert leaf.w8a8 == ("w8a8" in src)
        else:
            np.testing.assert_array_equal(leaf.numpy(), src)
    # 4 decoder projections + lm_head + embedding, 6 CLIP and 4 IV2 kernels
    assert n_int8 == 16
    assert isinstance(tp["llm"]["embed"], Int8Embedding)
    assert tp["llm"]["layers"]["qkv_kernel"].w8a8
    assert not tp["llm"]["lm_head"].w8a8
    assert not trees["int8"][2]["llm"]["layers"]["down_kernel"].w8a8


@pytest.mark.parametrize("quantize", ["int8", "int8_full"])
def test_port_quantization_equals_jax(model, quantize):
    """The port's serve/quantize on the same float weights gives the JAX
    tree bit for bit (values, scales, markers)."""
    _, _, fp32, trees, *_ = model
    ours = dict(fp32)
    ours["llm"] = tq.quantize_llm_for_serving(fp32["llm"],
                                              w8a8=quantize == "int8_full")
    if quantize == "int8_full":
        ours["video_encoder"] = tq.quantize_video_encoder_for_serving(
            fp32["video_encoder"])
        ours["clip"] = tq.quantize_clip_for_serving(fp32["clip"])
    theirs = trees[quantize][2]
    a, b = dict(_pairs(ours)), dict(_pairs(theirs))
    assert a.keys() == b.keys()
    for path, leaf in a.items():
        other = b[path]
        assert type(leaf) is type(other), path
        if isinstance(leaf, torch.Tensor):
            assert torch.equal(leaf, other), path
        else:
            assert torch.equal(leaf.q, other.q), path
            assert torch.equal(leaf.scale, other.scale), path
            assert leaf[2:] == other[2:] if isinstance(leaf, Int8Weight) \
                else True, path


@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_logits_bf16_level(model, mode):
    cfg, _, _, trees, _, ids, mask, sp, tm = model
    quantize, quant_cache = MODES[mode]
    jtree, _, tp = trees[quantize]
    B = ids.shape[0]
    fj = jvlm.encode_video(jtree, cfg, jnp.asarray(sp), jnp.asarray(tm))
    ej, _, mj = jvlm.splice_multimodal(jnp.asarray(ids), None,
                                       jnp.asarray(mask), fj,
                                       jtree["llm"]["embed"])
    max_len = -(-(ej.shape[1] + 8) // 128) * 128
    lj, _ = jllm.prefill(jtree["llm"], cfg.llm, ej, mj,
                         jllm.KVCache.create(cfg.llm, B, max_len),
                         quantize_cache=quant_cache)
    with torch.inference_mode():
        ft = tvlm.encode_video(tp, cfg, torch.from_numpy(sp),
                               torch.from_numpy(tm))
        et, _, mt = tvlm.splice_multimodal(
            torch.from_numpy(ids).long(), None, torch.from_numpy(mask).long(),
            ft, tp["llm"]["embed"])
        cache = (tllm.QuantKVCache.create(cfg.llm, B, max_len) if quant_cache
                 else tllm.KVCache.create(cfg.llm, B, max_len))
        lt, ct = tllm.prefill(tp["llm"], cfg.llm, et, mt, cache)
    assert et.dtype == torch.bfloat16 and lt.dtype == torch.float32
    assert type(ct) is type(cache) and ct.k.data_ptr() == cache.k.data_ptr()
    lj = np.asarray(lj, np.float64)
    rel = np.linalg.norm(lt.double().numpy() - lj) / np.linalg.norm(lj)
    assert rel <= LOGITS_REL_L2, rel


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_tokens_equal_jax(model, mode):
    cfg, _, _, trees, tok, ids, mask, sp, tm = model
    quantize, quant_cache = MODES[mode]
    jtree, _, tp = trees[quantize]
    kw = dict(max_new_tokens=8, do_sample=False,
              eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
              quantize_cache=quant_cache)
    tj, lj = j_generate(jtree, cfg, jnp.asarray(ids), jnp.asarray(mask),
                        jnp.asarray(sp), jnp.asarray(tm), jax.random.key(0),
                        **kw)
    timings = {}
    tt, lt = t_generate(tp, cfg, torch.from_numpy(ids).long(),
                        torch.from_numpy(mask).long(), torch.from_numpy(sp),
                        torch.from_numpy(tm), None, timings=timings, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert timings["decode_steps"] == 7


@pytest.mark.parametrize("fault", ["x_scale", "marker_value", "q_dtype",
                                   "scale_shape"])
def test_params_from_jax_refuses_bad_int8_pairs(model, fault):
    cfg, _, _, trees, *_ = model
    bad = jax.tree_util.tree_map(lambda a: a, trees["int8_full"][1])
    pair = dict(bad["clip"]["layers"]["q"]["kernel"])
    if fault == "x_scale":
        pair["x_scale"] = np.ones((), np.float32)
    elif fault == "marker_value":
        pair["w8a8"] = np.zeros(1)
        bad["llm"]["layers"]["qkv_kernel"] = dict(
            bad["llm"]["layers"]["qkv_kernel"], w8a8=np.zeros(1))
    elif fault == "q_dtype":
        pair["q"] = pair["q"].astype(np.int16)
    else:
        pair["scale"] = pair["scale"][..., :-1]
    bad["clip"]["layers"]["q"]["kernel"] = pair
    with pytest.raises(ValueError):
        params_from_jax(bad, cfg, "cpu")


def test_engine_quantizes_and_refuses(model):
    cfg, _, fp32, _, tok, *_ = model
    full = TEngine(fp32, cfg, tok, quantize="int8_full")
    assert full.params["llm"]["layers"]["qkv_kernel"].w8a8
    assert isinstance(full.params["clip"]["layers"]["fc1"]["kernel"],
                      Int8Weight)
    assert isinstance(full.params["video_encoder"]["blocks"]["qkv_kernel"],
                      Int8Weight)
    wo = TEngine(fp32, cfg, tok, quantize="int8")
    assert not wo.params["llm"]["layers"]["qkv_kernel"].w8a8
    assert isinstance(wo.params["clip"]["layers"]["fc1"]["kernel"],
                      torch.Tensor)
    assert isinstance(fp32["llm"]["embed"], torch.Tensor)   # not modified
    static = TEngine(fp32, cfg, tok, quantize="int8_full",
                     static_scales=True)       # calibrates at its 1st request
    assert static.calibrations == 0
    with pytest.raises(ValueError, match="int8_full"):
        TEngine(fp32, cfg, tok, quantize="int8", static_scales=True)
    with pytest.raises(ValueError):
        TEngine(fp32, cfg, tok, quantize="int4")
    # an unmerged LoRA tree is still refused by the quantizer itself, as
    # the JAX function asserts; the engine merges before it quantizes
    lora = dict(fp32["llm"])
    lora["layers"] = dict(fp32["llm"]["layers"], lora={})
    with pytest.raises(ValueError, match="merge_lora"):
        tq.quantize_llm_for_serving(lora)


def _with_lora(jp, cfg, seed):
    """jp with rank-4 adapters on the LLM whose B is drawn from a numpy seed
    (B != 0, so the adapters change the logits)."""
    out = dict(jp)
    out["llm"] = jlora.attach_lora(
        jp["llm"], jlora.init_lora(jax.random.key(seed), cfg.llm, rank=4))
    rng = np.random.default_rng(seed)
    for la in out["llm"]["layers"]["lora"].values():
        la["b"] = jnp.asarray(
            (rng.normal(size=la["b"].shape) * 0.05).astype(np.float32))
    return out


def _engine_tokens_equal(monkeypatch, cfg, jp, tok, quantize, quant_cache,
                         sp, tm):
    """The JAX and the port InferenceEngine on the same LoRA tree: 8 greedy
    tokens for two prompts, token for token."""
    captured = {}
    j_gen = jengine.generate_tokens

    def capture(*a, **kw):
        out = j_gen(*a, **kw)
        captured["tokens"] = np.asarray(out[0])
        return out

    monkeypatch.setattr(jengine, "generate_tokens", capture)
    prompts = ["<image>\nwhen does it happen?",
               "describe <image> briefly please"]
    gen = dict(max_new_tokens=8, do_sample=False, quantize_cache=quant_cache)
    jeng = jengine.InferenceEngine(jp, cfg, tok, quantize=quantize)
    jeng.generate(prompts, tm, sp, JGenerateConfig(**gen))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    assert "lora" in tp["llm"]["layers"]
    teng = TEngine(tp, cfg, tok, quantize=quantize)
    assert ("lora" in teng.params["llm"]["layers"]) == (quantize is None)
    teng.generate(prompts, tm, sp, TGenerateConfig(**gen))
    np.testing.assert_array_equal(teng.last_tokens[0].numpy(),
                                  captured["tokens"])
    return captured["tokens"]


def test_engine_serves_lora_tree_bf16_equal_to_jax(monkeypatch):
    """Unquantized serving of a LoRA tree (micro_vlm_config): the overlay
    runs in _dense, as in the JAX engine; the adapters change the tokens
    against the same tree without them."""
    cfg = micro_vlm_config("phi3.5")
    jp = jvlm.init_params(jax.random.key(3), cfg)
    tok = build_test_tokenizer("phi3.5")
    rng = np.random.default_rng(3)
    sp = rng.integers(0, 256, (cfg.num_segs, 336, 336, 3), dtype=np.uint8)
    tm = rng.integers(0, 256, (cfg.num_frames, 224, 224, 3), dtype=np.uint8)
    got = _engine_tokens_equal(monkeypatch, cfg, _with_lora(jp, cfg, 5), tok,
                               None, False, sp, tm)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    plain = TEngine(tp, cfg, tok)
    plain.generate(["<image>\nwhen does it happen?",
                    "describe <image> briefly please"], tm, sp,
                   TGenerateConfig(max_new_tokens=8, do_sample=False))
    assert not np.array_equal(plain.last_tokens[0].numpy(), got)


def test_engine_serves_lora_tree_int8_full_equal_to_jax(model, monkeypatch):
    """int8_full with the int8 cache on the widened micro LLM: both engines
    merge the adapters, then quantize; greedy tokens equal."""
    cfg, jp, _, _, tok, _, _, sp, tm = model
    _engine_tokens_equal(monkeypatch, cfg, _with_lora(jp, cfg, 6), tok,
                         "int8_full", True, sp[0], tm[0])
