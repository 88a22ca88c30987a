"""Prefix-KV serving in the port against the JAX package on the CPU:
build_prefix_kv, llm.prefill_continue (bf16, int8 and shared-prefix caches),
quantize_kv_head_major, the cascade decode and verify (decode_step_shared,
verify_step_shared with commit_verify), generate_tokens_from_prefix,
generate_tokens_spec_from_prefix, the engine's run_stream_prefix, and the
LongRoPE hint the prefix and its continuation share.

Tolerances:
  * module parity on the fp32 micro model (the same bf16 prefix K/V given
    to both packages): rtol 2e-4 on logits; int8 cache values bit-equal
    after the layout transpose ([.., Hkv, Dh, S] in JAX, [.., Hkv, S, Dh]
    in the port), scales rtol 2e-4; valid masks and positions equal; the
    same for the cascade on that tree with weight-only int8 projections
    and lm_head (fp32 activations, so JAX's cascade runs on the CPU);
  * build_prefix_kv: one bf16 rounding (rtol 2**-7): both packages round
    fp32 k/v computed with sums in another order;
  * the int8_full tree (bf16 activations, W8A8) on the widened micro LLM:
    relative L2 3e-2 on logits, the bar of test_torch_int8_serving.py;
  * generation: greedy tokens exactly equal to JAX's and to the port's own
    full-prefill route, on the seeds of tests/test_prefix_cache.py.
"""

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
from grounded_video_llm_tpu.serve import speculative as jspec
from grounded_video_llm_tpu.text.templates import IMAGE_TOKEN_INDEX
from grounded_video_llm_tpu.text.tokenizer import build_test_tokenizer
from grounded_video_llm_tpu_torch.core.config import GenerateConfig as TGen
from grounded_video_llm_tpu_torch.models import llm as tllm
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.serve import engine as tengine
from grounded_video_llm_tpu_torch.serve import generate as tgen
from grounded_video_llm_tpu_torch.serve import speculative as tspec

EOS, PAD = 2, 0
MAX_NEW = 5
RTOL = 2e-4
LOGITS_REL_L2 = 3e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _ceil128(n):
    return -(-n // 128) * 128


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def micro():
    cfg = micro_vlm_config("phi3.5")
    jp = jvlm.init_params(jax.random.key(0), cfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, tp


def _inputs(cfg, B, pre_len=3, q_lens=(4, 4, 4), seed=0):
    """tests/test_prefix_cache.py's inputs: a shared pre-image prefix and
    per-row questions → the full left-padded prompt, and its split."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(3, 50, size=(pre_len,)).astype(np.int32)
    qs = [rng.integers(3, 50, size=(n,)).astype(np.int32) for n in q_lens]
    Sq = max(q_lens)
    S = pre_len + 1 + Sq
    ids = np.full((B, S), PAD, np.int32)
    mask = np.zeros((B, S), np.int32)
    post_ids = np.full((B, Sq), PAD, np.int32)
    post_mask = np.zeros((B, Sq), np.int32)
    for b, q in enumerate(qs):
        row = np.concatenate([pre, [IMAGE_TOKEN_INDEX], q])
        ids[b, S - len(row):] = row
        mask[b, S - len(row):] = 1
        post_ids[b, Sq - len(q):] = q
        post_mask[b, Sq - len(q):] = 1
    feats = (rng.normal(size=(1, cfg.num_video_tokens, cfg.llm.hidden_size))
             * 0.05).astype(np.float32)
    return ids, mask, pre[None], post_ids, post_mask, feats


def _prefixes(cfg, jp, tp, pre_ids, feats, hint):
    jk, jv, jm = jgen.build_prefix_kv(
        jp, cfg, jnp.asarray(pre_ids), jnp.ones_like(jnp.asarray(pre_ids)),
        jnp.asarray(feats), hint)
    tk, tv, tm = tgen.build_prefix_kv(
        tp, cfg, _t(pre_ids).long(), torch.ones(pre_ids.shape,
                                                 dtype=torch.long),
        _t(feats), hint)
    return (jk, jv, jm), (tk, tv, tm)


def _run_both(cfg, jp, tp, q_lens, quantize_cache, seed=0,
              shared_prefix=False):
    """Greedy tokens of the full-prefill route and of the prefix route, in
    both packages: (jax full, jax prefix, port full, port prefix)."""
    B = len(q_lens)
    ids, mask, pre_ids, post_ids, post_mask, feats = _inputs(
        cfg, B, q_lens=q_lens, seed=seed)
    kw = dict(max_new_tokens=MAX_NEW, temperature=0.0, do_sample=False,
              eos_token_id=EOS, pad_token_id=PAD,
              quantize_cache=quantize_cache)
    fb = np.broadcast_to(feats, (B, *feats.shape[1:]))
    j_full = jgen.generate_tokens_from_features(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(fb),
        jax.random.key(0), **kw)
    t_full = tgen.generate_tokens_from_features(
        tp, cfg, _t(ids).long(), _t(mask).long(), _t(fb), None, **kw)
    Sp = pre_ids.shape[1] + cfg.num_video_tokens
    hint = _ceil128(Sp + post_ids.shape[1] + MAX_NEW)
    (jk, jv, jm), (tk, tv, tm) = _prefixes(cfg, jp, tp, pre_ids, feats, hint)
    j_pre = jgen.generate_tokens_from_prefix(
        jp, cfg, jnp.asarray(post_ids), jnp.asarray(post_mask), jk, jv, jm,
        jax.random.key(0), shared_prefix=shared_prefix, **kw)
    timings = {}
    t_pre = tgen.generate_tokens_from_prefix(
        tp, cfg, _t(post_ids).long(), _t(post_mask).long(), tk, tv, tm,
        None, shared_prefix=shared_prefix, timings=timings, **kw)
    assert set(timings) == {"prefill", "decode", "decode_steps"}
    return [tuple(np.asarray(x) for x in r) for r in
            (j_full, j_pre, (t_full[0].numpy(), t_full[1].numpy()),
             (t_pre[0].numpy(), t_pre[1].numpy()))]


def _all_equal(runs):
    for tokens, lengths in runs[1:]:
        np.testing.assert_array_equal(tokens, runs[0][0])
        np.testing.assert_array_equal(lengths, runs[0][1])


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_build_prefix_kv_matches_jax(micro):
    cfg, jp, tp = micro
    _, _, pre_ids, _, _, feats = _inputs(cfg, 3)
    (jk, jv, jm), (tk, tv, tm) = _prefixes(cfg, jp, tp, pre_ids, feats, 512)
    Sp = pre_ids.shape[1] + cfg.num_video_tokens
    assert tk.dtype == torch.bfloat16
    assert tuple(tk.shape) == (cfg.llm.num_layers, 1, Sp,
                               cfg.llm.num_kv_heads, cfg.llm.head_dim)
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32),
                                   rtol=2 ** -7, atol=1e-6)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_quantize_kv_head_major_matches_jax():
    rng = np.random.default_rng(1)
    kv = jnp.asarray(rng.normal(size=(2, 3, 5, 4, 16)), jnp.bfloat16)
    jq8, jsc = jllm.quantize_kv_head_major(kv, 8)
    tq8, tsc = tllm.quantize_kv_head_major(
        _t(np.asarray(kv, np.float32)).to(torch.bfloat16), 8)
    assert tq8.dtype == torch.int8 and tuple(tq8.shape) == (2, 3, 4, 8, 16)
    np.testing.assert_array_equal(tq8.numpy(),
                                  np.asarray(jq8).transpose(0, 1, 2, 4, 3))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc)[:, :, :, 0],
                               rtol=RTOL)
    assert (tq8[..., 5:, :] == 0).all() and (tsc[..., 5:] == 1).all()


def _continue_inputs(cfg, jp, q_lens=(2, 5, 3), seed=3, sliding_window=None):
    """The same bf16 prefix K/V (JAX's) and question chunk for both
    packages."""
    if sliding_window is not None:
        cfg = replace(cfg, llm=replace(cfg.llm,
                                       sliding_window=sliding_window))
    B = len(q_lens)
    _, _, pre_ids, post_ids, post_mask, feats = _inputs(cfg, B, q_lens=q_lens,
                                                        seed=seed)
    Sp = pre_ids.shape[1] + cfg.num_video_tokens
    max_len = _ceil128(Sp + post_ids.shape[1] + MAX_NEW)
    jk, jv, jm = jgen.build_prefix_kv(
        jp, cfg, jnp.asarray(pre_ids), jnp.ones_like(jnp.asarray(pre_ids)),
        jnp.asarray(feats), max_len)

    def bf16(a):
        return _t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    return (cfg, post_ids, post_mask, max_len, (jk, jv, jm),
            (bf16(jk), bf16(jv), _t(jm)))


def _continue(cfg, jp, tp, post_ids, post_mask, max_len, jpre, tpre, **kw):
    jl = jp["embed"]
    jemb = jllm.embed_lookup(jl, jnp.asarray(post_ids), jllm.embed_dtype(jl))
    j = jllm.prefill_continue(jp, cfg.llm, jemb, jnp.asarray(post_mask),
                              *jpre, max_len, **kw)
    with torch.inference_mode():
        temb = tllm.embed_lookup(tp["embed"], _t(post_ids).long(),
                                 tllm.embed_dtype(tp["embed"]))
        t = tllm.prefill_continue(tp, cfg.llm, temb, _t(post_mask).long(),
                                  *tpre, max_len, **kw)
    return j, t


def _assert_quant_cache_equal(tc, jc, rtol=RTOL):
    for tv, ts, jv, js in ((tc.k, tc.k_scale, jc.k, jc.k_scale),
                           (tc.v, tc.v_scale, jc.v, jc.v_scale)):
        np.testing.assert_array_equal(tv.numpy(),
                                      np.asarray(jv).transpose(0, 1, 2, 4, 3))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js)[:, :, :, 0],
                                   rtol=rtol)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


@pytest.mark.parametrize("kind", ["bf16", "int8", "shared"])
def test_prefill_continue_matches_jax(micro, kind):
    cfg, jp, tp = micro
    cfg, post_ids, post_mask, max_len, jpre, tpre = _continue_inputs(cfg, jp)
    kw = dict(quantize_cache=kind != "bf16",
              tail_len=128 if kind == "shared" else None)
    (jl, jc, jvalid, jpos), (tl, tc, tvalid, tpos) = _continue(
        cfg, jp["llm"], tp["llm"], post_ids, post_mask, max_len, jpre, tpre,
        **kw)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    if kind == "bf16":
        assert isinstance(tc, tllm.KVCache) and tc.max_len == max_len
        for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                       atol=1e-6)
    elif kind == "int8":
        assert isinstance(tc, tllm.QuantKVCache) and tc.max_len == max_len
        _assert_quant_cache_equal(tc, jc)
    else:
        assert isinstance(tc, tllm.SharedPrefixCache)
        _assert_quant_cache_equal(tc.tail, jc.tail)
        np.testing.assert_array_equal(tc.pk.numpy(),
                                      np.asarray(jc.pk).transpose(0, 1, 2, 4, 3))
        np.testing.assert_array_equal(tc.pv.numpy(),
                                      np.asarray(jc.pv).transpose(0, 1, 2, 4, 3))
        for t, j in ((tc.pk_scale, jc.pk_scale), (tc.pv_scale, jc.pv_scale)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j)[:, :, :, 0],
                                       rtol=RTOL)
        np.testing.assert_array_equal(tc.prefix_mask.numpy(),
                                      np.asarray(jc.prefix_mask))


def test_prefill_continue_refusals(micro):
    cfg, jp, tp = micro
    cfg, post_ids, post_mask, max_len, _, (tk, tv, tm) = _continue_inputs(
        cfg, jp)
    emb = tllm.embed_lookup(tp["llm"]["embed"], _t(post_ids).long(),
                            torch.float32)
    args = (tp["llm"], cfg.llm, emb, _t(post_mask).long())
    with pytest.raises(NotImplementedError):
        tllm.prefill_continue(*args, tk, tv, tm, max_len,
                              quantize_cache=False, tail_len=128)
    with pytest.raises(NotImplementedError):      # Bp != 1
        tllm.prefill_continue(*args, tk.expand(-1, 3, -1, -1, -1),
                              tv.expand(-1, 3, -1, -1, -1),
                              tm.expand(3, -1), max_len, tail_len=128)


def _cascade_steps(cfg, jl_params, tl_params, jpre, tpre, post_ids, post_mask,
                   max_len, S_v=3):
    """prefill_continue into the shared cache, one decode_step_shared, one
    verify_step_shared of S_v candidates and a commit_verify on the tail, in
    both packages → the per-stage (jax, port) pairs."""
    (jl, jc, jv, jpos), (tl, tc, tv, tpos) = _continue(
        cfg, jl_params, tl_params, post_ids, post_mask, max_len, jpre, tpre,
        quantize_cache=True, tail_len=128)
    cur = np.asarray(jnp.argmax(jl, -1), np.int64)
    je = jllm.embed_lookup(jl_params["embed"], jnp.asarray(cur))[:, None]
    jl2, jc2, jv2 = jllm.decode_step_shared(jl_params, cfg.llm, je, jc, jv,
                                            jpos, rope_hint=max_len)
    toks = np.random.default_rng(8).integers(3, 50, size=(len(cur), S_v))
    positions = np.asarray(jpos)[:, None] + 1 + np.arange(S_v)[None]
    jl3, jc3 = jllm.verify_step_shared(
        jl_params, cfg.llm, jllm.embed_lookup(jl_params["embed"],
                                              jnp.asarray(toks)),
        jc2, jv2, jnp.asarray(positions), rope_hint=max_len)
    n_accept = np.array([1, S_v, 2], np.int32)
    jtail, jv3 = jllm.commit_verify(jc3.tail, jv2, jnp.asarray(n_accept), S_v)
    with torch.inference_mode():
        te = tllm.embed_lookup(tl_params["embed"], _t(cur))[:, None]
        tl2, tc2, tv2 = tllm.decode_step_shared(tl_params, cfg.llm, te, tc,
                                                tv, tpos, rope_hint=max_len)
        # the port writes the tail in place: keep this step's copy
        tail2 = tllm.QuantKVCache(*(x.clone() for x in tc2.tail))
        tl3, tc3 = tllm.verify_step_shared(
            tl_params, cfg.llm, tllm.embed_lookup(tl_params["embed"],
                                                  _t(toks)),
            tc2, tv2, _t(positions), rope_hint=max_len)
        ttail, tv3 = tllm.commit_verify(tc3.tail, tv2, _t(n_accept), S_v)
    return dict(prefill=(jl, tl), decode=(jl2, tl2), verify=(jl3, tl3),
                decode_valid=(jv2, tv2), commit_valid=(jv3, tv3),
                tail_after_decode=(jc2.tail, tail2),
                tail_after_verify=(jtail, ttail))


def _assert_cascade_matches(out):
    for stage in ("prefill", "decode", "verify"):
        j, t = out[stage]
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=1e-5, err_msg=stage)
    for stage in ("decode_valid", "commit_valid"):
        j, t = out[stage]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for stage in ("tail_after_decode", "tail_after_verify"):
        _assert_quant_cache_equal(out[stage][1], out[stage][0])


def test_cascade_decode_and_verify_match_jax_fp32(micro):
    cfg, jp, tp = micro
    cfg, post_ids, post_mask, max_len, jpre, tpre = _continue_inputs(cfg, jp)
    _assert_cascade_matches(_cascade_steps(cfg, jp["llm"], tp["llm"], jpre,
                                           tpre, post_ids, post_mask,
                                           max_len))


def test_cascade_decode_and_verify_weight_only_int8_match_jax(micro):
    """The fp32 micro tree with weight-only int8 projections and lm_head
    (the embedding kept fp32, so activations stay fp32): JAX's own cascade
    runs on the CPU, and the port's int8 branch of the cascade's dense
    layers is held to it at the fp32 tolerances."""
    cfg, jp, _ = micro
    jq_tree = dict(jp, llm=dict(jq.quantize_llm_for_serving(jp["llm"]),
                                embed=jp["llm"]["embed"]))
    tq_tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jq_tree),
                              cfg, "cpu")
    assert not tq_tree["llm"]["layers"]["qkv_kernel"].w8a8
    cfg, post_ids, post_mask, max_len, jpre, tpre = _continue_inputs(cfg,
                                                                     jq_tree)
    _assert_cascade_matches(_cascade_steps(cfg, jq_tree["llm"],
                                           tq_tree["llm"], jpre, tpre,
                                           post_ids, post_mask, max_len))


@pytest.fixture(scope="module")
def wide_int8():
    """The widened micro LLM of test_torch_int8_serving.py, int8_full."""
    cfg = micro_vlm_config("phi3.5")
    cfg = replace(cfg, llm=replace(cfg.llm, hidden_size=512,
                                   intermediate_size=512, num_heads=8,
                                   num_kv_heads=8, head_dim=64))
    full = jvlm.init_params(jax.random.key(2), cfg)
    full["llm"] = jq.quantize_llm_for_serving(full["llm"], w8a8=True)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, full), cfg,
                         "cpu")
    return cfg, full, tp


def test_cascade_decode_and_verify_int8_full_match_jax(wide_int8):
    """The int8_full tree runs in bf16 activations, and XLA's CPU runtime
    has no bf16 x bf16 -> fp32 product for JAX's cascade attention, so the
    port's cascade (build_prefix_kv, prefill_continue into the shared
    cache, decode_step_shared, verify_step_shared, commit on the tail) is
    held to JAX's single-cache route over the same full prompt [pre-image
    text | video | question] (uniform questions: no pad slot): prefill,
    decode_step and verify_step logits, the written k/v and the valid
    slots."""
    cfg, jp, tp = wide_int8
    jl, tl = jp["llm"], tp["llm"]
    assert tl["layers"]["qkv_kernel"].w8a8
    B, S_v = 3, 3
    _, _, pre_ids, post_ids, post_mask, feats = _inputs(cfg, B, seed=4)
    Sp = pre_ids.shape[1] + cfg.num_video_tokens
    Sq = post_ids.shape[1]
    S = Sp + Sq
    max_len = _ceil128(S + MAX_NEW)
    # JAX: the whole prompt through prefill, decode_step, verify_step
    jdt = jnp.bfloat16
    emb = jnp.concatenate(
        [jnp.broadcast_to(jllm.embed_lookup(jl["embed"],
                                            jnp.asarray(pre_ids[0]), jdt),
                          (B, pre_ids.shape[1], cfg.llm.hidden_size)),
         jnp.broadcast_to(jnp.asarray(feats, jdt), (B, *feats.shape[1:])),
         jllm.embed_lookup(jl["embed"], jnp.asarray(post_ids), jdt)], axis=1)
    jlog, jc = jllm.prefill(jl, cfg.llm, emb, jnp.ones((B, S), jnp.int32),
                            jllm.KVCache.create(cfg.llm, B, max_len),
                            quantize_cache=True)
    valid = np.zeros((B, max_len), bool)
    valid[:, :S] = True
    cur = np.asarray(jnp.argmax(jlog, -1), np.int64)
    pos = np.full((B,), S, np.int32)
    jlog2, jc2, jv2 = jllm.decode_step(
        jl, cfg.llm, jllm.embed_lookup(jl["embed"], jnp.asarray(cur))[:, None],
        jc, jnp.asarray(valid), jnp.asarray(pos))
    toks = np.random.default_rng(8).integers(3, 50, size=(B, S_v))
    positions = pos[:, None] + 1 + np.arange(S_v)[None]
    jlog3, jc3 = jllm.verify_step(
        jl, cfg.llm, jllm.embed_lookup(jl["embed"], jnp.asarray(toks)), jc2,
        jv2, jnp.asarray(positions))
    n_accept = np.array([1, S_v, 2], np.int32)
    _, jv3 = jllm.commit_verify(jc3, jv2, jnp.asarray(n_accept), S_v)
    # the port: the prefix once, then the cascade
    tk, tv, tm = tgen.build_prefix_kv(
        tp, cfg, _t(pre_ids).long(), torch.ones(pre_ids.shape,
                                                 dtype=torch.long),
        _t(feats).to(torch.bfloat16), max_len)
    with torch.inference_mode():
        temb = tllm.embed_lookup(tl["embed"], _t(post_ids).long())
        tlog, tc, tval, tpos = tllm.prefill_continue(
            tl, cfg.llm, temb, _t(post_mask).long(), tk, tv, tm, max_len,
            tail_len=128)
        tlog2, tc2, tval2 = tllm.decode_step_shared(
            tl, cfg.llm, tllm.embed_lookup(tl["embed"], _t(cur))[:, None],
            tc, tval, tpos, rope_hint=max_len)
        tlog3, tc3 = tllm.verify_step_shared(
            tl, cfg.llm, tllm.embed_lookup(tl["embed"], _t(toks)), tc2,
            tval2, _t(positions), rope_hint=max_len)
        ttail, tval3 = tllm.commit_verify(tc3.tail, tval2, _t(n_accept), S_v)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    for stage, t, j in (("prefill", tlog, jlog), ("decode", tlog2, jlog2),
                        ("verify", tlog3, jlog3)):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        assert _rel_l2(t.numpy(), j) <= LOGITS_REL_L2, stage
    # the tail's slots Sq.. are the single cache's S..: validity and the
    # k/v written there (dequantized), at the same bf16-level bar
    np.testing.assert_array_equal(tval3.numpy()[:, :Sq + 1 + S_v],
                                  np.asarray(jv3)[:, Sp:S + 1 + S_v])
    np.testing.assert_array_equal(ttail.length.numpy(), Sq + 1 + n_accept)
    for tq, ts, jqv, jsc in ((ttail.k, ttail.k_scale, jc3.k, jc3.k_scale),
                             (ttail.v, ttail.v_scale, jc3.v, jc3.v_scale)):
        got = (tq.double() * ts.double()[..., None])[:, :, :, :Sq + 1 + S_v]
        want = (np.asarray(jqv, np.float64) * np.asarray(jsc, np.float64)
                ).transpose(0, 1, 2, 4, 3)[:, :, :, Sp:S + 1 + S_v]
        assert _rel_l2(got.numpy(), want) <= LOGITS_REL_L2


# ---------------------------------------------------------------------------
# generation: the mirrors of tests/test_prefix_cache.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize_cache", [True, False])
def test_prefix_generation_matches_full_prefill(micro, quantize_cache):
    cfg, jp, tp = micro
    _all_equal(_run_both(cfg, jp, tp, (4, 4, 4), quantize_cache))


def test_prefix_generation_ragged_questions(micro):
    cfg, jp, tp = micro
    _all_equal(_run_both(cfg, jp, tp, (2, 5, 3), True, seed=3))


def test_shared_prefix_decode_matches_full_prefill(micro):
    cfg, jp, tp = micro
    _all_equal(_run_both(cfg, jp, tp, (2, 5, 3), True, seed=11,
                         shared_prefix=True))


def test_prefix_generation_with_sliding_window(micro):
    cfg, jp, tp = micro
    cfg_sw = replace(cfg, llm=replace(cfg.llm, sliding_window=4))
    _all_equal(_run_both(cfg_sw, jp, tp, (2, 5, 3), True, seed=9))


def test_shared_prefix_decode_with_sliding_window(micro):
    """The JAX test's teacher-forced contract (a window of 4 leaves top-2
    margins near 3e-4, so free-running tokens may flip on a sum order):
    the cascade's step logits within atol 2e-2 of the single cache's, in
    the port, and both within rtol 2e-4 of JAX's."""
    cfg, jp, tp = micro
    cfg, post_ids, post_mask, max_len, jpre, tpre = _continue_inputs(
        cfg, jp, q_lens=(3, 4, 2), seed=13, sliding_window=4)
    lj, lt = jp["llm"], tp["llm"]
    (j1, jc1, jv1, jp1), (t1, tc1, tv1, tp1) = _continue(
        cfg, lj, lt, post_ids, post_mask, max_len, jpre, tpre,
        quantize_cache=True)
    (j2, jc2, jv2, jp2), (t2, tc2, tv2, tp2) = _continue(
        cfg, lj, lt, post_ids, post_mask, max_len, jpre, tpre,
        quantize_cache=True, tail_len=_ceil128(post_ids.shape[1] + MAX_NEW))
    np.testing.assert_array_equal(t1.numpy(), t2.numpy())
    cur = np.asarray(jnp.argmax(j1, -1), np.int64)
    j_step = jax.jit(jllm.decode_step, static_argnums=1)
    j_shared = jax.jit(jllm.decode_step_shared, static_argnums=1,
                       static_argnames="rope_hint")
    for _ in range(4):
        je = jllm.embed_lookup(lj["embed"], jnp.asarray(cur))[:, None]
        j1, jc1, jv1 = j_step(lj, cfg.llm, je, jc1, jv1, jp1)
        j2, jc2, jv2 = j_shared(lj, cfg.llm, je, jc2, jv2, jp2,
                                rope_hint=max_len)
        with torch.inference_mode():
            te = tllm.embed_lookup(lt["embed"], _t(cur))[:, None]
            t1, tc1, tv1 = tllm.decode_step(lt, cfg.llm, te, tc1, tv1, tp1)
            t2, tc2, tv2 = tllm.decode_step_shared(lt, cfg.llm, te, tc2, tv2,
                                                   tp2, rope_hint=max_len)
        np.testing.assert_allclose(t1.numpy(), t2.numpy(), atol=2e-2, rtol=0)
        for t, j in ((t1, j1), (t2, j2)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                       atol=1e-5)
        jp1, jp2, tp1, tp2 = jp1 + 1, jp2 + 1, tp1 + 1, tp2 + 1
        cur = np.asarray(jnp.argmax(j1, -1), np.int64)


def test_prefix_kv_is_shared_across_batches(micro):
    """One prefix serves two batches: the second call gives the first's
    tokens, and the prefix buffers are not written."""
    cfg, jp, tp = micro
    _, _, pre_ids, post_ids, post_mask, feats = _inputs(cfg, 3, seed=5)
    Sp = pre_ids.shape[1] + cfg.num_video_tokens
    hint = _ceil128(Sp + post_ids.shape[1] + MAX_NEW)
    (jk, jv, jm), (tk, tv, tm) = _prefixes(cfg, jp, tp, pre_ids, feats, hint)
    kw = dict(max_new_tokens=MAX_NEW, temperature=0.0, do_sample=False,
              eos_token_id=EOS, pad_token_id=PAD, quantize_cache=True)
    want, _ = jgen.generate_tokens_from_prefix(
        jp, cfg, jnp.asarray(post_ids), jnp.asarray(post_mask), jk, jv, jm,
        jax.random.key(0), **kw)
    before = (tk.clone(), tv.clone())
    for shared in (False, True):
        for _ in range(2):
            got, _ = tgen.generate_tokens_from_prefix(
                tp, cfg, _t(post_ids).long(), _t(post_mask).long(), tk, tv,
                tm, None, shared_prefix=shared, **kw)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(tk, before[0]) and torch.equal(tv, before[1])


def test_spec_from_prefix_matches_greedy_lockstep(micro):
    cfg, jp, tp = micro
    ids, mask, pre_ids, post_ids, post_mask, feats = _inputs(
        cfg, 3, q_lens=(4, 4, 4), seed=2)
    kw = dict(max_new_tokens=MAX_NEW, temperature=0.0, do_sample=False,
              eos_token_id=EOS, pad_token_id=PAD)
    fb = np.broadcast_to(feats, (3, *feats.shape[1:]))
    ref, ref_len = jgen.generate_tokens_from_features(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(fb),
        jax.random.key(0), quantize_cache=True, **kw)
    t_ref, t_ref_len = tgen.generate_tokens_from_features(
        tp, cfg, _t(ids).long(), _t(mask).long(), _t(fb), None,
        quantize_cache=True, **kw)
    Sp = pre_ids.shape[1] + cfg.num_video_tokens
    S_v = 3
    hint = _ceil128(Sp + post_ids.shape[1] + MAX_NEW + S_v)
    (jk, jv, jm), (tk, tv, tm) = _prefixes(cfg, jp, tp, pre_ids, feats, hint)
    jgot, jlen = jspec.generate_tokens_spec_from_prefix(
        jp, cfg, jnp.asarray(post_ids), jnp.asarray(post_mask), jk, jv, jm,
        jax.random.key(0), draft_len=S_v - 1, **kw)
    timings = {}
    got, got_len, passes = tspec.generate_tokens_spec_from_prefix(
        tp, cfg, _t(post_ids).long(), _t(post_mask).long(), tk, tv, tm, None,
        draft_len=S_v - 1, with_stats=True, timings=timings, **kw)
    for tokens, lengths in ((jgot, jlen), (t_ref, t_ref_len),
                            (got, got_len)):
        np.testing.assert_array_equal(np.asarray(tokens), np.asarray(ref))
        np.testing.assert_array_equal(np.asarray(lengths),
                                      np.asarray(ref_len))
    assert timings["verify_passes"] == passes and 2 <= passes <= MAX_NEW - 1
    assert set(timings) == {"prefill", "decode", "verify_passes"}


def test_from_prefix_refuses_a_cascade_without_the_int8_cache(micro):
    cfg, jp, tp = micro
    _, _, pre_ids, post_ids, post_mask, feats = _inputs(cfg, 3)
    _, (tk, tv, tm) = _prefixes(cfg, jp, tp, pre_ids, feats, 512)
    args = (tp, cfg, _t(post_ids).long(), _t(post_mask).long(), tk, tv, tm,
            None)
    with pytest.raises(ValueError, match="quantize_cache"):
        tgen.generate_tokens_from_prefix(*args, max_new_tokens=MAX_NEW,
                                         shared_prefix=True)
    with pytest.raises(ValueError, match="rope_hint"):
        tgen.generate_tokens_from_prefix(*args, max_new_tokens=MAX_NEW,
                                         rope_hint=128)


# ---------------------------------------------------------------------------
# the LongRoPE hint at the factor switch
# ---------------------------------------------------------------------------


def test_rope_hint_at_the_factor_switch(micro):
    """JAX's run_stream_prefix builds the prefix with ceil128(Sp +
    question_len + max_new) while generate_tokens_spec_from_prefix runs the
    continuation at ceil128(Sp + Sq + max_new + S_v): where the two straddle
    original_max_position_embeddings, the prefix keys carry the short
    LongRoPE factors and the continuation the long ones (a fault of the
    reference, ROADMAP "Known faults in the reference"). The port's engine
    builds the prefix and runs the continuation with one hint, and its
    speculative prefix route gives the tokens of the full-prefill
    speculative route, in both packages, at that edge."""
    cfg0, jp, tp = micro
    half = cfg0.llm.head_dim // 2
    cfg = replace(cfg0, llm=replace(
        cfg0.llm, original_max_position_embeddings=512,
        rope_scaling_short=(1.0,) * half,
        rope_scaling_long=tuple(np.linspace(1.5, 8.0, half).tolist())))
    q_len, S_v = 4, 3
    pre_len = 512 - cfg.num_video_tokens - q_len - MAX_NEW
    ids, mask, pre_ids, post_ids, post_mask, feats = _inputs(
        cfg, 3, pre_len=pre_len, q_lens=(q_len,) * 3, seed=2)
    Sp = pre_len + cfg.num_video_tokens
    engine_hint = _ceil128(Sp + q_len + MAX_NEW)           # JAX engine's
    spec_hint = _ceil128(Sp + q_len + MAX_NEW + S_v)       # JAX spec's
    orig = cfg.llm.original_max_position_embeddings
    assert engine_hint <= orig < spec_hint

    # the reference: the two hints pick different factor sets, and a prefix
    # built with the engine's hint moves the continuation's logits
    (jk_e, jv_e, jm), _ = _prefixes(cfg, jp, tp, pre_ids, feats, engine_hint)
    (jk_s, jv_s, _), (tk, tv, tm) = _prefixes(cfg, jp, tp, pre_ids, feats,
                                              spec_hint)
    assert np.abs(np.asarray(jk_e, np.float32)
                  - np.asarray(jk_s, np.float32)).max() > 1e-2
    lj = jp["llm"]
    emb = jllm.embed_lookup(lj["embed"], jnp.asarray(post_ids),
                            jllm.embed_dtype(lj["embed"]))
    logits = [np.asarray(jllm.prefill_continue(
        lj, cfg.llm, emb, jnp.asarray(post_mask), k, v, jm, spec_hint,
        quantize_cache=True, tail_len=128)[0]) for k, v in
        ((jk_e, jv_e), (jk_s, jv_s))]
    assert _rel_l2(logits[0], logits[1]) > 1e-3

    # the port: one hint through the engine's route, tokens of the full route
    kw = dict(max_new_tokens=MAX_NEW, temperature=0.0, do_sample=False,
              eos_token_id=EOS, pad_token_id=PAD, draft_len=S_v - 1)
    fb = np.broadcast_to(feats, (3, *feats.shape[1:]))
    ref, ref_len = jspec.generate_tokens_spec_from_features(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(fb),
        jax.random.key(0), **kw)
    t_full = tspec.generate_tokens_spec_from_features(
        tp, cfg, _t(ids).long(), _t(mask).long(), _t(fb), None, **kw)
    t_pre = tspec.generate_tokens_spec_from_prefix(
        tp, cfg, _t(post_ids).long(), _t(post_mask).long(), tk, tv, tm, None,
        rope_hint=spec_hint, **kw)
    for tokens, lengths in (t_full, t_pre):
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))

    # the engines, on a config whose edge falls at the engine's own prompt
    # length: JAX's builds the prefix and runs the continuation with the two
    # hints; the port's passes one hint to both programs
    tok = build_test_tokenizer("phi3.5")
    seq = tengine.InferenceEngine(tp, cfg, tok).tokenize_prompt(
        tengine.InferenceEngine(tp, cfg, tok).build_prompt("when?", "qa",
                                                            10.0))
    img = seq.index(IMAGE_TOKEN_INDEX)
    Sp_e, post = img + cfg.num_video_tokens, len(seq) - img - 1
    question_len = post + (-(Sp_e + post + MAX_NEW)) % 128
    edge = Sp_e + question_len + MAX_NEW
    cfg_e = replace(cfg, llm=replace(cfg.llm,
                                     original_max_position_embeddings=edge))
    jeng = jengine.InferenceEngine(jp, cfg_e, tok)
    teng = tengine.InferenceEngine(tp, cfg_e, tok)
    seen = {"jax": [], "port": []}

    def spy(name, fn, label, pick):
        def wrapped(*a, **k):
            seen[name].append((label, pick(a, k)))
            return fn(*a, **k)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgen, "build_prefix_kv", spy(
            "jax", jgen.build_prefix_kv, "prefix", lambda a, k: a[-1]))
        mp.setattr(jllm, "prefill_continue", spy(
            "jax", jllm.prefill_continue, "continuation", lambda a, k: a[7]))
        mp.setattr(tengine, "build_prefix_kv", spy(
            "port", tengine.build_prefix_kv, "prefix", lambda a, k: a[-1]))
        mp.setattr(tengine, "generate_tokens_spec_from_prefix", spy(
            "port", tengine.generate_tokens_spec_from_prefix,
            "continuation", lambda a, k: k["rope_hint"]))
        for eng, gen, f in ((jeng, JGen, feats[0]),
                            (teng, TGen, torch.from_numpy(feats[0]))):
            # no decoder: the video's features stand in for the cache
            eng.preprocess_video = lambda path: None
            eng.encode_video_cached = (lambda path, prepped=None, f=f, **k:
                                       (f, 10.0))
            eng.run_stream_prefix(
                ["v.mp4"], ["when?"], mode="qa", batch_size=1,
                question_len=question_len,
                gen_cfg=gen(max_new_tokens=MAX_NEW, do_sample=False,
                            spec_draft_len=S_v - 1))
    assert seen["jax"] == [("prefix", edge), ("continuation", edge + 128)]
    assert seen["port"] == [("prefix", edge + 128),
                            ("continuation", edge + 128)]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_videos(tmp_path_factory):
    """tests/test_prefix_cache.py's two videos (distinct durations)."""
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("vids")
    paths = []
    for v, n_frames in enumerate((20, 30)):
        p = str(d / f"v{v}.mp4")
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 64))
        for i in range(n_frames):
            f = np.zeros((64, 64, 3), np.uint8)
            f[:] = (10 + 60 * v, 20 + 5 * (i % 8), 200 - 60 * v)
            w.write(f)
        w.release()
        paths.append(p)
    return paths


def _engines(micro, gen_kw):
    cfg, jp, tp = micro
    tok = build_test_tokenizer("phi3.5")
    jeng = jengine.InferenceEngine(jp, cfg, tok, gen_cfg=JGen(**gen_kw),
                                   feature_cache_size=4)
    teng = tengine.InferenceEngine(tp, cfg, tok, gen_cfg=TGen(**gen_kw),
                                   feature_cache_size=4)
    calls = []
    orig = teng.encode_features
    teng.encode_features = lambda t, s: (calls.append(1), orig(t, s))[1]
    return jeng, teng, calls


@pytest.mark.parametrize("mode", ["qa", "grounding"])
def test_run_stream_prefix_matches_cached(micro, two_videos, mode):
    """run_stream_prefix (one encode and one prefix per video) gives
    run_stream_cached's greedy texts, and JAX's run_stream_prefix's, in
    input order."""
    v0, v1 = two_videos
    paths = [v0, v1, v0, v1, v0]
    prompts = [f"what happens in query {i}?" for i in range(len(paths))]
    gen_kw = dict(max_new_tokens=4, do_sample=False, temperature=0.0)
    jeng, teng, calls = _engines(micro, gen_kw)
    base = teng.run_stream_cached(paths, prompts, mode=mode, batch_size=2)
    calls.clear()
    out = teng.run_stream_prefix(paths, prompts, mode=mode, batch_size=2,
                                 question_len=32)
    assert calls == []           # the features came from the cache
    t = teng.last_timings
    assert t["prefixes"] == 2 and "encodes" not in t
    assert set(t) >= {"prefix", "prefill", "decode", "decode_steps"}
    want = jeng.run_stream_prefix(paths, prompts, mode=mode, batch_size=2,
                                  question_len=32)
    assert [r.text for r in out] == [r.text for r in base]
    assert [r.text for r in out] == [r.text for r in want]
    assert [r.duration for r in out] == [r.duration for r in want]
    tokens, lengths = teng.last_tokens
    assert tuple(tokens.shape) == (5, 4) and tuple(lengths.shape) == (5,)


def test_run_stream_prefix_shared_route(micro, two_videos):
    """quantize_cache runs the prefix route through the cascade; greedy
    texts equal run_stream_cached's and JAX's, and the tokens equal the
    cached route's row by row."""
    v0, v1 = two_videos
    paths = [v0, v0, v1, v0]
    prompts = [f"query {i}?" for i in range(len(paths))]
    gen_kw = dict(max_new_tokens=4, do_sample=False, temperature=0.0,
                  quantize_cache=True)
    jeng, teng, calls = _engines(micro, gen_kw)
    out = teng.run_stream_prefix(paths, prompts, mode="qa", batch_size=2,
                                 question_len=32)
    assert len(calls) == 2 and teng.last_timings["encodes"] == 2
    prefix_tokens = teng.last_tokens
    base = teng.run_stream_cached(paths, prompts, mode="qa", batch_size=2)
    assert len(calls) == 2
    want = jeng.run_stream_prefix(paths, prompts, mode="qa", batch_size=2,
                                  question_len=32)
    assert [r.text for r in out] == [r.text for r in base]
    assert [r.text for r in out] == [r.text for r in want]
    for a, b in zip(prefix_tokens, teng.last_tokens):
        assert torch.equal(a, b)


def test_run_stream_prefix_spec_route_and_fallback(micro, two_videos):
    """spec_draft_len routes the prefix batches through
    generate_tokens_spec_from_prefix (texts equal to JAX's); a pre-image
    text that differs within a video's queries falls back to the feature
    route, as JAX's does."""
    v0, v1 = two_videos
    paths = [v0, v1, v0]
    prompts = ["a?", "b?", "c?"]
    gen_kw = dict(max_new_tokens=4, do_sample=False, temperature=0.0,
                  spec_draft_len=2)
    jeng, teng, _ = _engines(micro, gen_kw)
    out = teng.run_stream_prefix(paths, prompts, batch_size=2,
                                 question_len=32)
    assert teng.last_timings["verify_passes"] >= 2
    want = jeng.run_stream_prefix(paths, prompts, batch_size=2,
                                  question_len=32)
    assert [r.text for r in out] == [r.text for r in want]

    def differing(eng):
        real = eng.build_prompt
        eng.build_prompt = lambda p, m, d: ("x" + real(p, m, d)
                                            if p == "c?" else real(p, m, d))

    differing(teng)
    differing(jeng)
    out = teng.run_stream_prefix(paths, prompts, batch_size=2,
                                 question_len=32)
    assert teng.last_timings.get("prefixes", 0) == 1   # v1's only
    want = jeng.run_stream_prefix(paths, prompts, batch_size=2,
                                  question_len=32)
    assert [r.text for r in out] == [r.text for r in want]


def test_pad_bucket_matches_jax(micro):
    cfg, jp, tp = micro
    tok = build_test_tokenizer("phi3.5")
    jeng = jengine.InferenceEngine(jp, cfg, tok)
    teng = tengine.InferenceEngine(tp, cfg, tok)
    seqs = [[5, 6, 7], list(range(3, 40)), [9]]
    for n in (8, 40):
        for a, b in zip(teng._pad_bucket_batch(seqs, n),
                        jeng._pad_bucket_batch(seqs, n)):
            np.testing.assert_array_equal(a, b)
