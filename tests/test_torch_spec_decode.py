"""The speculative int8 serving slice of the port against the JAX package on
the CPU: K8 (verify_attention_int8) and K9 (scatter_write_multi) against the
JAX kernels in interpret mode, verify_step + commit_verify, the drafters,
the accept rule, speculative generation, the engine and the inference CLI.

Tolerances, by what the two sides share:
  * K8: the same roundings (bf16 q and new k/v, joint softmax normalised
    before the value sums, bf16 p * v_scale and bf16 p_new), fp32 sums in
    another order: rtol 2**-7, atol 1e-3, K4's bar (measured bit-equal on
    these inputs); at S = 1 against K4's plain version, whose roundings
    differ, the JAX test's own rtol 0.02, atol 0.01;
  * K9: bit-equal and in place;
  * verify_step logits, fp32 micro config: rtol 1e-4, atol 1e-5 (fp32 sums
    in another order; the int8 cache is bit-equal); the committed cache
    within one int8 step, the JAX test's bar (quantized k/v at a .5 tie);
  * verify_step logits and the candidates' written k/v, widened int8 micro
    LLM: relative L2 3e-2, the bar of test_torch_int8_serving.py (bf16
    activations, W8A8 rows);
  * drafters, greedy acceptance and greedy tokens: exactly equal;
  * sampled acceptance: on its own terms (the two packages' random streams
    differ): the law of the first emitted token over 40k rows within 0.012
    (about 4 sigma at the largest bin), as the JAX test checks its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_llm_tpu.core.config import micro_vlm_config, replace
from grounded_video_llm_tpu.models import llm as jllm
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.ops import cache_write as jcw
from grounded_video_llm_tpu.ops import decode_attention_int8 as jda
from grounded_video_llm_tpu.serve import quantize as jq
from grounded_video_llm_tpu.serve import speculative as jspec
from grounded_video_llm_tpu.text.templates import IMAGE_TOKEN_INDEX
from grounded_video_llm_tpu.text.tokenizer import build_test_tokenizer
from grounded_video_llm_tpu_torch.core.config import GenerateConfig
from grounded_video_llm_tpu_torch.models import llm as tllm
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.ops import cache_write as tcw
from grounded_video_llm_tpu_torch.ops import decode_attention_int8 as tda
from grounded_video_llm_tpu_torch.serve import speculative as tspec
from grounded_video_llm_tpu_torch.serve.engine import (
    InferenceEngine as TEngine)
from grounded_video_llm_tpu_torch.serve.generate import (
    generate_tokens as t_generate,
    generate_tokens_from_features as t_generate_ff)

ATTN_RTOL, ATTN_ATOL = 2 ** -7, 1e-3
LOGITS_REL_L2 = 3e-2


def _bf16_pair(a):
    j = jnp.asarray(a, jnp.bfloat16)
    return torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16), j


def _t(a):
    return torch.from_numpy(np.array(a))


def _verify_inputs(B, S, H, Hkv, D, L, seed):
    """Same bf16 q / new k,v and one int8 cache laid out both ways; a ragged
    mask (row 0), an empty cache mask (row 1, only the new tokens visible)
    and per-query windows (row 2)."""
    rng = np.random.default_rng(seed)
    q, qj = _bf16_pair(rng.normal(size=(B, S, H, D)))
    kn, knj = _bf16_pair(rng.normal(size=(B, S, Hkv, D)))
    vn, vnj = _bf16_pair(rng.normal(size=(B, S, Hkv, D)))
    k8, ks = (np.asarray(a) for a in jda.quantize_kv(
        jnp.asarray(rng.normal(size=(B, L, Hkv, D)), jnp.bfloat16)))
    v8, vs = (np.asarray(a) for a in jda.quantize_kv(
        jnp.asarray(rng.normal(size=(B, L, Hkv, D)), jnp.bfloat16)))
    mask = np.zeros((B, S, L), bool)
    mask[0, :, 3:L - 10] = True
    if B > 2:
        for i in range(S):
            mask[2, i, 5 + i:60 + 3 * i] = True
    jax_in = (qj, jnp.asarray(k8.transpose(0, 2, 3, 1)),
              jnp.asarray(ks.transpose(0, 2, 1)[:, :, None, :]),
              jnp.asarray(v8.transpose(0, 2, 3, 1)),
              jnp.asarray(vs.transpose(0, 2, 1)[:, :, None, :]),
              jnp.asarray(mask.astype(np.int32)), knj, vnj)
    t_in = (q, _t(k8.transpose(0, 2, 1, 3)), _t(ks.transpose(0, 2, 1)),
            _t(v8.transpose(0, 2, 1, 3)), _t(vs.transpose(0, 2, 1)),
            _t(mask), kn, vn)
    return jax_in, t_in


@pytest.mark.parametrize("H,Hkv,S", [(4, 2, 4), (8, 8, 5), (4, 1, 3)],
                         ids=["gqa_g2", "mha_s5", "gqa_g4"])
def test_verify_attention_int8_matches_jax(H, Hkv, S):
    B, D, L = 3, 64, 256
    jax_in, t_in = _verify_inputs(B, S, H, Hkv, D, L, 10 + H + S)
    oj = jda.verify_attention_int8(*jax_in, scale=D ** -0.5)
    before = tda.VERIFY_ATTENTION_INT8.launches
    ot = tda.verify_attention_int8(*t_in, scale=D ** -0.5)
    assert tda.VERIFY_ATTENTION_INT8.launches == before
    assert ot.dtype == torch.bfloat16 and tuple(ot.shape) == (B, S, H, D)
    np.testing.assert_allclose(ot.float().numpy(), np.asarray(oj, np.float32),
                               rtol=ATTN_RTOL, atol=ATTN_ATOL)
    # row 1 has an empty cache mask: query 0 attends exactly new token 0
    vn = t_in[7].float()[1, 0]                           # [Hkv, D]
    want = vn.repeat_interleave(H // Hkv, dim=0)
    np.testing.assert_allclose(ot[1, 0].float().numpy(), want.numpy(),
                               rtol=2 ** -8)


def test_verify_attention_s1_close_to_decode_attention():
    """At S = 1 the verify math is K4's up to the roundings of
    _kernel_multi (bf16 q for the new token, normalised before PV)."""
    B, H, Hkv, D, L = 3, 4, 2, 64, 128
    _, t_in = _verify_inputs(B, 1, H, Hkv, D, L, 30)
    q, k8, ks, v8, vs, mask, kn, vn = t_in
    got = tda.verify_attention_int8(q, k8, ks, v8, vs, mask, kn, vn,
                                    scale=D ** -0.5)
    want = tda.decode_attention_int8_reference(
        q, k8, ks, v8, vs, mask[:, 0], kn, vn, scale=D ** -0.5)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0.02, atol=0.01)


def test_scatter_write_multi_bit_equal_and_in_place():
    L, B, Hkv, D, S, max_len = 2, 3, 2, 16, 5, 256
    rng = np.random.default_rng(11)
    vals = rng.integers(-100, 100, (L, B, Hkv, max_len, D), dtype=np.int8)
    scales = rng.random((L, B, Hkv, max_len), dtype=np.float32)
    new_v = rng.integers(-100, 100, (L, B, S, Hkv, D), dtype=np.int8)
    new_s = rng.random((L, B, S, Hkv), dtype=np.float32)
    # mid-tile, across the 128-lane tile boundary, at the array edge
    base = np.array([40, 126, max_len - S], np.int32)
    jv = jcw.scatter_write_kv_multi(jnp.asarray(vals.transpose(0, 1, 2, 4, 3)),
                                    jnp.asarray(new_v), jnp.asarray(base))
    js = jcw.scatter_write_scale_multi(jnp.asarray(scales[:, :, :, None, :]),
                                       jnp.asarray(new_s), jnp.asarray(base))
    tv, ts = _t(vals), _t(scales)
    ptrs = (tv.data_ptr(), ts.data_ptr())
    before = tcw.SCATTER_WRITE_MULTI.launches
    tcw.scatter_write_multi([tv, ts], [_t(new_v), _t(new_s)], _t(base))
    assert (tv.data_ptr(), ts.data_ptr()) == ptrs
    assert tcw.SCATTER_WRITE_MULTI.launches == before
    np.testing.assert_array_equal(tv.numpy(),
                                  np.asarray(jv).transpose(0, 1, 2, 4, 3))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[:, :, :, 0])


def test_scatter_write_multi_skips_slots_past_the_end():
    cache = torch.zeros(1, 2, 1, 8, 4, dtype=torch.int8)
    new = torch.ones(1, 2, 3, 1, 4, dtype=torch.int8)
    tcw.scatter_write_multi([cache], [new],
                            torch.tensor([6, -2], dtype=torch.int32))
    assert cache[0, 0, 0, 6:].eq(1).all() and cache[0, 1, 0, :1].eq(1).all()
    assert int(cache.abs().sum()) == 2 * 4 + 1 * 4


# ---------------------------------------------------------------------------
# verify_step + commit_verify
# ---------------------------------------------------------------------------


def _prefilled(jparams, tparams, cfg, B, S, max_len, seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, S, cfg.hidden_size)).astype(np.float32) * 0.1
    mask = np.ones((B, S), np.int32)
    mask[0, :2] = 0                                   # left padding
    dt = tllm.embed_dtype(tparams["embed"])
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    _, jc = jllm.prefill(jparams, cfg, jnp.asarray(emb, jdt),
                         jnp.asarray(mask),
                         jllm.KVCache.create(cfg, B, max_len),
                         quantize_cache=True)
    _, tc = tllm.prefill(tparams, cfg, _t(emb).to(dt), _t(mask).long(),
                         tllm.QuantKVCache.create(cfg, B, max_len))
    valid = np.zeros((B, max_len), bool)
    valid[:, :S] = mask.astype(bool)
    return jc, tc, valid, mask.sum(-1).astype(np.int32)


def _port_cache_as_jax_layout(tc):
    return (tc.k.numpy().transpose(0, 1, 2, 4, 3),
            tc.v.numpy().transpose(0, 1, 2, 4, 3))


def _verify_both(jparams, tparams, cfg, B=2, S=8, S_v=3, seed=5):
    max_len = 128
    jc, tc, valid, pos0 = _prefilled(jparams, tparams, cfg, B, S, max_len,
                                     seed)
    toks = np.random.default_rng(seed).integers(3, cfg.vocab_size,
                                                size=(B, S_v))
    positions = pos0[:, None] + np.arange(S_v)[None, :]
    dt = tllm.embed_dtype(tparams["embed"])
    jemb = jllm.embed_lookup(jparams["embed"], jnp.asarray(toks))
    lj, jc2 = jllm.verify_step(jparams, cfg, jemb, jc, jnp.asarray(valid),
                               jnp.asarray(positions))
    with torch.inference_mode():
        temb = tllm.embed_lookup(tparams["embed"], _t(toks).long(), dt)
        lt, tc2 = tllm.verify_step(tparams, cfg, temb, tc, _t(valid),
                                   _t(positions))
    return lj, jc2, lt, tc2, valid, S_v


@pytest.fixture(scope="module")
def micro():
    cfg = micro_vlm_config("phi3.5")
    jp = jvlm.init_params(jax.random.key(0), cfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, tp


def test_verify_step_and_commit_match_jax_fp32(micro):
    cfg, jp, tp = micro
    lj, jc2, lt, tc2, valid, S_v = _verify_both(jp["llm"], tp["llm"],
                                                cfg.llm)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == lj.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(tc2.length, _t(np.asarray(jc2.length)))   # not moved
    # slots holding tokens: the committed ones and the S_v candidates (the
    # left-pad slots differ by design: xla_mha averages a query row with no
    # valid key, the flash convention gives zeros)
    held = valid.copy()
    held[:, 8:8 + S_v] = True
    for t, j in zip(_port_cache_as_jax_layout(tc2), (jc2.k, jc2.v)):
        d = t.astype(np.int32) - np.asarray(j, np.int32)  # [L,B,Hkv,D,max]
        assert np.abs(d.transpose(1, 4, 0, 2, 3)[held]).max() <= 1
    n_accept = np.array([2, 3], np.int32)
    jc3, jvalid = jllm.commit_verify(jc2, jnp.asarray(valid),
                                     jnp.asarray(n_accept), S_v)
    tc3, tvalid = tllm.commit_verify(tc2, _t(valid), _t(n_accept), S_v)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tc3.length.numpy(), np.asarray(jc3.length))


def test_verify_step_matches_sequential_decode_steps(micro):
    """The port's verify_step against S_v sequential decode_steps of the
    port: logits within the JAX test's bar, and the fully committed caches
    within one int8 step."""
    cfg, jp, tp = micro
    lp, c = tp["llm"], cfg.llm
    B, S, S_v, max_len = 2, 8, 3, 128
    _, tc, valid, pos0 = _prefilled(jp["llm"], lp, c, B, S, max_len, 7)
    toks = _t(np.random.default_rng(7).integers(3, c.vocab_size, (B, S_v)))
    snap = tc._replace(k=tc.k.clone(), k_scale=tc.k_scale.clone(),
                       v=tc.v.clone(), v_scale=tc.v_scale.clone())
    cache, vmask, seq = snap, _t(valid), []
    with torch.inference_mode():
        for i in range(S_v):
            emb = tllm.embed_lookup(lp["embed"], toks[:, i])[:, None]
            lg, cache, vmask = tllm.decode_step(lp, c, emb, cache, vmask,
                                                _t(pos0 + i))
            seq.append(lg)
        positions = _t(pos0[:, None] + np.arange(S_v)[None, :])
        lv, vc = tllm.verify_step(lp, c, tllm.embed_lookup(lp["embed"], toks),
                                  tc, _t(valid), positions)
        vc, vvalid = tllm.commit_verify(vc, _t(valid),
                                        torch.full((B,), S_v), S_v)
    np.testing.assert_allclose(lv.numpy(), torch.stack(seq, 1).numpy(),
                               rtol=0.05, atol=0.05)
    assert torch.equal(vvalid, vmask) and torch.equal(vc.length, cache.length)
    assert (vc.k.int() - cache.k.int()).abs().max() <= 1
    assert (vc.v.int() - cache.v.int()).abs().max() <= 1


@pytest.fixture(scope="module")
def wide_int8():
    """test_torch_int8_serving.py's widened micro LLM, int8_full."""
    cfg = micro_vlm_config("phi3.5")
    cfg = replace(cfg, llm=replace(cfg.llm, hidden_size=512,
                                   intermediate_size=512, num_heads=8,
                                   num_kv_heads=8, head_dim=64))
    jl = jvlm.init_params(jax.random.key(2), cfg)["llm"]
    jl = jq.quantize_llm_for_serving(jl, w8a8=True)
    full = jvlm.init_params(jax.random.key(2), cfg)
    full["llm"] = jl
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, full), cfg,
                         "cpu")
    return cfg, jl, tp["llm"]


def test_verify_step_int8_full_matches_jax(wide_int8):
    cfg, jl, tl = wide_int8
    assert tl["layers"]["qkv_kernel"].w8a8
    lj, jc2, lt, tc2, _, _ = _verify_both(jl, tl, cfg.llm, seed=9)
    lj = np.asarray(lj, np.float64)
    rel = np.linalg.norm(lt.double().numpy() - lj) / np.linalg.norm(lj)
    assert rel <= LOGITS_REL_L2, rel
    # the candidates' k/v as written (dequantized): the same bf16-level bar
    for tq, ts, jqv, jsc in ((tc2.k, tc2.k_scale, jc2.k, jc2.k_scale),
                             (tc2.v, tc2.v_scale, jc2.v, jc2.v_scale)):
        got = (tq.double() * ts.double()[..., None])[:, :, :, 8:11].numpy()
        want = (np.asarray(jqv, np.float64) * np.asarray(jsc, np.float64)
                )[..., 8:11].transpose(0, 1, 2, 4, 3)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= LOGITS_REL_L2, rel


# ---------------------------------------------------------------------------
# drafters and the accept rule
# ---------------------------------------------------------------------------


def test_ngram_and_table_drafts_equal_jax():
    rng = np.random.default_rng(3)
    bufs = [np.array([[5, 6, 7, 8, 9, 5, 6, 0, 0, 0],
                      [1, 2, 3, 4, 1, 2, 9, 9, 0, 0]]),
            np.array([[1, 2, 3, 4, 5, 0, 0, 0]]),
            np.array([[8, 1, 2, 5, 9, 7, 1, 2, 4, 6, 8, 1, 2, 0, 0, 0]]),
            rng.integers(0, 4, (6, 40))]
    ptrs = [np.array([7, 6]), np.array([5]), np.array([13]),
            rng.integers(0, 41, 6)]
    for buf, ptr in zip(bufs, ptrs):
        for K in (1, 3, 5):
            want = jspec.ngram_draft(jnp.asarray(buf, jnp.int32),
                                     jnp.asarray(ptr, jnp.int32), K)
            got = tspec.ngram_draft(_t(buf).long(), _t(ptr).long(), K)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            want = jspec.table_draft(jnp.asarray(buf), jnp.asarray(ptr), K)
            got = tspec.table_draft(_t(buf), _t(ptr).long(), K)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_accept_equals_jax():
    rng = np.random.default_rng(4)
    B, K, V = 64, 3, 11
    logits = rng.normal(size=(B, K + 1, V)).astype(np.float32)
    greedy = logits.argmax(-1)
    drafts = np.where(rng.random((B, K)) < 0.6, greedy[:, :K],
                      rng.integers(0, V, (B, K)))
    aj, ej = jspec.spec_accept_tokens(jnp.asarray(logits),
                                      jnp.asarray(drafts, jnp.int32),
                                      jax.random.key(0), 0.0, None, False)
    at, et = tspec.spec_accept_tokens(_t(logits), _t(drafts), None, 0.0,
                                      None, False)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    assert set(at.tolist()) >= {1, K + 1}


@pytest.mark.parametrize("top_p", [None, 0.9])
def test_sampled_accept_preserves_the_distribution(top_p):
    """Delta-draft rejection: the first emitted token's law is the model's
    (temperature and top-p applied), the draft is accepted with p(draft),
    accepted rows emit it and rejected rows never do."""
    B, V, temp = 40_000, 8, 0.8
    base = torch.tensor([1.2, 0.3, -0.5, 2.0, 0.0, -1.0, 0.7, -2.0])
    lg = base / temp
    if top_p is not None:
        lg = tspec._top_p_filter(lg, top_p)
    p = torch.softmax(lg, dim=-1).numpy()
    logits = base[None, None, :].expand(B, 2, V)
    draft = 3                                         # the mode, p ≈ 0.44
    g = torch.Generator().manual_seed(7)
    a, emitted = tspec.spec_accept_tokens(
        logits, torch.full((B, 1), draft), g, temp, top_p, True)
    a, emitted = a.numpy(), emitted.numpy()
    freq = np.bincount(emitted[:, 0], minlength=V) / B
    np.testing.assert_allclose(freq, p, atol=0.012)
    np.testing.assert_allclose((a == 2).mean(), p[draft], atol=0.012)
    assert (emitted[a == 2, 0] == draft).all()
    assert (emitted[a == 1, 0] != draft).all()
    assert (emitted[:, 1] >= 0).all() and (emitted[:, 1] < V).all()


# ---------------------------------------------------------------------------
# generation, the engine and the CLI
# ---------------------------------------------------------------------------


def _spec_inputs(cfg, B=2, S=8):
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 50, size=(B, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    mask = np.ones((B, S), np.int32)
    mask[1, 0] = 0
    sp = np.zeros((B, cfg.num_segs, 336, 336, 3), np.float32)
    tm = np.zeros((B, cfg.num_frames, 224, 224, 3), np.float32)
    return ids, mask, sp, tm


def test_generate_tokens_spec_equals_lockstep_and_jax(micro):
    cfg, jp, tp = micro
    ids, mask, sp, tm = _spec_inputs(cfg)
    kw = dict(max_new_tokens=6, do_sample=False, temperature=0.0,
              eos_token_id=-2, pad_token_id=0)
    jt, jlen = jspec.generate_tokens_spec(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(sp),
        jnp.asarray(tm), jax.random.key(0), draft_len=3, **kw)
    args = (tp, cfg, _t(ids).long(), _t(mask).long(), _t(sp), _t(tm), None)
    lock, lock_len = t_generate(*args, quantize_cache=True, **kw)
    timings = {}
    tt, tlen = tspec.generate_tokens_spec(*args, draft_len=3,
                                          timings=timings, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(tt.numpy(), lock.numpy())
    np.testing.assert_array_equal(tlen.numpy(), lock_len.numpy())
    assert set(timings) >= {"encode", "prefill", "decode", "verify_passes"}
    assert 2 <= timings["verify_passes"] <= 5

    # sampled: the same loop with the rejection rule; tokens in range
    g = torch.Generator().manual_seed(1)
    ts, tslen = tspec.generate_tokens_spec(
        *args[:-1], g, draft_len=3, **dict(kw, do_sample=True,
                                           temperature=0.7))
    assert tuple(ts.shape) == (2, 6) and (tslen == 6).all()
    v_total = cfg.llm.vocab_size + cfg.llm.num_extra_tokens
    assert (ts >= 0).all() and (ts < v_total).all()


def test_table_drafter_passes_and_exactness(micro):
    """An oracle table (prompt + the greedy stream) commits K + 1 tokens per
    pass: NEW = 6 takes 2 passes after the prefill token; a corrupted table
    commits one per pass (NEW - 1 passes); both stay token-exact."""
    cfg, jp, tp = micro
    B, S, NEW, K = 2, 8, 6, 3
    ids, _, _, _ = _spec_inputs(cfg, B, S)
    mask = torch.ones(B, S, dtype=torch.long)
    feats = torch.zeros(B, cfg.num_video_tokens, cfg.llm.hidden_size)
    kw = dict(max_new_tokens=NEW, temperature=0.0, do_sample=False,
              eos_token_id=-2, pad_token_id=0)
    ref, ref_len = t_generate_ff(tp, cfg, _t(ids).long(), mask, feats, None,
                                 quantize_cache=True, **kw)
    oracle = torch.cat([_t(ids).long(), ref], dim=1)
    for table, want_passes in ((oracle, 2), ((oracle + 1) % 50, NEW - 1)):
        got, got_len, passes = tspec.generate_tokens_spec_from_features(
            tp, cfg, _t(ids).long(), mask, feats, None, draft_len=K,
            draft_table=table, with_stats=True, **kw)
        assert torch.equal(got, ref) and torch.equal(got_len, ref_len)
        assert passes == want_passes, passes
    jt, _, jpasses = jspec.generate_tokens_spec_from_features(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask.numpy()),
        jnp.asarray(feats.numpy()), jax.random.key(0), draft_len=K,
        draft_table=jnp.asarray(oracle.numpy()), with_stats=True, **kw)
    np.testing.assert_array_equal(np.asarray(jt), ref.numpy())
    assert int(jpasses) == 2


def test_engine_generate_spec_equals_lockstep(micro):
    cfg, _, tp = micro
    tok = build_test_tokenizer("phi3.5")
    rng = np.random.default_rng(6)
    temporal = rng.integers(0, 256, (cfg.num_frames, 224, 224, 3), np.uint8)
    spatial = rng.integers(0, 256, (cfg.num_segs, 336, 336, 3), np.uint8)
    prompts = ["<image>\nwhen does it happen?", "describe <image> briefly"]
    base = dict(max_new_tokens=6, do_sample=False)
    eng = TEngine(tp, cfg, tok, GenerateConfig(**base, quantize_cache=True))
    lock = eng.generate(prompts, temporal, spatial)
    assert "verify_passes" not in eng.last_timings
    spec = eng.generate(prompts, temporal, spatial,
                        GenerateConfig(**base, spec_draft_len=3))
    assert spec == lock
    assert eng.last_timings["verify_passes"] >= 1
    assert eng.last_timings["new_tokens"] >= 1
    with pytest.raises(NotImplementedError):
        eng.generate(prompts, temporal, spatial,
                     GenerateConfig(**base, num_beams=2))


def test_cli_inference_debug_tiny_int8_full_spec(tmp_path, capsys):
    """cli/inference.py end to end on the CPU: micro dims, int8_full,
    speculative decoding, on a small mp4 written with cv2; then bf16 from a
    stage checkpoint written by the port's exporter (--ckpt_path)."""
    cv2 = pytest.importorskip("cv2")
    from grounded_video_llm_tpu_torch.cli import inference

    path = tmp_path / "clip.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (64, 48))
    rng = np.random.default_rng(0)
    for _ in range(30):
        w.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    w.release()
    results = inference.main(["--debug_tiny", "--device", "cpu", "--quantize",
                              "int8_full", "--spec_draft_len", "3",
                              "--max_new_tokens", "4", "--no-do_sample",
                              "--video_path", str(path)])
    out = capsys.readouterr().out
    assert set(results) == {"grounding", "qa", "referring"}
    for mode in results:
        assert f"[{mode}] raw:" in out and f"[{mode}] parsed:" in out
    # a stage checkpoint through --ckpt_path: its projectors, embed and
    # lm_head are what the engine serves
    from unittest import mock

    from grounded_video_llm_tpu_torch.cli.model_loading import build_params
    from grounded_video_llm_tpu_torch.core.config import \
        micro_vlm_config as tmicro
    from grounded_video_llm_tpu_torch.models.export import \
        export_vlm_to_reference
    from grounded_video_llm_tpu_torch.serve import engine as engine_mod

    cfg = tmicro("phi3.5")
    trained = build_params(cfg, "cpu", torch.float32, seed=77)
    stage = str(tmp_path / "grounded_llava_next_video_phi3.5_mix.pth")
    export_vlm_to_reference(trained, cfg, stage, trainable_only=False)
    served = []
    real = engine_mod.InferenceEngine.__init__

    def spy(self, params, *a, **kw):
        served.append(params)
        real(self, params, *a, **kw)

    with mock.patch.object(engine_mod.InferenceEngine, "__init__", spy):
        results = inference.main(["--debug_tiny", "--device", "cpu",
                                  "--ckpt_path", stage, "--max_new_tokens",
                                  "4", "--no-do_sample", "--video_path",
                                  str(path)])
    assert set(results) == {"grounding", "qa", "referring"}
    (params,) = served
    for key in ("embed", "lm_head"):
        assert torch.equal(params["llm"][key], trained["llm"][key])
    assert torch.equal(params["mm_projector"]["fc1"]["kernel"],
                       trained["mm_projector"]["fc1"]["kernel"])
    assert not torch.equal(params["llm"]["layers"]["qkv_kernel"],
                           trained["llm"]["layers"]["qkv_kernel"])
