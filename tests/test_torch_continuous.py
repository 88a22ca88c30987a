"""Continuous batching in the port (serve/continuous.py, llm.decode_step and
decode_step_shared with active=) against the JAX package on the CPU.

The cases of tests/test_continuous.py, on the same seeds (micro_vlm_config,
fp32, greedy): every request's tokens from the port's ContinuousServer are
exactly equal to the JAX ContinuousServer's for the same requests and pool
shape, and to the port's own per-request lockstep generation
(generate_tokens, as the JAX tests hold JAX's pool), or, for the
shared-prefix pool, to the port's plain prefix pool (as the JAX tests do).

The pool's steps against JAX with one inactive row: decode_step on the int8
cache and decode_step_shared on the cascade, logits rtol 2e-4 (fp32, other
sum orders), cache values bit-equal after the layout transpose ([.., Hkv, Dh,
M] in JAX, [.., Hkv, M, Dh] here), scales rtol 2e-4, lengths and valid masks
equal; commit_verify with per-row accepted counts, 0 on inactive rows; the
bf16 KVCache refused with active=. A chunk reads nothing back to the host
(Tensor.item and its kin counted while it is launched).

JAX's compiled pool programs are the slow part, so each case runs JAX once
and the requests, features and prefixes are built once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu.core.config import micro_vlm_config
from grounded_video_llm_tpu.models import llm as jllm
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.serve import continuous as jcont
from grounded_video_llm_tpu.serve import generate as jgen
from grounded_video_llm_tpu.text.templates import IMAGE_TOKEN_INDEX
from grounded_video_llm_tpu_torch.models import llm as tllm
from grounded_video_llm_tpu_torch.models import vlm as tvlm
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.serve import continuous as tcont
from grounded_video_llm_tpu_torch.serve import generate as tgen

EOS, PAD = 2, 0
RTOL = 2e-4
GREEDY = dict(temperature=0.0, do_sample=False, eos_token_id=EOS,
              pad_token_id=PAD)


class Model:
    """One micro model in both packages, with the test requests and what is
    derived from them, each built once."""

    def __init__(self, name, key):
        self.cfg = cfg = micro_vlm_config(name)
        self.jp = jvlm.init_params(jax.random.key(key), cfg)
        self.tp = params_from_jax(jax.tree_util.tree_map(np.asarray, self.jp),
                                  cfg, "cpu")
        # tests/test_continuous.py's _make_requests: one stream of draws, so
        # the first k of n requests are those of k
        rng = np.random.default_rng(7)
        self.reqs = []
        for _ in range(4):
            ids = rng.integers(3, 50, size=(10,)).astype(np.int32)
            ids[2] = IMAGE_TOKEN_INDEX
            sp = rng.normal(size=(cfg.num_segs, 336, 336, 3)).astype(
                np.float32) * 0.1
            tp = rng.normal(size=(cfg.num_frames, 224, 224, 3)).astype(
                np.float32) * 0.1
            self.reqs.append((ids, np.ones((10,), np.int32), sp, tp))
        self._feats, self._prefix, self._lockstep = {}, {}, {}

    def features(self, i):
        """Request i's video features [NV, H] (the port's encode)."""
        if i not in self._feats:
            _, _, sp, tp = self.reqs[i]
            with torch.no_grad():
                self._feats[i] = tvlm.encode_video(
                    self.tp, self.cfg, torch.from_numpy(sp[None]),
                    torch.from_numpy(tp[None]))[0].numpy()
        return self._feats[i]

    def prefix(self, i, hint):
        """(JAX, port) bf16 prefix K/V of request i's [pre-image | video]
        head (its ids[:2]) at the LongRoPE hint."""
        if (i, hint) not in self._prefix:
            pre = self.reqs[i][0][None, :2]
            f = self.features(i)[None]
            self._prefix[i, hint] = (
                jgen.build_prefix_kv(self.jp, self.cfg, jnp.asarray(pre),
                                     jnp.ones(pre.shape, jnp.int32),
                                     jnp.asarray(f), hint),
                tgen.build_prefix_kv(self.tp, self.cfg,
                                     torch.from_numpy(pre).long(),
                                     torch.ones(pre.shape, dtype=torch.long),
                                     torch.from_numpy(f), hint))
        return self._prefix[i, hint]

    def lockstep(self, ids, i):
        """The port's per-request greedy tokens (EOS dropped) of prompt ids
        on request i's pixels, 8 new tokens: a smaller budget is a prefix."""
        key = (ids.tobytes(), i)
        if key not in self._lockstep:
            _, mask, sp, tp = self.reqs[i]
            toks, n = tgen.generate_tokens(
                self.tp, self.cfg, torch.from_numpy(ids[None]).long(),
                torch.from_numpy(mask[None]).long(),
                torch.from_numpy(sp[None]), torch.from_numpy(tp[None]), None,
                max_new_tokens=8, **GREEDY)
            out = [int(t) for t in toks[0][:int(n[0])]]
            self._lockstep[key] = np.asarray([t for t in out if t != EOS],
                                             np.int32)
        return self._lockstep[key]


@pytest.fixture(scope="module")
def models():
    made = {}

    def get(name):
        if name not in made:
            made[name] = Model(name, {"phi3.5": 0, "llama3": 1}[name])
        return made[name]
    return get


def _pixel(m, i, budget=None, ids=None):
    ids0, mask, sp, tp = m.reqs[i]
    ids = ids0 if ids is None else ids
    return ((jcont.Request(ids, mask, sp, tp, max_new_tokens=budget),
             tcont.Request(ids, mask, sp, tp, max_new_tokens=budget)),
            m.lockstep(ids, i))


def _feature(m, i, budget=None):
    (jr, tr), want = _pixel(m, i, budget)
    f = m.features(i)
    return ((jr._replace(spatial_pixels=None, temporal_pixels=None,
                         features=f),
             tr._replace(spatial_pixels=None, temporal_pixels=None,
                         features=torch.from_numpy(f))), want)


def _prefixed(m, i, hint, video=None, budget=None):
    """Request i's question (ids[3:]) on the prefix of request `video`
    (default its own); the lockstep reference runs the whole prompt."""
    video = i if video is None else video
    jpre, tpre = m.prefix(video, hint)
    ids = np.concatenate([m.reqs[video][0][:3], m.reqs[i][0][3:]])
    mask = m.reqs[i][1][3:]
    return ((jcont.Request(ids[3:], mask, None, None, max_new_tokens=budget,
                           prefix=jpre),
             tcont.Request(ids[3:], mask, None, None, max_new_tokens=budget,
                           prefix=tpre)),
            m.lockstep(ids, video))


PREFIX_KW = dict(prompt_len=7)


def _hint(m, kw):
    """The pool's max_len, the prefixes' LongRoPE hint."""
    kw = {k: v for k, v in kw.items() if k != "shared_prefix"}
    return tcont.ContinuousServer(m.tp, m.cfg, **kw, **GREEDY).max_len


def _requests(m, kind, kw, budgets):
    if kind == "pixels":
        return [_pixel(m, i, b) for i, b in enumerate(budgets)]
    if kind == "features":
        return [_feature(m, i, b) for i, b in enumerate(budgets)]
    if kind == "mixed_kinds":        # pixels and features alternate
        return [(_feature if i % 2 else _pixel)(m, i, b)
                for i, b in enumerate(budgets)]
    hint = _hint(m, kw)
    if kind == "prefix":
        return [_prefixed(m, i, hint, budget=b) for i, b in enumerate(budgets)]
    if kind == "shared_head":        # 0 and 1 share video 0's prefix
        return [_prefixed(m, 0, hint, budget=budgets[0]),
                _prefixed(m, 1, hint, video=0, budget=budgets[1]),
                _prefixed(m, 2, hint, budget=budgets[2])]
    if kind == "one_video":          # every question on video 0's prefix
        return [_prefixed(m, i, hint, video=0, budget=b)
                for i, b in enumerate(budgets)]
    if kind == "two_videos":         # videos 0, 1, 0, 1: repins
        return [_prefixed(m, i, hint, video=i % 2, budget=b)
                for i, b in enumerate(budgets)]
    raise ValueError(kind)


def _pool(**kw):
    return dict(dict(pool_size=2, prompt_len=10, chunk=2), **kw)


# name: (model, request kind, budgets, server kwargs, reference). reference
# "lockstep": the port's per-request generate_tokens; "plain": the port's
# plain (not shared) prefix pool over the same requests
CASES = {
    "three_requests_two_slots": ("phi3.5", "pixels", [None] * 3,
                                 _pool(max_new_tokens=6), "lockstep"),
    "admit_batch_pad_by_repeat": ("phi3.5", "pixels", [3, 6, 4],
                                  _pool(pool_size=3, max_new_tokens=8,
                                        admit_batch=4), "lockstep"),
    "longest_first": ("phi3.5", "pixels", [2, 6, 3, 5],
                      _pool(max_new_tokens=8,
                            admission_policy="longest_first"), "lockstep"),
    "chunk_long": ("phi3.5", "pixels", [3, 8, 8],
                   _pool(max_new_tokens=8, chunk_long=4), "lockstep"),
    "pipeline_chunks": ("phi3.5", "pixels", [2, 6, 3, 5],
                        _pool(max_new_tokens=8, pipeline_chunks=True),
                        "lockstep"),
    "spec_chunks": ("phi3.5", "pixels", [6, 3, 5],
                    _pool(max_new_tokens=6, spec_draft_len=2), "lockstep"),
    "llama_gqa": ("llama3", "pixels", [None] * 3, _pool(max_new_tokens=5),
                  "lockstep"),
    "feature_backed": ("phi3.5", "features", [None] * 3,
                       _pool(max_new_tokens=5), "lockstep"),
    "mixed_kinds_admit_batch": ("phi3.5", "mixed_kinds", [None] * 4,
                                _pool(pool_size=4, max_new_tokens=4,
                                      admit_batch=2), "lockstep"),
    "prefix_backed": ("phi3.5", "prefix", [None] * 3,
                      _pool(max_new_tokens=5, **PREFIX_KW), "lockstep"),
    "mixed_prefix_admission": ("phi3.5", "shared_head", [None] * 3,
                               _pool(pool_size=3, max_new_tokens=4,
                                     admit_batch=2, **PREFIX_KW),
                               "lockstep"),
    "prefix_spec": ("phi3.5", "prefix", [None] * 3,
                    _pool(max_new_tokens=5, spec_draft_len=2, **PREFIX_KW),
                    "lockstep"),
    "shared_prefix": ("phi3.5", "one_video", [None] * 4,
                      _pool(max_new_tokens=6, shared_prefix=True,
                            **PREFIX_KW), "plain"),
    "shared_prefix_repin": ("phi3.5", "two_videos", [None] * 4,
                            _pool(max_new_tokens=5, shared_prefix=True,
                                  **PREFIX_KW), "plain"),
    "shared_prefix_spec": ("phi3.5", "one_video", [None] * 3,
                           _pool(max_new_tokens=5, shared_prefix=True,
                                 spec_draft_len=2, **PREFIX_KW), "plain"),
    "shared_pipelined_chunk_long": ("phi3.5", "one_video", [None] * 3,
                                    _pool(max_new_tokens=8,
                                          shared_prefix=True,
                                          pipeline_chunks=True, chunk_long=3,
                                          **PREFIX_KW), "plain"),
    "shared_pipelined_spec": ("phi3.5", "one_video", [None] * 3,
                              _pool(max_new_tokens=8, shared_prefix=True,
                                    pipeline_chunks=True, spec_draft_len=2,
                                    **PREFIX_KW), "plain"),
}


def _prefix_dims(m, kw):
    if "prompt_len" in kw and kw["prompt_len"] == 7:
        return dict(prefix_len=2 + m.cfg.num_video_tokens)
    return {}


def _servers(m, kw):
    kw = dict(kw, **_prefix_dims(m, kw))
    return (jcont.ContinuousServer(m.jp, m.cfg, **kw, **GREEDY),
            tcont.ContinuousServer(m.tp, m.cfg, **kw, **GREEDY))


def _assert_tokens(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.int32, what
        np.testing.assert_array_equal(a, b, err_msg=f"{what}, request {i}")


@pytest.mark.parametrize("case", list(CASES))
def test_pool_matches_jax(models, case):
    name, kind, budgets, kw, reference = CASES[case]
    m = models(name)
    pairs = _requests(m, kind, dict(kw, **_prefix_dims(m, kw)), budgets)
    jserver, tserver = _servers(m, kw)
    got_j = jserver.serve([p[0][0] for p in pairs])
    got_t = tserver.serve([p[0][1] for p in pairs])
    _assert_tokens(got_t, got_j, f"{case}: port pool vs JAX pool")
    if reference == "lockstep":
        want = [w if b is None else w[:b]
                for (_, w), b in zip(pairs, budgets)]
        want = [w[:kw["max_new_tokens"]] for w in want]
    else:
        plain = tcont.ContinuousServer(
            m.tp, m.cfg, **{k: v for k, v in dict(
                kw, **_prefix_dims(m, kw)).items() if k != "shared_prefix"},
            **GREEDY)
        want = plain.serve([p[0][1] for p in pairs])
    _assert_tokens(got_t, want, f"{case}: port pool vs {reference}")
    assert tserver.timings["admissions"] == len(pairs)
    assert not tserver._busy()


def test_pool_reuses_a_slot_after_retirement(models):
    """A slot freed by one request serves a later one uncorrupted: a second
    serve() on the same 1-slot pool, as in JAX."""
    m = models("phi3.5")
    kw = _pool(pool_size=1, max_new_tokens=4)
    jserver, tserver = _servers(m, kw)
    for i in range(2):
        (jr, tr), want = _pixel(m, i)
        got_t = tserver.serve([tr])
        _assert_tokens(got_t, jserver.serve([jr]), f"serve {i} vs JAX")
        _assert_tokens(got_t, [want[:4]], f"serve {i} vs lockstep")


def test_warmup_is_transparent(models):
    """warmup() (a budget-1 admission and the chunk programs over an
    all-inactive pool, then a reset) leaves a server that gives a fresh
    one's tokens, plain (pixels, with chunk_long) and cascade pools."""
    m = models("phi3.5")
    reqs = [_pixel(m, i)[0][1] for i in range(2)]
    kw = _pool(max_new_tokens=6, chunk_long=4)
    base = tcont.ContinuousServer(m.tp, m.cfg, **kw, **GREEDY).serve(reqs)
    warmed = tcont.ContinuousServer(m.tp, m.cfg, **kw, **GREEDY)
    warmed.warmup(kind="pixels")
    assert warmed.timings == {} and not warmed._busy()
    _assert_tokens(warmed.serve(reqs), base, "warmed plain pool")

    pkw = dict(_pool(max_new_tokens=6, **PREFIX_KW),
               prefix_len=2 + m.cfg.num_video_tokens)
    qs = [p[0][1] for p in _requests(m, "one_video", pkw, [None] * 2)]
    plain = tcont.ContinuousServer(m.tp, m.cfg, **pkw, **GREEDY).serve(qs)
    cascade = tcont.ContinuousServer(m.tp, m.cfg, shared_prefix=True, **pkw,
                                     **GREEDY)
    cascade.warmup()        # default kind: prefix-backed
    assert cascade.state is None
    _assert_tokens(cascade.serve(qs), plain, "warmed cascade pool")


def test_pool_refusals(models):
    """The JAX pool's refusals: shared_prefix without prefix_len, a pixel
    request to a shared-prefix pool, an unknown admission policy, a prefix
    past the pool's envelope; chunk_long <= chunk is off, not an error; the
    pipelined margin doubles."""
    m = models("phi3.5")
    kw = dict(_pool(max_new_tokens=4, prompt_len=7), **GREEDY)
    with pytest.raises(ValueError, match="prefix_len"):
        tcont.ContinuousServer(m.tp, m.cfg, shared_prefix=True, **kw)
    server = tcont.ContinuousServer(m.tp, m.cfg, shared_prefix=True,
                                    prefix_len=2 + m.cfg.num_video_tokens,
                                    **kw)
    with pytest.raises(ValueError, match="prefix-backed"):
        server.serve([_pixel(m, 0)[0][1]])
    with pytest.raises(ValueError, match="admission_policy"):
        tcont.ContinuousServer(m.tp, m.cfg, admission_policy="shortest",
                               **kw)
    with pytest.raises(NotImplementedError, match="admit_batch"):
        tcont.ContinuousServer(m.tp, m.cfg, shared_prefix=True, admit_batch=2,
                               prefix_len=2 + m.cfg.num_video_tokens, **kw)
    assert tcont.ContinuousServer(m.tp, m.cfg, chunk_long=2,
                                  **kw).chunk_long == 0
    piped = tcont.ContinuousServer(m.tp, m.cfg, pipeline_chunks=True, **kw)
    assert piped._chunk_margin == 2 * 2
    # a prefix built for a long pre-image head overflows a pool sized
    # without prefix_len
    small = tcont.ContinuousServer(m.tp, m.cfg, **dict(kw, prompt_len=10))
    long_pre = torch.from_numpy(np.random.default_rng(0).integers(
        3, 50, size=(1, 160)))
    prefix = tgen.build_prefix_kv(m.tp, m.cfg, long_pre,
                                  torch.ones_like(long_pre),
                                  torch.from_numpy(m.features(0)[None]),
                                  small.max_len)
    (_, tr), _ = _prefixed(m, 0, small.max_len)
    with pytest.raises(ValueError, match="overflow"):
        small.serve([tr._replace(prefix=prefix)])


def test_failed_repin_leaves_no_stale_pin(models, monkeypatch):
    """A repin that fails (its prefix quantization raises) fails that
    request through the scheduler and leaves neither the old pool nor the
    old pin: the next request for the formerly pinned video repins and gets
    a fresh pool's tokens."""
    m = models("phi3.5")
    pkw = dict(_pool(max_new_tokens=4, **PREFIX_KW),
               prefix_len=2 + m.cfg.num_video_tokens)
    hint = _hint(m, pkw)
    video0 = _prefixed(m, 0, hint)[0][1]
    video1 = _prefixed(m, 1, hint)[0][1]
    server = tcont.ContinuousServer(m.tp, m.cfg, shared_prefix=True, **pkw,
                                    **GREEDY)
    want = tcont.ContinuousServer(m.tp, m.cfg, shared_prefix=True, **pkw,
                                  **GREEDY).serve([video0])[0]
    quantize = tcont._quantize_prefix_hd
    calls = []

    def fail_once(*a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("out of memory (injected)")
        return quantize(*a)
    monkeypatch.setattr(tcont, "_quantize_prefix_hd", fail_once)
    sched = tcont.ContinuousScheduler(server)
    try:
        np.testing.assert_array_equal(
            sched.submit(video0).result(timeout=300), want)
        with pytest.raises(RuntimeError, match="injected"):
            sched.submit(video1).result(timeout=300)
        assert server.state is None and server._pinned_prefix is None
        got = sched.submit(video0).result(timeout=300)
    finally:
        sched.shutdown()
    assert len(calls) == 3
    np.testing.assert_array_equal(got, want)


def test_on_token_streams_exactly_the_results(models):
    """Every request's callback receives exactly its final token list, in
    order, the admission's first token included (tests/test_streaming.py's
    seeds: ragged budgets 3, 5, 7)."""
    m = models("phi3.5")
    cfg = m.cfg
    rng = np.random.default_rng(11)
    streamed = {i: [] for i in range(3)}
    reqs = []
    for i in range(3):
        ids = rng.integers(3, 50, size=(10,)).astype(np.int32)
        ids[2] = IMAGE_TOKEN_INDEX
        reqs.append(tcont.Request(
            ids, np.ones((10,), np.int32),
            rng.normal(size=(cfg.num_segs, 336, 336, 3)).astype(
                np.float32) * 0.1,
            rng.normal(size=(cfg.num_frames, 224, 224, 3)).astype(
                np.float32) * 0.1,
            max_new_tokens=3 + 2 * i, on_token=streamed[i].append))
    server = tcont.ContinuousServer(m.tp, cfg, pool_size=2, prompt_len=10,
                                    max_new_tokens=8, chunk=2, **GREEDY)
    results = server.serve(reqs)
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(streamed[i], np.int32),
                                      results[i])
        assert len(results[i]) <= 3 + 2 * i


# ---------------------------------------------------------------------------
# The pool's steps: decode_step(active=), decode_step_shared(active=),
# commit_verify with per-row counts
# ---------------------------------------------------------------------------


ACTIVE = np.array([True, False, True])


def _assert_quant_equal(tc, jc, keep):
    """Port QuantKVCache [L, B, Hkv, M, Dh] vs JAX [L, B, Hkv, Dh, M] on the
    slots keep [B, M] (a left-padded prompt's pad slots differ: the port's
    attention gives a row with no valid key zeros, JAX's averages, and no
    query ever reads them)."""
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_array_equal(
            t.numpy().transpose(1, 3, 0, 2, 4)[keep],
            np.asarray(j).transpose(1, 4, 0, 2, 3)[keep])
    for t, j in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
        np.testing.assert_allclose(
            t.numpy().transpose(1, 3, 0, 2)[keep],
            np.asarray(j)[:, :, :, 0].transpose(1, 3, 0, 2)[keep], rtol=RTOL)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def _step_inputs(m, B=3, S=12, seed=3):
    rng = np.random.default_rng(seed)
    emb = (rng.normal(size=(B, S, m.cfg.llm.hidden_size)) * 0.5).astype(
        np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :4] = 0
    tok = (rng.normal(size=(B, 1, m.cfg.llm.hidden_size)) * 0.5).astype(
        np.float32)
    return emb, mask, tok


def _plain_caches(m, max_len=32):
    """A 3-row int8 cache filled by a left-padded prefill in both packages
    (the second row's length differs), its valid mask and positions."""
    emb, mask, tok = _step_inputs(m)
    B, S = mask.shape
    lcfg = m.cfg.llm
    _, jc = jllm.prefill(m.jp["llm"], lcfg, jnp.asarray(emb),
                         jnp.asarray(mask),
                         jllm.KVCache.create(lcfg, B, max_len, jnp.float32),
                         quantize_cache=True)
    _, tc = tllm.prefill(m.tp["llm"], lcfg, torch.from_numpy(emb),
                         torch.from_numpy(mask),
                         tllm.QuantKVCache.create(lcfg, B, max_len))
    # ragged lengths, as pool slots have: row 1 holds two slots more
    jc = jc._replace(length=jnp.asarray([S, S + 2, S], jnp.int32))
    tc = tc._replace(length=torch.tensor([S, S + 2, S], dtype=torch.int32))
    valid = np.zeros((B, max_len), bool)
    valid[:, :S] = mask > 0
    pos = mask.sum(-1).astype(np.int32)
    return jc, tc, valid, pos, tok


def _shared_caches(m):
    """prefill_continue into the cascade cache (tail 32) in both packages
    over a shared batch-1 prefix."""
    emb, mask, tok = _step_inputs(m, S=6)
    hint = _shared_hint(m)
    jpre, tpre = m.prefix(0, hint)
    lcfg = m.cfg.llm
    _, jc, jv, jpos = jllm.prefill_continue(
        m.jp["llm"], lcfg, jnp.asarray(emb), jnp.asarray(mask), *jpre, hint,
        quantize_cache=True, tail_len=32)
    _, tc, _, _ = tllm.prefill_continue(
        m.tp["llm"], lcfg, torch.from_numpy(emb), torch.from_numpy(mask),
        *tpre, hint, quantize_cache=True, tail_len=32)
    return jc, tc, np.array(jv), np.array(jpos), tok


def _shared_hint(m):
    """The single-cache capacity of _shared_caches' prefix, chunk and tail:
    the LongRoPE hint of its steps."""
    return -(-(2 + m.cfg.num_video_tokens + 6 + 32) // 128) * 128


def mask_len(valid):
    """One past the last prompt slot of a valid mask [B, M]."""
    return int(np.nonzero(valid.any(0))[0].max()) + 1


@pytest.mark.parametrize("kind", ["plain", "shared"])
def test_decode_step_active_matches_jax(models, kind):
    m = models("phi3.5")
    lcfg = m.cfg.llm
    jc, tc, valid, pos, tok = (_plain_caches if kind == "plain"
                               else _shared_caches)(m)
    active = ACTIVE
    if kind == "plain":
        lj, cj, vj = jllm.decode_step(m.jp["llm"], lcfg, jnp.asarray(tok), jc,
                                      jnp.asarray(valid), jnp.asarray(pos),
                                      active=jnp.asarray(active))
        with torch.no_grad():
            lt, ct, vt = tllm.decode_step(
                m.tp["llm"], lcfg, torch.from_numpy(tok), tc,
                torch.from_numpy(valid), torch.from_numpy(pos),
                active=torch.from_numpy(active))
        keep = valid.copy()
        keep[:, mask_len(valid):] = True       # the step's slots, zeros
        _assert_quant_equal(ct, cj, keep)
    else:
        lj, cj, vj = jllm.decode_step_shared(
            m.jp["llm"], lcfg, jnp.asarray(tok), jc, jnp.asarray(valid),
            jnp.asarray(pos), rope_hint=_shared_hint(m),
            active=jnp.asarray(active))
        with torch.no_grad():
            lt, ct, vt = tllm.decode_step_shared(
                m.tp["llm"], lcfg, torch.from_numpy(tok), tc,
                torch.from_numpy(valid), torch.from_numpy(pos),
                rope_hint=_shared_hint(m), active=torch.from_numpy(active))
        keep = valid.copy()
        keep[:, mask_len(valid):] = True
        _assert_quant_equal(ct.tail, cj.tail, keep)
        ct, cj = ct.tail, cj.tail
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # the inactive row kept its length and gained no valid slot; the others
    # advanced by one
    np.testing.assert_array_equal(vt.numpy()[1], valid[1])
    before = np.asarray(jc.tail.length if kind == "shared" else jc.length)
    np.testing.assert_array_equal(ct.length.numpy(),
                                  before + active.astype(np.int32))


def test_decode_step_active_refuses_the_bf16_cache(models):
    m = models("phi3.5")
    cache = tllm.KVCache.create(m.cfg.llm, 3, 8, torch.float32)
    with pytest.raises(NotImplementedError, match="QuantKVCache"):
        tllm.decode_step(m.tp["llm"], m.cfg.llm,
                         torch.zeros(3, 1, m.cfg.llm.hidden_size), cache,
                         torch.ones(3, 8, dtype=torch.bool),
                         torch.zeros(3, dtype=torch.int32),
                         active=torch.from_numpy(ACTIVE))


@pytest.mark.parametrize("kind", ["plain", "shared"])
def test_commit_verify_per_row_counts_match_jax(models, kind):
    """_spec_chunk's commit: the per-row accepted counts, 0 on an inactive
    row (jnp.where(st.active, a, 0)), on the single cache and on the
    cascade's tail."""
    m = models("phi3.5")
    jc, tc, valid, _, _ = (_plain_caches if kind == "plain"
                           else _shared_caches)(m)
    if kind == "shared":
        jc, tc = jc.tail, tc.tail
    a = np.array([3, 2, 1], np.int32)
    n = np.where(ACTIVE, a, 0)
    jc2, jv2 = jllm.commit_verify(jc, jnp.asarray(valid), jnp.asarray(n), 3)
    tc2, tv2 = tllm.commit_verify(tc, torch.from_numpy(valid),
                                  torch.from_numpy(n), 3)
    np.testing.assert_array_equal(tv2.numpy(), np.asarray(jv2))
    np.testing.assert_array_equal(tc2.length.numpy(), np.asarray(jc2.length))
    np.testing.assert_array_equal(tv2.numpy()[1], valid[1])


# ---------------------------------------------------------------------------
# No host sync inside a chunk
# ---------------------------------------------------------------------------


_SYNCS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
          "__float__", "__index__")


@pytest.mark.parametrize("kw", [
    dict(), dict(spec_draft_len=2),
    dict(shared_prefix=True, prompt_len=7),
    dict(shared_prefix=True, prompt_len=7, spec_draft_len=2)],
    ids=["decode", "spec", "cascade", "cascade_spec"])
def test_chunk_reads_nothing_back(models, monkeypatch, kw):
    """Launching a chunk (_dispatch_chunk) calls none of the tensor methods
    that wait for the device and copy to the host, from the port's code
    (the CPU-only plain version of the cache writes, never run on the card,
    excepted); the tokens are read once, in _process_chunk."""
    import sys

    m = models("phi3.5")
    kw = dict(_pool(max_new_tokens=6), **kw)
    kw.update(_prefix_dims(m, kw))
    server = tcont.ContinuousServer(m.tp, m.cfg, **kw, **GREEDY)
    if kw.get("shared_prefix"):
        reqs = [p[0][1] for p in _requests(m, "one_video", kw, [None] * 2)]
    else:
        reqs = [_pixel(m, i)[0][1] for i in range(2)]
    staged = [(i, server.stage_request(r, server.device))
              for i, r in enumerate(reqs)]
    emitted = {i: [] for i in range(2)}
    server._admit(staged, emitted, {})
    assert server._busy()
    calls = []
    pkg = "grounded_video_llm_tpu_torch"

    def counting(name, orig):
        def wrapper(self, *a, **k):
            f = sys._getframe(1).f_code.co_filename.replace("\\", "/")
            if pkg in f and not f.endswith("ops/cache_write.py"):
                calls.append((name, f))
            return orig(self, *a, **k)
        return wrapper

    for name in _SYNCS:
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    inflight = server._dispatch_chunk()
    monkeypatch.undo()
    assert calls == []
    server._process_chunk(inflight, emitted, {})
    assert all(len(e) > 1 for e in emitted.values())


@pytest.mark.parametrize("kw", [
    dict(), dict(spec_draft_len=2),
    dict(shared_prefix=True, prompt_len=7),
    dict(shared_prefix=True, prompt_len=7, spec_draft_len=2)],
    ids=["decode", "spec", "cascade", "cascade_spec"])
def test_free_slot_stays_idle(models, kw):
    """A slot no request ever takes stays as the pool made it through every
    chunk: length 0, no valid slot, position and drafting pointer 0 (its
    rows commit 0 accepted drafts and decode in place)."""
    m = models("phi3.5")
    kw = dict(_pool(pool_size=3, max_new_tokens=6), **kw)
    kw.update(_prefix_dims(m, kw))
    server = tcont.ContinuousServer(m.tp, m.cfg, **kw, **GREEDY)
    if kw.get("shared_prefix"):
        reqs = [p[0][1] for p in _requests(m, "one_video", kw, [None] * 2)]
    else:
        reqs = [_pixel(m, i)[0][1] for i in range(2)]
    out = server.serve(reqs)
    assert all(len(o) > 1 for o in out)
    st = server.state
    cache = st.cache.tail if kw.get("shared_prefix") else st.cache
    assert server.timings["steps"] > 0
    assert int(cache.length[2]) == 0 and not bool(st.valid[2].any())
    assert int(st.positions[2]) == 0 and int(st.ptr[2]) == 0
    assert not bool(st.active[2])
