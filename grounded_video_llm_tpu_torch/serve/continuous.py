"""Slot-level continuous batching: admit new prefills into a running decode
pool (port of grounded_video_llm_tpu/serve/continuous.py).

A batch that decodes in lockstep makes a 64-token answer wait for the
2048-token answer beside it. Continuous batching keeps a fixed pool of B
decode slots over ONE int8 KV cache (``llm.QuantKVCache`` [L, B, Hkv,
max_len, Dh]) and:

  * prefills each arriving request alone (or ``admit_batch`` at a time)
    into a row cache of the pool's max_len, samples its first token and
    copies the row into a free slot in place (``_insert_row_impl``: sliced
    ``copy_`` along the slot axis; the pool is never copied whole);
  * decodes the whole pool in chunks of ``chunk`` steps with per-row
    positions, per-row cache-slot writes (K5 writes a different slot in
    every row of one launch) and per-row EOS retirement: finished and free
    slots idle under ``llm.decode_step``'s ``active`` mask.

A chunk of ``chunk`` steps is one step of serve/graphs.StepGraphs (JAX
runs one compiled fori_loop): the body writes the pool's state in place, and
on the card the whole chunk is one CUDA graph, keyed also by its length, so
``chunk_long`` has a graph of its own. EOS retirement, the active mask,
positions and the drafting buffers stay on the device and the chunk reads
nothing back: the host fetches a chunk's tokens once, through a pinned
buffer and a CUDA event on the card. Retirement on budget and admission are
host bookkeeping between chunks; admissions write into the state tensors
(``_insert_row_impl``), and a reset or a repin drops the pool's graphs with
its state.

Speculative chunks (``spec_draft_len``) verify n-gram drafts from each
slot's committed-token buffer in one pass (``llm.verify_step``: K8 scores,
K9 writes S slots from per-row bases) and commit per-row accepted counts.
The shared-prefix pool (``shared_prefix=True``) pins one video's prefix at
batch 1 (``llm.SharedPrefixCache``) and keeps per-slot tails; its chunks run
the cascade (``decode_step_shared`` / ``verify_step_shared``).

Stated differences from the JAX package: sampled tokens draw from one
``torch.Generator`` per server (JAX folds the request id into a key; greedy
tokens are the same); ``warmup`` compiles nothing, it builds the kernels by
running one budget-1 admission and one chunk over an all-inactive pool.

Requires an int8 KV cache, so any params tree serves (bf16, fp32 or
``serve/quantize.py``'s int8 trees); the decode projections of an int8 tree
run K3 and the lm_head K6.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from concurrent.futures import Future
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import VLMConfig
from ..models import llm as llm_mod
from ..models import vlm
from ..obs.profiler import record
from ..ops.int8_matmul import Int8Embedding
from ..text.templates import IMAGE_TOKEN_INDEX
from .generate import sample_logits
from .graphs import StepGraphs, assign
from .speculative import ngram_draft, spec_accept_tokens


class PoolState(NamedTuple):
    cache: object               # QuantKVCache [L, B, Hkv, max_len, Dh]; the
    #                             shared-prefix pool stores a
    #                             llm.SharedPrefixCache and `valid` covers
    #                             the per-slot TAIL only
    valid: torch.Tensor         # [B, max_len] bool
    positions: torch.Tensor     # [B] int32 next position id
    cur_token: torch.Tensor     # [B] int64 last sampled token
    active: torch.Tensor        # [B] bool
    # per-slot committed token ids (left-padded prompt, then generated) and
    # one past the last: the n-gram drafting context of speculative chunks.
    # One column past buf_len takes the writes a row cannot keep.
    buf: torch.Tensor           # [B, buf_len + 1] int64
    ptr: torch.Tensor           # [B] int64


class ChunkState(NamedTuple):
    """A chunk's step-graph state: the pool's, the slots retired since the
    last chunk (copied in before each chunk) and the chunk's outputs."""
    pool: PoolState
    deactivate: torch.Tensor    # [B] bool
    toks: torch.Tensor          # [B, chunk] (speculative: [B, chunk * S_v
    #                             + 1], one spare column)
    counts: Optional[torch.Tensor]   # [B] tokens a row emitted (speculative)


class _InflightChunk(NamedTuple):
    """A dispatched decode chunk whose tokens the host has not read: the
    device token arrays, their pinned host copies and the event that marks
    them landed (card only), the dispatch-time slot → request snapshot that
    _process_chunk attributes them with, and its timing marks."""
    toks: torch.Tensor          # [B, chunk * toks_per_iter] device
    counts: Optional[torch.Tensor]   # [B] (speculative) or None
    host: Optional[tuple]       # pinned (toks, counts) copies, card only
    done: Optional[object]      # torch.cuda.Event after the copies
    slot_req: tuple             # slot → rid at dispatch
    slot_cb: tuple              # slot → on_token at dispatch
    steps: int                  # decode steps or verify passes
    t0: int                     # host clock at dispatch (perf_counter_ns)
    events: Optional[tuple]     # (start, end) CUDA events around the chunk


class Request(NamedTuple):
    input_ids: object           # [S] left-padded, one IMAGE_TOKEN_INDEX
    attn_mask: object           # [S]
    spatial_pixels: object      # [num_segs, 336, 336, 3]
    temporal_pixels: object     # [num_frames, 224, 224, 3]
    max_new_tokens: Optional[int] = None   # per-request budget; None → the
    #                                        server's
    on_token: Optional[object] = None      # callable(int) fired on the host
    #                                        for each generated token (EOS
    #                                        excluded) as its chunk lands
    features: Optional[object] = None      # [NV, H_llm] precomputed
    #                                        vlm.encode_video features (the
    #                                        engine's feature cache): pixels
    #                                        are ignored and admission skips
    #                                        the encoders
    prefix: Optional[tuple] = None         # (k, v, mask) bf16 prefix KV from
    #                                        serve.generate.build_prefix_kv:
    #                                        input_ids/attn_mask hold only
    #                                        the post-image question chunk;
    #                                        same-video requests share it
    request_id: Optional[int] = None       # the front end's id, marking the
    #                                        request's spans to retirement
    queued_ns: Optional[int] = None        # perf_counter_ns of the
    #                                        scheduler's queue put: the start
    #                                        of its queue wait


def _prefill_features_body(params, cfg: VLMConfig, input_ids, attn_mask,
                           video_features, max_len: int):
    """Batched splice + prefill into an int8 row cache of the pool's
    max_len → (logits [k, V], cache, valid [k, max_len], next positions)."""
    k = input_ids.shape[0]
    embeds, _, mask = vlm.splice_multimodal(
        input_ids, None, attn_mask, video_features, params["llm"]["embed"])
    S_full = embeds.shape[1]
    cache = llm_mod.QuantKVCache.create(
        llm_mod.rank_config(params["llm"], cfg.llm), k, max_len,
        device=embeds.device)
    logits, cache = llm_mod.prefill(params["llm"], cfg.llm, embeds, mask,
                                    cache)
    valid = torch.zeros(k, max_len, dtype=torch.bool, device=embeds.device)
    valid[:, :S_full] = mask.bool()
    return logits, cache, valid, mask.sum(dim=-1).to(torch.int32)


def _prefill_batch(params, cfg: VLMConfig, input_ids, attn_mask, spatial,
                   temporal, max_len: int):
    """Multimodal prefill of [k, ...] pixel inputs (encode included)."""
    video_features = vlm.encode_video(params, cfg, spatial, temporal)
    return _prefill_features_body(params, cfg, input_ids, attn_mask,
                                  video_features, max_len)


# from precomputed features [k, NV, H] (Request.features): admission for a
# repeated video pays only the text prefill
_prefill_batch_from_features = _prefill_features_body


def _prefill_batch_from_prefix(params, cfg: VLMConfig, input_ids, attn_mask,
                               prefix_k, prefix_v, prefix_mask,
                               max_len: int):
    """Admission prefill of prefix-backed requests: only the question chunk
    input_ids [k, Sq] (llm.prefill_continue) against the shared bf16
    prefix, which is quantized into each row's cache."""
    lp = params["llm"]
    emb = llm_mod.embed_lookup(lp["embed"], input_ids,
                               llm_mod.embed_dtype(lp["embed"]))
    return llm_mod.prefill_continue(lp, cfg.llm, emb, attn_mask, prefix_k,
                                    prefix_v, prefix_mask, max_len,
                                    quantize_cache=True)


def _insert_row_impl(state: PoolState, batch_cache, batch_valid, batch_pos,
                     batch_ids, first_token, slot: int, row: int,
                     pad_token: int) -> PoolState:
    """Copy row `row` of a batched prefill's cache and bookkeeping into pool
    slot `slot`, in place (a sliced copy_ per buffer). batch_ids [k, S]:
    the prompt ids, which seed the slot's drafting buffer."""
    c = state.cache
    for dst, src in ((c.k, batch_cache.k), (c.k_scale, batch_cache.k_scale),
                     (c.v, batch_cache.v), (c.v_scale, batch_cache.v_scale)):
        dst[:, slot].copy_(src[:, row])
    c.length[slot] = batch_cache.length[row]
    S = batch_ids.shape[1]
    state.buf[slot, :S] = batch_ids[row]
    state.buf[slot, S:] = pad_token
    state.buf[slot, S] = first_token
    state.valid[slot] = batch_valid[row]
    state.positions[slot] = batch_pos[row]
    state.cur_token[slot] = first_token
    state.active[slot] = True
    state.ptr[slot] = S + 1
    return state


def _first_token(logits, generator, temperature, top_p, do_sample):
    return sample_logits(logits, generator, temperature, top_p, do_sample)[0]


def _admit_one(params, state: PoolState, cfg: VLMConfig, input_ids,
               attn_mask, spatial, temporal, slot: int, pad_token: int,
               generator, *, temperature: float, top_p, do_sample: bool):
    """Single-request admission: encode + prefill + first-token sample +
    slot insert → (state, first token, a device scalar)."""
    logits, bcache, bvalid, bpos = _prefill_batch(
        params, cfg, input_ids, attn_mask, spatial, temporal,
        state.valid.shape[1])
    first = _first_token(logits, generator, temperature, top_p, do_sample)
    return _insert_row_impl(state, bcache, bvalid, bpos, input_ids, first,
                            slot, 0, pad_token), first


def _admit_one_feats(params, state: PoolState, cfg: VLMConfig, input_ids,
                     attn_mask, features, slot: int, pad_token: int,
                     generator, *, temperature: float, top_p,
                     do_sample: bool):
    """_admit_one from precomputed video features (Request.features)."""
    logits, bcache, bvalid, bpos = _prefill_batch_from_features(
        params, cfg, input_ids, attn_mask, features, state.valid.shape[1])
    first = _first_token(logits, generator, temperature, top_p, do_sample)
    return _insert_row_impl(state, bcache, bvalid, bpos, input_ids, first,
                            slot, 0, pad_token), first


def _quantize_prefix_hd(prefix_k, prefix_v, prefix_mask):
    """The one-time pinning of a bf16 prefix KV into the SharedPrefixCache's
    int8 layout (llm.quantize_kv_head_major), once per video."""
    Sp = prefix_k.shape[2]
    pkq, pks = llm_mod.quantize_kv_head_major(prefix_k, Sp)
    pvq, pvs = llm_mod.quantize_kv_head_major(prefix_v, Sp)
    return pkq, pks, pvq, pvs, prefix_mask.to(torch.int32)


def _admit_one_shared(params, state: PoolState, cfg: VLMConfig, input_ids,
                      attn_mask, prefix_k, prefix_v, prefix_mask, slot: int,
                      pad_token: int, generator, *, rope_len: int,
                      temperature: float, top_p, do_sample: bool):
    """_admit_one for the shared-prefix pool: the question chunk prefills
    against the bf16 prefix (llm.prefill_continue, tail_len mode) and only
    its k/v land in the slot's tail; the pinned int8 prefix is untouched
    (prefill_continue's own quantized prefix is dropped)."""
    lp = params["llm"]
    emb = llm_mod.embed_lookup(lp["embed"], input_ids,
                               llm_mod.embed_dtype(lp["embed"]))
    logits, spc1, tval1, pos1 = llm_mod.prefill_continue(
        lp, cfg.llm, emb, attn_mask, prefix_k, prefix_v, prefix_mask,
        rope_len, quantize_cache=True, tail_len=state.valid.shape[1])
    first = _first_token(logits, generator, temperature, top_p, do_sample)
    # the row insert works on [L, B, ...] stacks: hand it the pool's tail
    _insert_row_impl(state._replace(cache=state.cache.tail), spc1.tail,
                     tval1, pos1, input_ids, first, slot, 0, pad_token)
    return state, first


def _admit_one_prefix(params, state: PoolState, cfg: VLMConfig, input_ids,
                      attn_mask, prefix_k, prefix_v, prefix_mask, slot: int,
                      pad_token: int, generator, *, temperature: float,
                      top_p, do_sample: bool):
    """_admit_one for a prefix-backed request (Request.prefix)."""
    logits, bcache, bvalid, bpos = _prefill_batch_from_prefix(
        params, cfg, input_ids, attn_mask, prefix_k, prefix_v, prefix_mask,
        state.valid.shape[1])
    first = _first_token(logits, generator, temperature, top_p, do_sample)
    return _insert_row_impl(state, bcache, bvalid, bpos, input_ids, first,
                            slot, 0, pad_token), first


def _decode_chunk(params, cs: ChunkState, cfg: VLMConfig, *, chunk: int,
                  generator, temperature: float, top_p, do_sample: bool,
                  eos_token_id: int, pad_token_id: int,
                  rope_len: Optional[int] = None) -> ChunkState:
    """`chunk` pool-wide decode steps, in place → cs, its toks [B, chunk]
    the sampled tokens with pad_token_id on inactive rows.

    cs.deactivate [B] bool: slots the host retired since the last chunk,
    applied at entry. A retired-but-still-active row decodes garbage into
    its own slot for at most one chunk (two, pipelined), which the max_len
    margin covers and the next insert overwrites. Shared-prefix pools
    decode through llm.decode_step_shared, rope_len the equivalent single
    cache's max_len."""
    lp = params["llm"]
    st = cs.pool
    B = st.cur_token.shape[0]
    shared = isinstance(st.cache, llm_mod.SharedPrefixCache)
    st.active.logical_and_(~cs.deactivate)
    buf_len = st.buf.shape[1] - 1
    rows = torch.arange(B, device=st.buf.device)
    for i in range(chunk):
        emb = llm_mod.embed_lookup(lp["embed"], st.cur_token)[:, None, :]
        if shared:
            logits, cache, valid = llm_mod.decode_step_shared(
                lp, cfg.llm, emb, st.cache, st.valid, st.positions,
                rope_hint=rope_len, active=st.active)
        else:
            logits, cache, valid = llm_mod.decode_step(
                lp, cfg.llm, emb, st.cache, st.valid, st.positions,
                active=st.active)
        nxt = sample_logits(logits, generator, temperature, top_p, do_sample)
        nxt = torch.where(st.active, nxt, pad_token_id)
        cs.toks[:, i] = nxt
        # buf/ptr ride along, so a later speculative chunk sees the whole
        # committed stream
        bcol = torch.where(st.active, st.ptr.clamp_max(buf_len - 1), buf_len)
        st.buf[rows, bcol] = nxt
        adv = st.active.to(torch.int32)
        st = assign(st, PoolState(cache, valid, st.positions + adv, nxt,
                                  st.active & (nxt != eos_token_id), st.buf,
                                  st.ptr + adv))
    return cs


def _spec_chunk(params, cs: ChunkState, cfg: VLMConfig, *, chunk: int,
                draft_len: int, generator, temperature: float, top_p,
                do_sample: bool, eos_token_id: int, pad_token_id: int,
                rope_len: Optional[int] = None) -> ChunkState:
    """`chunk` speculative verify passes over the pool, in place → cs, its
    toks [B, chunk * (draft_len + 1)] (plus a spare column) compacted per
    row and counts [B].

    Each pass drafts per slot from the pool's committed-token buffers
    (ngram_draft), verifies every row's drafts in one pass
    (llm.verify_step, or verify_step_shared on the tail) and commits per-row
    accepted counts, 0 on inactive rows."""
    lp = params["llm"]
    st = cs.pool
    shared = isinstance(st.cache, llm_mod.SharedPrefixCache)
    st.active.logical_and_(~cs.deactivate)
    dev = st.buf.device
    buf_len = st.buf.shape[1] - 1
    S_v = draft_len + 1
    out_w = chunk * S_v
    iidx = torch.arange(S_v, device=dev)[None, :]
    out, cnt = cs.toks, cs.counts
    out.fill_(pad_token_id)
    cnt.zero_()
    for _ in range(chunk):
        drafts = ngram_draft(st.buf[:, :buf_len], st.ptr, draft_len)
        cur = st.buf.gather(1, (st.ptr - 1).clamp_min(0)[:, None])
        emb = llm_mod.embed_lookup(lp["embed"],
                                   torch.cat([cur, drafts], dim=1))
        positions = st.positions[:, None] + iidx
        if shared:
            logits, cache = llm_mod.verify_step_shared(
                lp, cfg.llm, emb, st.cache, st.valid, positions,
                rope_hint=rope_len)
        else:
            logits, cache = llm_mod.verify_step(lp, cfg.llm, emb, st.cache,
                                                st.valid, positions)
        a, emitted = spec_accept_tokens(logits, drafts, generator,
                                        temperature, top_p, do_sample)
        n_accept = torch.where(st.active, a, 0)
        if shared:
            tail, valid = llm_mod.commit_verify(cache.tail, st.valid,
                                                n_accept, S_v)
            cache = cache._replace(tail=tail)
        else:
            cache, valid = llm_mod.commit_verify(cache, st.valid, n_accept,
                                                 S_v)
        is_eos = (emitted == eos_token_id) & (iidx < a[:, None])
        eos_pos = torch.where(is_eos, iidx, S_v).amin(dim=-1)
        e = torch.where(st.active, torch.minimum(a, eos_pos + 1), 0)
        within = iidx < e[:, None]
        out.scatter_(1, torch.where(within, cnt[:, None] + iidx, out_w),
                     emitted)
        col = st.ptr[:, None] + iidx
        st.buf.scatter_(1, torch.where(within & (col < buf_len), col,
                                       buf_len), emitted)
        active = st.active & ~(is_eos & within).any(dim=-1)
        st = assign(st, PoolState(cache, valid, st.positions + e.to(torch.int32),
                                  st.cur_token, active, st.buf, st.ptr + e))
        cnt.add_(e)
    return cs


def _params_device(params) -> torch.device:
    embed = params["llm"]["embed"]
    return (embed.q if isinstance(embed, Int8Embedding) else embed).device


def _to_device(x, device: torch.device, batch_ndim: int) -> torch.Tensor:
    """A host array as a [1, ...] tensor on device (already there with its
    batch dim: as it is). On the card the copy goes through pinned memory
    without blocking the host."""
    t = torch.as_tensor(x)
    if t.device == device and t.dim() == batch_ndim:
        return t
    if t.dim() < batch_ndim:
        t = t[None]
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class ContinuousServer:
    """Synchronous continuous-batching loop over a fixed slot pool.

    serve(requests) processes a request list to completion, admitting new
    requests into slots as they free; ContinuousScheduler drives the same
    admission and chunk steps from a thread.

    ``timings`` (cleared by the caller at will) sums: ``admit`` seconds
    over ``admissions`` (host clock; each admission ends on its first
    token's fetch) and, for requests that came through the scheduler's
    queue, ``queue_wait`` seconds from the queue put to the admission's
    start; ``chunks`` and ``steps`` (decode steps or verify passes) as
    they are launched; and over the ``timed_steps`` of the chunks whose
    tokens the host has read, ``chunk`` host seconds from each chunk's
    launch to its tokens landing, ``slot_tokens`` (the tokens those chunks
    gave live requests, an EOS included; at most pool_size × steps
    without drafts) and, on the card, ``chunk_device_ms`` between CUDA
    events around its launches. ServingFrontend adds its own and the
    engine's counters to the same dict.

    ``span_log`` (obs/profiler.SpanLog, None by default): where attached,
    the spans scheduler.queue, .admit and .decode (marked with the
    Request's request_id), scheduler.chunk and scheduler.wait (the loop
    blocked on an empty queue with the pool idle), and the front end's."""

    def __init__(self, params, cfg: VLMConfig, pool_size: int = 4,
                 prompt_len: int = 64, max_new_tokens: int = 64,
                 chunk: int = 8, temperature: float = 0.0,
                 top_p: Optional[float] = None, do_sample: bool = False,
                 eos_token_id: int = 2, pad_token_id: int = 0,
                 seed: int = 0, admit_batch: int = 1,
                 spec_draft_len: int = 0,
                 prefix_len: Optional[int] = None,
                 shared_prefix: bool = False,
                 admission_policy: str = "fifo",
                 chunk_long: int = 0,
                 pipeline_chunks: bool = False):
        self.params = params
        self.cfg = cfg
        # the caches hold this rank's kv heads on a 'tensor' split
        self._rank_cfg = llm_mod.rank_config(params["llm"], cfg.llm)
        self.device = _params_device(params)
        self.pool_size = pool_size
        self.chunk = chunk
        # adaptive tail chunk: with an empty queue and every occupied
        # slot's remaining budget covering it, a chunk of chunk_long steps;
        # the budget gate keeps the chunk-sized margins below correct
        self.chunk_long = chunk_long if chunk_long > chunk else 0
        # dispatch chunk k+1 before fetching chunk k's tokens: the fetch
        # overlaps the next chunk's device work; retirement and admission
        # lag one chunk, so the cache and buffer margins double. Greedy rows
        # give the unpipelined loop's tokens on the same pool shapes; where
        # the doubled margin moves max_len or the tail past a 128 boundary,
        # the card's reductions over the other lengths may round otherwise
        self.pipeline = pipeline_chunks
        # shared-prefix pool: one pinned int8 prefix at batch 1 and per-slot
        # tails; admissions must be prefix-backed, and a request for another
        # video waits until the pool drains, then the pool repins
        self.shared_prefix = shared_prefix
        if shared_prefix:
            if prefix_len is None:
                raise ValueError("shared_prefix pools need prefix_len to "
                                 "size the RoPE hint / fit checks")
            if admit_batch > 1:
                raise NotImplementedError(
                    "shared-prefix admission is single-request "
                    "(_admit_one_shared); admit_batch must be 1")
        self._pinned_prefix: Optional[tuple] = None
        # "fifo": arrival order; "longest_first": highest declared budget
        # first among the arrived requests (LPT makespan heuristic)
        if admission_policy not in ("fifo", "longest_first"):
            raise ValueError(f"unknown admission_policy {admission_policy!r}")
        self.admission_policy = admission_policy
        # speculative chunks: a row may overshoot its budget within a chunk
        # (retirement is host-side, between chunks); the margins cover
        # chunk * (draft_len + 1)
        self.spec_draft_len = spec_draft_len
        self._toks_per_iter = (spec_draft_len + 1) if spec_draft_len else 1
        self.admit_batch = max(1, admit_batch)
        self.max_new_tokens = max_new_tokens
        self.gen_kwargs = dict(temperature=temperature, top_p=top_p,
                               do_sample=do_sample, eos_token_id=eos_token_id,
                               pad_token_id=pad_token_id)
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        # max_len covers the longest spliced prompt (or prefix + question
        # bucket) + the budget + the overshoot margin, rounded to 128; it is
        # also the LongRoPE hint of every program of the pool
        self._prefix_len = prefix_len
        head = (prefix_len + prompt_len if prefix_len is not None
                else prompt_len - 1 + cfg.num_video_tokens)
        self._chunk_margin = ((2 if pipeline_chunks else 1)
                              * chunk * self._toks_per_iter)
        self.max_len = -(-(head + max_new_tokens
                           + self._chunk_margin) // 128) * 128
        # shared-prefix pools size the per-slot tail apart; max_len stays
        # the equivalent single cache's, for the same LongRoPE factors
        self._tail_len = -(-(prompt_len + max_new_tokens
                             + self._chunk_margin) // 128) * 128
        self._prompt_len = prompt_len
        self._buf_len = prompt_len + max_new_tokens + self._chunk_margin
        self._seed = seed
        self.generator = torch.Generator(device=self.device)
        self.timings: dict = {}
        self.span_log = None
        # the chunks' step graphs (chunk and chunk_long), over the pool's
        # state tensors: no budget, the state is the pool's own
        self.graphs = StepGraphs(max_state_bytes=None)
        self._reset()

    def _reset(self) -> None:
        """A fresh pool (as a new server's): the state (None for a
        shared-prefix pool, assembled at its first pin), the slot table and
        the sampling generator's seed; the graphs go with the old state."""
        self._pinned_prefix = None
        self.graphs.clear()
        self.state = None      # the old pool goes before the new one exists
        self.state = None if self.shared_prefix else self._init_state(
            llm_mod.QuantKVCache.create(self._rank_cfg, self.pool_size,
                                        self.max_len, device=self.device),
            self.max_len)
        self.generator.manual_seed(self._seed)
        self._slot_req: List[Optional[int]] = [None] * self.pool_size
        self._slot_budget = [0] * self.pool_size
        self._slot_cb: List[Optional[object]] = [None] * self.pool_size
        # slot → (request_id, perf_counter_ns of its first token): the
        # scheduler.decode span's start
        self._slot_first: List[Optional[tuple]] = [None] * self.pool_size
        # size of the most recently dispatched chunk: the pipelined
        # chunk_long gate's staleness allowance
        self._last_dispatch_chunk = self.chunk

    def _init_state(self, cache, width: int) -> PoolState:
        B, dev = self.pool_size, self.device
        return PoolState(
            cache, torch.zeros(B, width, dtype=torch.bool, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.zeros(B, dtype=torch.int64, device=dev),
            torch.zeros(B, dtype=torch.bool, device=dev),
            torch.full((B, self._buf_len + 1), self.pad_token_id,
                       dtype=torch.int64, device=dev),
            torch.zeros(B, dtype=torch.int64, device=dev))

    @torch.no_grad()
    def _pin_shared_prefix(self, prefix: tuple) -> None:
        """(Re)pin the pool to one video's prefix: quantize it once into the
        SharedPrefixCache layout and build the (empty) pool around it. Only
        when no slot is occupied; the generator carries on, so sampled
        serving does not replay one stream for every video."""
        if self._busy():
            raise RuntimeError("repinning needs an idle pool")
        Sp = prefix[0].shape[2]
        if (Sp + self._prompt_len + self.max_new_tokens
                + self._chunk_margin) > self.max_len:
            raise ValueError(
                f"prefix ({Sp}) + question bucket + budget overflow the "
                f"pool's RoPE envelope (max_len={self.max_len}); build the "
                "server with a larger prefix_len")
        # the old pool and its pin go together: a repin that fails below
        # leaves no pin, so the next request repins instead of admitting
        # into a pool that is gone; its graphs go with it
        self.graphs.clear()
        self.state = self._pinned_prefix = None
        pkq, pks, pvq, pvs, pmask = _quantize_prefix_hd(*prefix)
        tail = llm_mod.QuantKVCache.create(self._rank_cfg, self.pool_size,
                                           self._tail_len, device=self.device)
        self.state = self._init_state(
            llm_mod.SharedPrefixCache(pkq, pks, pvq, pvs, pmask, tail),
            self._tail_len)
        self._pinned_prefix = prefix

    def warmup(self, kind: Optional[str] = None) -> None:
        """Build the pool's kernels before live traffic: one dummy budget-1
        admission of `kind` ("prefix", "feats" or "pixels"; None: prefix for
        prefix_len pools, else feats), then the chunk (and chunk_long)
        program over an all-inactive pool with the live arguments. The
        pool is reset afterwards, so a warmed server starts exactly as a
        fresh one. Needs an idle pool; per-program seconds go to stderr."""
        if self._busy():
            raise RuntimeError("warmup() needs an idle pool")
        if kind is None:
            kind = "prefix" if self._prefix_len is not None else "feats"
        lcfg, dev = self.cfg.llm, self.device
        try:
            ids = np.full((self._prompt_len,), 3, np.int32)
            mask = np.ones((self._prompt_len,), np.int32)
            req = Request(ids, mask, None, None, max_new_tokens=1)
            if kind == "prefix":
                Sp = self._prefix_len
                if Sp is None:
                    raise ValueError("prefix warmup needs prefix_len")
                rcfg = self._rank_cfg
                pk = torch.zeros(rcfg.num_layers, 1, Sp, rcfg.num_kv_heads,
                                 rcfg.head_dim, dtype=torch.bfloat16,
                                 device=dev)
                req = req._replace(prefix=(pk, pk, torch.ones(
                    1, Sp, dtype=torch.int32, device=dev)))
            elif kind == "feats":
                ids[1] = IMAGE_TOKEN_INDEX
                req = req._replace(features=np.zeros(
                    (self.cfg.num_video_tokens, lcfg.hidden_size),
                    np.float32))
            elif kind == "pixels":
                ids[1] = IMAGE_TOKEN_INDEX
                req = req._replace(
                    spatial_pixels=np.zeros(
                        (self.cfg.num_segs, 336, 336, 3), np.uint8),
                    temporal_pixels=np.zeros(
                        (self.cfg.num_frames, 224, 224, 3), np.uint8))
            else:
                raise ValueError(f"unknown warmup kind {kind!r}")
            t0 = time.perf_counter()
            self.serve([req])
            print(f"warmup[admission/{kind}]: {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr)
            for ch in [self.chunk] + ([self.chunk_long]
                                      if self.chunk_long else []):
                t0 = time.perf_counter()
                self._run_chunk({}, {}, force_chunk=ch)
                print(f"warmup[chunk{ch}"
                      f"{'/spec' if self.spec_draft_len else ''}]: "
                      f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
        finally:
            self._reset()
            self.timings = {}

    def serve(self, requests: List[Request]) -> List[np.ndarray]:
        """→ per-request generated token arrays (int32, EOS excluded)."""
        results: dict = {}
        emitted: dict = {i: [] for i in range(len(requests))}
        pending = [(i, self.stage_request(requests[i], self.device))
                   for i in range(len(requests))]
        if self.pipeline:
            inflight = None
            while pending or self._busy() or inflight is not None:
                self._admit(pending, emitted, results)
                nxt = (self._dispatch_chunk(tail=not pending)
                       if self._busy() else None)
                if inflight is not None:
                    self._process_chunk(inflight, emitted, results)
                inflight = nxt
        else:
            while pending or self._busy():
                self._admit(pending, emitted, results)
                if self._busy():
                    self._run_chunk(emitted, results, tail=not pending)
        return [results.get(i, np.zeros(0, np.int32))
                for i in range(len(requests))]

    @staticmethod
    def stage_request(req: Request, device) -> Request:
        """Start the request's host → device transfers now (non-blocking
        through pinned memory on the card), so they overlap decode chunks
        instead of the admission prefill. Arrays gain a leading batch dim
        [1, ...]; idempotent. A prefix-backed request's prefix is already on
        the device; a feature-backed one moves its features, not pixels."""
        device = torch.device(device)
        staged = req._replace(
            input_ids=_to_device(req.input_ids, device, 2).long(),
            attn_mask=_to_device(req.attn_mask, device, 2).long())
        if req.prefix is not None:
            return staged
        if req.features is not None:
            return staged._replace(features=_to_device(req.features, device,
                                                       3))
        return staged._replace(
            spatial_pixels=_to_device(req.spatial_pixels, device, 5),
            temporal_pixels=_to_device(req.temporal_pixels, device, 5))

    # -- incremental engine (shared by serve() and ContinuousScheduler) ------

    def _busy(self) -> bool:
        return any(r is not None for r in self._slot_req)

    def _check_prefix_fit(self, prefix, Sq: int) -> None:
        Sp = prefix[0].shape[2]
        if Sp + Sq + self.max_new_tokens + self._chunk_margin > self.max_len:
            raise ValueError(
                f"prefix ({Sp}) + question bucket ({Sq}) + budget "
                f"overflow the pool cache (max_len={self.max_len}); "
                "build the server with prefix_len set")

    def _add(self, key: str, value) -> None:
        self.timings[key] = self.timings.get(key, 0) + value

    def _book_first_token(self, rid, req, slot, first_i, emitted,
                          results) -> bool:
        """Host bookkeeping after an admission's first token; True if the
        request already finished (EOS or a budget of 1)."""
        self._slot_req[slot] = rid
        self._slot_cb[slot] = req.on_token
        self._slot_first[slot] = (req.request_id, time.perf_counter_ns())
        budget = req.max_new_tokens or self.max_new_tokens
        self._slot_budget[slot] = min(budget, self.max_new_tokens) - 1
        if first_i != self.eos_token_id and req.on_token is not None:
            req.on_token(first_i)
        emitted[rid].append(first_i)
        if first_i == self.eos_token_id or self._slot_budget[slot] == 0:
            results[rid] = self._finish(rid, emitted)
            self._retire(slot)
            return True
        return False

    def _retire(self, slot: int) -> None:
        """Free a slot whose request finished; its scheduler.decode span
        ends here."""
        request_id, t0 = self._slot_first[slot]
        record(None, None, t0, log=self.span_log, name="scheduler.decode",
               request_id=request_id)
        self._slot_req[slot] = None
        self._slot_cb[slot] = None
        self._slot_first[slot] = None

    def _admitted(self, take, t0: int) -> None:
        """Count an admission of take [(rid, Request), ...] that began at
        t0: admit and admissions, each queued request's queue_wait, and
        the spans scheduler.queue and scheduler.admit."""
        log = self.span_log
        t1 = record(self.timings, "admit", t0)
        self._add("admissions", len(take))
        for _, req in take:
            if req.queued_ns is not None:
                record(self.timings, "queue_wait", req.queued_ns, t1=t0,
                       log=log, name="scheduler.queue",
                       request_id=req.request_id)
            record(None, None, t0, t1=t1, log=log, name="scheduler.admit",
                   request_id=req.request_id)

    def _sample_kw(self) -> dict:
        gk = self.gen_kwargs
        return dict(temperature=gk["temperature"], top_p=gk["top_p"],
                    do_sample=gk["do_sample"])

    @torch.no_grad()
    def _admit(self, pending, emitted, results) -> None:
        """Fill free slots from `pending` [(rid, Request), ...] (staged by
        stage_request). admit_batch = 1: one request per admission
        (_admit_one*); more: batched prefills over power-of-2 buckets padded
        by repeating a request, one kind of request per batch."""
        sample_kw = self._sample_kw()
        if self.admission_policy == "longest_first" and len(pending) > 1:
            # stable: arrival order breaks budget ties
            pending.sort(key=lambda it: -(it[1].max_new_tokens
                                          or self.max_new_tokens))
        if self.shared_prefix:
            self._admit_shared(pending, emitted, results, sample_kw)
            return
        while pending:
            free = [s for s in range(self.pool_size)
                    if self._slot_req[s] is None]
            if not free:
                return
            take = pending[: min(len(free), self.admit_batch)]

            # one batched prefill serves one kind: pixel-, feature- or
            # prefix-backed, the last only with the same prefix arrays
            def kind(r: Request):
                if r.prefix is not None:
                    return ("prefix", id(r.prefix))
                return ("feats",) if r.features is not None else ("pixels",)

            want = kind(take[0][1])
            for j in range(1, len(take)):
                if kind(take[j][1]) != want:
                    take = take[:j]
                    break
            del pending[: len(take)]
            t0 = time.perf_counter_ns()
            if len(take) == 1:
                rid, req = take[0]
                slot = free[0]
                args = (slot, self.pad_token_id, self.generator)
                if want[0] == "prefix":
                    self._check_prefix_fit(req.prefix, req.input_ids.shape[1])
                    self.state, first = _admit_one_prefix(
                        self.params, self.state, self.cfg, req.input_ids,
                        req.attn_mask, *req.prefix, *args, **sample_kw)
                elif want[0] == "feats":
                    self.state, first = _admit_one_feats(
                        self.params, self.state, self.cfg, req.input_ids,
                        req.attn_mask, req.features, *args, **sample_kw)
                else:
                    self.state, first = _admit_one(
                        self.params, self.state, self.cfg, req.input_ids,
                        req.attn_mask, req.spatial_pixels,
                        req.temporal_pixels, *args, **sample_kw)
                # EOS-on-first / budget-1: the row was inserted; its slot is
                # free again, so the next chunk's deactivate retires it
                self._book_first_token(rid, req, slot, int(first), emitted,
                                       results)
            else:
                self._admit_batch(take, want, free, emitted, results,
                                  sample_kw)
            self._admitted(take, t0)

    def _admit_batch(self, take, want, free, emitted, results,
                     sample_kw) -> None:
        k = len(take)
        bucket = 1
        while bucket < k:
            bucket *= 2
        idx = [take[i % k][1] for i in range(bucket)]     # pad by repeat
        bids = torch.cat([r.input_ids for r in idx])
        battn = torch.cat([r.attn_mask for r in idx])
        if want[0] == "prefix":
            self._check_prefix_fit(take[0][1].prefix, bids.shape[1])
            logits, bcache, bvalid, bpos = _prefill_batch_from_prefix(
                self.params, self.cfg, bids, battn, *take[0][1].prefix,
                self.max_len)
        elif want[0] == "feats":
            logits, bcache, bvalid, bpos = _prefill_batch_from_features(
                self.params, self.cfg, bids, battn,
                torch.cat([r.features for r in idx]), self.max_len)
        else:
            logits, bcache, bvalid, bpos = _prefill_batch(
                self.params, self.cfg, bids, battn,
                torch.cat([r.spatial_pixels for r in idx]),
                torch.cat([r.temporal_pixels for r in idx]), self.max_len)
        for i, (rid, req) in enumerate(take):
            slot = free[i]
            first = _first_token(logits[i:i + 1], self.generator,
                                 **sample_kw)
            if self._book_first_token(rid, req, slot, int(first), emitted,
                                      results):
                continue
            _insert_row_impl(self.state, bcache, bvalid, bpos, bids, first,
                             slot, i, self.pad_token_id)

    def _admit_shared(self, pending, emitted, results, sample_kw) -> None:
        """Admission for the shared-prefix pool: pending requests that match
        the pinned prefix (the same bf16 arrays) admit; requests for other
        videos wait until the pool drains, then the pool repins to the
        oldest waiter's prefix. Same-video requests may therefore admit
        ahead of an older different-video request."""
        while pending:
            free = [s for s in range(self.pool_size)
                    if self._slot_req[s] is None]
            if not free:
                return
            idx = None
            if self._pinned_prefix is not None:
                for j, (_, r) in enumerate(pending):
                    if (r.prefix is not None
                            and r.prefix[0] is self._pinned_prefix[0]):
                        idx = j
                        break
            if idx is None:
                if self._busy():
                    return  # drain first, then repin to pending[0]'s video
                req0 = pending[0][1]
                if req0.prefix is None:
                    raise ValueError(
                        "shared-prefix pools serve prefix-backed requests "
                        "only (set Request.prefix)")
                self._pin_shared_prefix(req0.prefix)
                idx = 0
            rid, req = pending.pop(idx)
            Sq = req.input_ids.shape[1]
            if Sq + self.max_new_tokens + self._chunk_margin > self._tail_len:
                raise ValueError(
                    f"question bucket ({Sq}) + budget overflow the per-slot "
                    f"tail (tail_len={self._tail_len}); build the server "
                    "with a larger prompt_len")
            slot = free[0]
            t0 = time.perf_counter_ns()
            self.state, first = _admit_one_shared(
                self.params, self.state, self.cfg, req.input_ids,
                req.attn_mask, *self._pinned_prefix, slot,
                self.pad_token_id, self.generator, rope_len=self.max_len,
                **sample_kw)
            self._book_first_token(rid, req, slot, int(first), emitted,
                                   results)
            self._admitted([(rid, req)], t0)

    def _run_chunk(self, emitted, results, tail: bool = False,
                   force_chunk: Optional[int] = None) -> None:
        """One decode chunk over the pool, then the host retirement (the
        unpipelined composition of _dispatch_chunk and _process_chunk)."""
        self._process_chunk(self._dispatch_chunk(tail, force_chunk),
                            emitted, results)

    @torch.no_grad()
    def _dispatch_chunk(self, tail: bool = False,
                        force_chunk: Optional[int] = None) -> _InflightChunk:
        """Launch one decode chunk over the pool without reading its tokens
        → an _InflightChunk for _process_chunk (on the card: the tokens'
        pinned host copies are queued behind the chunk).

        Slots with no owner ride the chunk's `deactivate` argument, so
        retirement needs no launch of its own. tail=True (the caller's
        queue is empty) runs chunk_long steps when every occupied slot's
        remaining budget covers them. force_chunk: that many steps (warmup,
        over an all-inactive pool)."""
        chunk = self.chunk
        if force_chunk is not None:
            chunk = force_chunk
        elif tail and self.chunk_long:
            budgets = [self._slot_budget[s] for s in range(self.pool_size)
                       if self._slot_req[s] is not None]
            # pipelined loops see budgets stale by one unprocessed chunk:
            # widen the gate by its worst-case consumption
            stale = self._last_dispatch_chunk if self.pipeline else 0
            if budgets and min(budgets) >= (self.chunk_long + stale) \
                    * self._toks_per_iter:
                chunk = self.chunk_long
        t0 = time.perf_counter_ns()
        cuda = self.device.type == "cuda"
        events = None
        if cuda:
            events = tuple(torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            events[0].record(torch.cuda.current_stream(self.device))
        deact = _to_device(np.asarray([r is None for r in self._slot_req],
                                      bool), self.device, 1)
        rope_len = self.max_len if self.shared_prefix else None
        B, dev = self.pool_size, self.device
        # the body closes over no self: the server owns the graphs that own
        # the body
        params, cfg, spec = self.params, self.cfg, self.spec_draft_len
        kw = dict(chunk=chunk, generator=self.generator, rope_len=rope_len,
                  **self.gen_kwargs)
        if spec:
            width = chunk * self._toks_per_iter
            cs = ChunkState(self.state, deact,
                            torch.empty(B, width + 1, dtype=torch.int64,
                                        device=dev),
                            torch.empty(B, dtype=torch.int64, device=dev))

            def body(cs):
                return _spec_chunk(params, cs, cfg, draft_len=spec, **kw)
        else:
            width = chunk
            cs = ChunkState(self.state, deact,
                            torch.empty(B, chunk, dtype=torch.int64,
                                        device=dev), None)

            def body(cs):
                return _decode_chunk(params, cs, cfg, **kw)
        lp = params["llm"]
        loop = self.graphs.loop(
            ("chunk", chunk, spec, rope_len,
             *sorted(self.gen_kwargs.items())), cs, body,
            refs=(lp, cfg, self.generator), params=lp,
            generator=self.generator)
        loop.step()
        cs = loop.state
        self.state = cs.pool
        toks, counts = cs.toks[:, :width], cs.counts
        host = done = None
        if not cuda:
            # the next chunk writes the same buffers
            toks = toks.clone()
            counts = None if counts is None else counts.clone()
        else:
            stream = torch.cuda.current_stream(self.device)
            events[1].record(stream)
            host = tuple(None if x is None else
                         torch.empty(x.shape, dtype=x.dtype,
                                     pin_memory=True).copy_(
                                         x, non_blocking=True)
                         for x in (toks, counts))
            done = torch.cuda.Event()
            done.record(stream)
        self._last_dispatch_chunk = chunk
        self._add("chunks", 1)
        self._add("steps", chunk)
        return _InflightChunk(toks, counts, host, done, tuple(self._slot_req),
                              tuple(self._slot_cb), chunk, t0, events)

    def _process_chunk(self, inflight: _InflightChunk, emitted,
                       results) -> None:
        """Read an inflight chunk's tokens on the host (the one wait of a
        chunk) and run the retirement bookkeeping. Pipelined, the next
        chunk is already launched, so the wait overlaps it.

        Tokens are attributed with the dispatch-time slot snapshot,
        skipping slots the live table no longer gives to the snapshot rid:
        a row that finished after dispatch freed its slot, and rids are
        never reused."""
        if inflight.done is not None:
            inflight.done.synchronize()
            toks, counts = inflight.host
        else:
            toks, counts = inflight.toks, inflight.counts
        toks = toks.numpy()
        counts = (counts.numpy() if counts is not None
                  else np.full(self.pool_size, toks.shape[1]))
        record(self.timings, "chunk", inflight.t0, log=self.span_log,
               name="scheduler.chunk")
        self._add("timed_steps", inflight.steps)
        if inflight.events is not None:
            self._add("chunk_device_ms",
                      inflight.events[0].elapsed_time(inflight.events[1]))
        for slot in range(self.pool_size):
            rid = inflight.slot_req[slot]
            if rid is None or self._slot_req[slot] != rid:
                continue
            # every token up to and including an EOS is real: the device
            # pads only after an in-chunk EOS (or compacts per-row counts)
            cb = inflight.slot_cb[slot]
            used = 0
            for t in toks[slot][:counts[slot]]:
                t = int(t)
                used += 1
                done = t == self.eos_token_id
                if not done:
                    emitted[rid].append(t)
                    self._slot_budget[slot] -= 1
                    if cb is not None:
                        cb(t)
                if done or self._slot_budget[slot] <= 0:
                    results[rid] = self._finish(rid, emitted)
                    # no launch: the next chunk's deactivate retires the row
                    self._retire(slot)
                    break
            self._add("slot_tokens", used)

    def _finish(self, ridx: int, emitted) -> np.ndarray:
        return np.asarray(emitted[ridx], np.int32)


class ContinuousScheduler:
    """Threaded front-end over ContinuousServer: submit() returns a Future;
    the scheduler thread admits queued requests into the pool between
    decode chunks. A failed admission or chunk resolves every open future
    with the exception and resets the pool (queued work dropped, slots
    freed, rows deactivated), as the JAX package does."""

    def __init__(self, server: ContinuousServer):
        self.server = server
        self._queue: "queue.Queue" = queue.Queue()
        self._futures: dict = {}
        self._emitted: dict = {}
        self._results: dict = {}
        self._next_rid = 0
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, req: Request) -> Future:
        fut: Future = Future()
        # stage the transfers at submit time: they overlap the pool's chunks
        staged = ContinuousServer.stage_request(req, self.server.device)
        self._queue.put((staged._replace(queued_ns=time.perf_counter_ns()),
                         fut))
        return fut

    def shutdown(self, wait: bool = True) -> None:
        self._running = False
        self._queue.put(None)
        if wait:
            self._thread.join(timeout=120)

    def _drain(self, pending, block: bool) -> bool:
        try:
            item = self._queue.get(timeout=0.05 if block else 0.0)
        except queue.Empty:
            return True
        if item is None:
            return False
        req, fut = item
        rid = self._next_rid
        self._next_rid += 1
        self._futures[rid] = fut
        self._emitted[rid] = []
        pending.append((rid, req))
        return True

    def _loop(self) -> None:
        server = self.server
        pending: list = []
        alive = True
        inflight = None  # pipeline_chunks: chunk launched, tokens not read
        while self._running and alive:
            # block for work only when fully idle: the scheduler.wait span
            idle = not (pending or server._busy() or inflight is not None)
            t0 = time.perf_counter_ns()
            alive = self._drain(pending, block=idle)
            if idle:
                record(None, None, t0, log=server.span_log,
                       name="scheduler.wait")
            while alive and not self._queue.empty():
                alive = self._drain(pending, block=False)
            if not (pending or server._busy() or inflight is not None):
                continue
            try:
                server._admit(pending, self._emitted, self._results)
                # a long tail chunk only when nothing waits anywhere
                tail = not pending and self._queue.empty()
                if server.pipeline:
                    nxt = (server._dispatch_chunk(tail=tail)
                           if server._busy() else None)
                    if inflight is not None:
                        server._process_chunk(inflight, self._emitted,
                                              self._results)
                    inflight = nxt
                elif server._busy():
                    server._run_chunk(self._emitted, self._results,
                                      tail=tail)
            except Exception as e:  # noqa: BLE001 — propagate to callers
                for fut in self._futures.values():
                    if not fut.done():
                        fut.set_exception(e)
                self._futures.clear()
                # the pool state is suspect: drop queued work and free every
                # slot, or orphaned rows would decode forever
                pending.clear()
                self._emitted.clear()
                self._results.clear()
                inflight = None
                server._slot_req = [None] * server.pool_size
                server._slot_cb = [None] * server.pool_size
                server._slot_first = [None] * server.pool_size
                if server.state is not None:   # shared pools pin lazily
                    server.state.active.fill_(False)
                continue
            for rid in list(self._results):
                fut = self._futures.pop(rid, None)
                if fut is not None and not fut.done():
                    fut.set_result(self._results.pop(rid))
                self._emitted.pop(rid, None)
