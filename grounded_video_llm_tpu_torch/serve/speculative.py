"""Speculative (multi-token) decoding: prompt-lookup drafts and one verify
pass per step (port of grounded_video_llm_tpu/serve/speculative.py).

Each pass feeds the last committed token and K drafts to llm.verify_step,
which streams the int8 cache and the weights once for all K + 1 candidates
(K8 scores them, K9 writes their k/v), accepts a prefix of the drafts and
emits one fresh token; commit_verify then reveals the accepted slots.

Drafting is n-gram prompt lookup (``ngram_draft``): the tokens that followed
the most recent earlier occurrence of the committed tail (trigram first,
bigram fallback) in the prompt + generated buffer. ``table_draft`` reads
drafts from an external table aligned with that buffer instead.

Contracts:
  * greedy: the emitted tokens are always the model's own argmax; drafts
    only decide how many commit per pass. Under the int8 cache the in-pass
    candidates' k/v stay bf16 while a lockstep step reads earlier tokens
    back quantized, so a greedy stream can depend on where the passes fall;
  * sampling: deterministic (delta) drafts use the rejection rule of
    Leviathan et al. (accept draft d with probability p(d), else sample
    max(0, p - 1{d}) renormalised), so each emitted token is marginally an
    exact sample from the model distribution (temperature and top-p
    applied). The draws come from an explicit torch.Generator, so they
    differ from the JAX package's jax.random streams.

The loop is JAX's draft / verify ``while_loop``: one draft → verify →
accept → commit pass over a ``SpecState`` is the step, written in place and
run through serve/graphs.StepGraphs (a captured CUDA graph on the card),
with per-row EOS and token-budget cuts; the host reads whether a row is
still alive after each pass. The cache keeps a draft margin of K + 1 slots
past prompt + max_new_tokens.
``generate_tokens_spec_from_prefix`` runs the same loop over the cascade
cache of prefix-KV serving (llm.verify_step_shared, commits on the tail).
``timings`` gets the phases (encode, prefill, decode) on the synchronised
host clock and ``verify_passes``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.config import VLMConfig
from ..models import llm as llm_mod
from ..models import vlm
from .generate import _ceil128, _PhaseClock, draw_categorical, sample_logits
from .graphs import StepGraphs, assign


def ngram_draft(buf: torch.Tensor, ptr: torch.Tensor,
                draft_len: int) -> torch.Tensor:
    """Prompt-lookup drafts [B, draft_len]: for each row, the tokens after
    the most recent earlier position whose context matches the committed
    tail (trigram first, then bigram); no match proposes from the buffer
    head. buf [B, C] committed ids (left-padded prompt, then generated,
    pad-filled tail); ptr [B] one past the last committed token."""
    B, C = buf.shape

    def at(offset):
        return buf.gather(1, (ptr - offset).clamp_min(0)[:, None].long())

    t1, t2, t3 = at(1), at(2), at(3)
    pos = torch.arange(1, C, device=buf.device)[None, :]   # match END index
    m2 = (buf[:, :-1] == t2) & (buf[:, 1:] == t1)           # [B, C-1]
    m3 = torch.cat([torch.zeros(B, 1, dtype=torch.bool, device=buf.device),
                    m2[:, 1:] & (buf[:, :-2] == t3)], dim=1)
    earlier = pos < (ptr - 1)[:, None]
    best3 = torch.where(m3 & earlier, pos, -1).amax(dim=-1)
    best2 = torch.where(m2 & earlier, pos, -1).amax(dim=-1)
    best = torch.where(best3 >= 0, best3, best2)
    start = torch.where(best >= 0, best + 1, 0)
    idx = (start[:, None] + torch.arange(draft_len, device=buf.device)[None]
           ).clamp_max(C - 1)
    return buf.gather(1, idx)


def table_draft(table: torch.Tensor, ptr: torch.Tensor,
                draft_len: int) -> torch.Tensor:
    """External drafts table[b, ptr .. ptr + K - 1], the table aligned with
    the committed buffer; reads past its end clamp to the last column."""
    idx = (ptr[:, None] + torch.arange(draft_len, device=table.device)[None]
           ).clamp_max(table.shape[1] - 1)
    return table.long().gather(1, idx.long())


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """HF top-p semantics (serve/generate.sample_logits) on any [..., V]."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    cutoff = (cum - sorted_probs) >= top_p
    thr = torch.where(cutoff, torch.inf, sorted_logits).amin(dim=-1,
                                                              keepdim=True)
    return torch.where(logits < thr, -torch.inf, logits)


def spec_accept_tokens(logits: torch.Tensor, drafts: torch.Tensor,
                       generator: Optional[torch.Generator],
                       temperature: float, top_p: Optional[float],
                       do_sample: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The accept/emit rule of one pass → (a [B], emitted [B, S_v]).

    logits [B, S_v, V] from verify_step (S_v = K + 1), drafts [B, K]. a in
    [1, S_v] tokens are emitted: emitted[:, :a] are the accepted drafts and
    one fresh token (a residual sample on rejection, the bonus token on full
    acceptance). Greedy: accept while draft == argmax, fresh = argmax."""
    B, S_v, V = logits.shape
    K = S_v - 1
    dev = logits.device
    iidx = torch.arange(S_v, device=dev)[None, :]
    drafts = drafts.long()
    if do_sample and temperature > 0.0:
        lg = logits.float() / temperature
        if top_p is not None and top_p < 1.0:
            lg = _top_p_filter(lg, top_p)
        p = torch.softmax(lg, dim=-1)                        # [B, S_v, V]
        # a draft outside the vocabulary (the prompt's image placeholder) is
        # never accepted: its probability counts as 0
        in_vocab = (drafts >= 0) & (drafts < V)
        d = torch.where(in_vocab, drafts, 0)
        pd = torch.where(in_vocab, p[:, :K].gather(-1, d[..., None])[..., 0],
                         0.0)
        accept = torch.rand(B, K, generator=generator, device=dev) < pd
        # the fresh token per position: the residual at 0..K-1, p at K
        onehot = (torch.nn.functional.one_hot(d, V).to(p.dtype)
                  * in_vocab[..., None])
        resid = (p[:, :K] - onehot).clamp_min(0.0)
        # an all-zero residual means p(d) = 1: acceptance was certain and
        # the row is never used, but the draw needs positive weights
        resid = torch.where(resid.sum(dim=-1, keepdim=True) > 0.0, resid,
                            1.0 / V)
        weights = torch.cat([resid, p[:, K:]], dim=1).reshape(B * S_v, V)
        fresh = draw_categorical(weights, generator).reshape(B, S_v)
    else:
        fresh = torch.argmax(logits, dim=-1)                 # [B, S_v]
        accept = drafts == fresh[:, :-1]
    a = 1 + torch.cumprod(accept.long(), dim=-1).sum(dim=-1)
    drafts_ext = torch.cat([drafts, drafts.new_zeros(B, 1)], dim=1)
    emitted = torch.where(iidx < (a - 1)[:, None], drafts_ext, fresh)
    return a, emitted


class SpecState(NamedTuple):
    """The draft / verify loop's state; a pass writes it in place."""
    cache: object               # QuantKVCache or SharedPrefixCache
    valid_mask: torch.Tensor    # [B, max_len] (the cascade: [B, tail])
    pos_next: torch.Tensor      # [B] position id of the next fed token
    buf: torch.Tensor           # [B, S_prompt + max_new + 1] committed ids
    step: torch.Tensor          # [B] tokens emitted per row
    done: torch.Tensor          # [B]
    live: torch.Tensor          # [1] bool: a row is still alive (JAX's cond)
    table: Optional[torch.Tensor]   # external drafts, or None (n-grams)


def _commit_shared(cache, valid_mask, n_accept, draft_len):
    """commit_verify on a SharedPrefixCache's tail."""
    tail, valid = llm_mod.commit_verify(cache.tail, valid_mask, n_accept,
                                        draft_len)
    return cache._replace(tail=tail), valid


def _spec_loop(lp, cfg, logits, cache, valid0, pos0, prompt_ids, generator,
               verify, commit, *, max_new_tokens: int, draft_len: int,
               temperature: float, top_p: Optional[float], do_sample: bool,
               eos_token_id: int, pad_token_id: int,
               draft_table: Optional[torch.Tensor],
               verify_key: tuple = ("verify_step",),
               graphs: Optional[StepGraphs] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The draft / verify loop after a prefill (logits [B, V]) →
    (tokens [B, max_new_tokens], lengths [B], verify passes). prompt_ids
    [B, S] start the committed buffer the drafts are looked up in;
    verify(lp, cfg, embeds, cache, valid, positions) → (logits, cache) and
    commit(cache, valid, n_accept, S_v) → (cache, valid) are
    llm.verify_step and llm.commit_verify, or their cascade forms, which
    verify_key names in the step graph's key. The loop owns cache, valid0
    and pos0 and writes them in place. passes counts the passes run, each
    with a live row."""
    B, S = prompt_ids.shape
    K = draft_len
    S_v = K + 1                                           # tokens per pass
    dev = logits.device
    tok0 = sample_logits(logits, generator, temperature, top_p, do_sample)
    C = S + max_new_tokens
    # one column past the end takes the writes a row cannot keep
    buf = torch.full((B, C + 1), pad_token_id, dtype=torch.long, device=dev)
    buf[:, :S] = prompt_ids
    buf[:, S] = tok0
    step = torch.ones(B, dtype=torch.long, device=dev)
    done = tok0 == eos_token_id
    state = SpecState(cache, valid0.bool(), pos0.to(torch.int32), buf, step,
                      done, (~done & (step < max_new_tokens)).any()[None],
                      None if draft_table is None
                      else draft_table.to(torch.long, copy=True))

    def body(st: SpecState) -> SpecState:
        iidx = torch.arange(S_v, device=dev)[None, :]
        alive = ~st.done & (st.step < max_new_tokens)
        ptr = S + st.step
        if st.table is not None:
            drafts = table_draft(st.table, ptr, K)
        else:
            drafts = ngram_draft(st.buf[:, :C], ptr, K)
        cur = st.buf.gather(1, (ptr - 1)[:, None])
        inputs = torch.cat([cur, drafts], dim=1)          # [B, S_v]
        token_embeds = llm_mod.embed_lookup(lp["embed"], inputs)
        positions = st.pos_next[:, None] + iidx
        logits, cache = verify(lp, cfg.llm, token_embeds, st.cache,
                               st.valid_mask, positions)
        a, emitted = spec_accept_tokens(logits, drafts, generator,
                                        temperature, top_p, do_sample)
        cache, valid = commit(cache, st.valid_mask, torch.where(alive, a, 0),
                              S_v)

        # emitted count e = a, cut at EOS and at the token budget
        is_eos = (emitted == eos_token_id) & (iidx < a[:, None])
        eos_pos = torch.where(is_eos, iidx, S_v).amin(dim=-1)
        e = torch.minimum(torch.minimum(a, eos_pos + 1),
                          max_new_tokens - st.step)
        e = torch.where(alive, e, 0)
        keep = iidx < e[:, None]
        cols = torch.where(keep, S + st.step[:, None] + iidx, C)
        st.buf.scatter_(1, cols, torch.where(keep, emitted, pad_token_id))
        done = st.done | (is_eos & keep).any(dim=-1)
        step = st.step + e
        return assign(st, SpecState(
            cache, valid, st.pos_next + e.to(torch.int32), st.buf, step,
            done, (~done & (step < max_new_tokens)).any()[None], st.table))

    graphs = StepGraphs() if graphs is None else graphs
    key = ("spec", *verify_key, K, S, max_new_tokens, temperature, top_p,
           do_sample, eos_token_id, pad_token_id)
    loop = graphs.loop(key, state, body, refs=(lp, cfg, generator),
                       params=lp, generator=generator)
    passes = 0
    while loop.read(loop.state.live):
        loop.step()
        passes += 1
    out = loop.state.buf[:, S:C].clone()
    lengths = (out != pad_token_id).sum(dim=-1)
    return out, lengths, passes


def _spec_from_features(params, cfg: VLMConfig, input_ids, attn_mask,
                        video_features, generator, *, max_new_tokens: int,
                        draft_len: int, clock, graphs, **kw
                        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """splice → prefill (int8 cache) → draft / verify loop →
    (tokens [B, max_new_tokens], lengths [B], verify passes)."""
    B = input_ids.shape[0]
    lp = params["llm"]
    embeds, _, mask = vlm.splice_multimodal(input_ids, None, attn_mask,
                                            video_features, lp["embed"])
    S_full = embeds.shape[1]
    # + the draft margin: a pass may write S_v slots past the last committed
    # token of a nearly finished row
    max_len = _ceil128(S_full + max_new_tokens + draft_len + 1)
    cache = llm_mod.QuantKVCache.create(llm_mod.rank_config(lp, cfg.llm), B,
                                        max_len, device=embeds.device)
    logits, cache = llm_mod.prefill(lp, cfg.llm, embeds, mask, cache)
    clock.mark("prefill")
    valid0 = torch.zeros(B, max_len, dtype=torch.bool, device=embeds.device)
    valid0[:, :S_full] = mask.bool()
    out = _spec_loop(lp, cfg, logits, cache, valid0,
                     mask.sum(dim=-1).to(torch.int32), input_ids, generator,
                     llm_mod.verify_step, llm_mod.commit_verify,
                     max_new_tokens=max_new_tokens, draft_len=draft_len,
                     graphs=graphs, **kw)
    clock.mark("decode")
    clock.count("verify_passes", out[2])
    return out


def generate_tokens_spec_from_features(
        params, cfg: VLMConfig, input_ids: torch.Tensor,
        attn_mask: torch.Tensor, video_features: torch.Tensor,
        generator: Optional[torch.Generator], *, max_new_tokens: int,
        draft_len: int = 4, temperature: float = 0.0,
        top_p: Optional[float] = None, do_sample: bool = False,
        eos_token_id: int = 2, pad_token_id: int = 0,
        draft_table: Optional[torch.Tensor] = None, with_stats: bool = False,
        timings: Optional[dict] = None,
        graphs: Optional[StepGraphs] = None) -> Tuple[torch.Tensor, ...]:
    """Speculative generation from precomputed vlm.encode_video features →
    (tokens [B, max_new_tokens] pad-filled after EOS, lengths [B]), plus
    the verify-pass count with with_stats. draft_table [B, >= S + max_new]:
    buf-aligned external drafts in place of the n-gram lookup."""
    clock = _PhaseClock(timings, input_ids.device)
    with torch.inference_mode():
        out, lengths, passes = _spec_from_features(
            params, cfg, input_ids, attn_mask, video_features, generator,
            max_new_tokens=max_new_tokens, draft_len=draft_len,
            temperature=temperature, top_p=top_p, do_sample=do_sample,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id,
            draft_table=draft_table, clock=clock, graphs=graphs)
    return (out, lengths, passes) if with_stats else (out, lengths)


def generate_tokens_spec(params, cfg: VLMConfig, input_ids: torch.Tensor,
                         attn_mask: torch.Tensor,
                         spatial_pixels: torch.Tensor,
                         temporal_pixels: torch.Tensor,
                         generator: Optional[torch.Generator], *,
                         max_new_tokens: int, draft_len: int = 4,
                         temperature: float = 0.0,
                         top_p: Optional[float] = None,
                         do_sample: bool = False, eos_token_id: int = 2,
                         pad_token_id: int = 0,
                         draft_table: Optional[torch.Tensor] = None,
                         with_stats: bool = False,
                         timings: Optional[dict] = None,
                         graphs: Optional[StepGraphs] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """Speculative generation from pixels, the contract of
    serve/generate.generate_tokens with quantize_cache=True (verify_step
    needs the int8 cache)."""
    clock = _PhaseClock(timings, input_ids.device)
    with torch.inference_mode():
        video_features = vlm.encode_video(params, cfg, spatial_pixels,
                                          temporal_pixels)
        clock.mark("encode")
        out, lengths, passes = _spec_from_features(
            params, cfg, input_ids, attn_mask, video_features, generator,
            max_new_tokens=max_new_tokens, draft_len=draft_len,
            temperature=temperature, top_p=top_p, do_sample=do_sample,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id,
            draft_table=draft_table, clock=clock, graphs=graphs)
    return (out, lengths, passes) if with_stats else (out, lengths)


def generate_tokens_spec_from_prefix(
        params, cfg: VLMConfig, post_ids: torch.Tensor,
        post_mask: torch.Tensor, prefix_k: torch.Tensor,
        prefix_v: torch.Tensor, prefix_mask: torch.Tensor,
        generator: Optional[torch.Generator], *, max_new_tokens: int,
        draft_len: int = 4, temperature: float = 0.0,
        top_p: Optional[float] = None, do_sample: bool = False,
        eos_token_id: int = 2, pad_token_id: int = 0,
        draft_table: Optional[torch.Tensor] = None, with_stats: bool = False,
        rope_hint: Optional[int] = None,
        timings: Optional[dict] = None,
        graphs: Optional[StepGraphs] = None) -> Tuple[torch.Tensor, ...]:
    """Speculative generation over the cascade cache: the question chunk
    post_ids/post_mask [B, Sq] prefilled against a batch-1 prefix
    (serve/generate.build_prefix_kv), then verify passes of
    llm.verify_step_shared, the prefix read once a pass for the whole
    batch. Drafts come from the question chunk and the generated tokens
    (the prefix's video tokens are not text). rope_hint: the hint the prefix
    was built with (default ceil128(Sp + Sq + max_new_tokens + draft_len +
    1), the draft margin included). Otherwise the contract of
    generate_tokens_spec_from_features."""
    B, Sq = post_ids.shape
    Sp = prefix_k.shape[2]
    S_v = draft_len + 1
    hint = (rope_hint if rope_hint is not None
            else _ceil128(Sp + Sq + max_new_tokens + S_v))
    tail_len = _ceil128(Sq + max_new_tokens + S_v)
    clock = _PhaseClock(timings, post_ids.device)
    lp = params["llm"]
    with torch.inference_mode():
        chunk_embeds = llm_mod.embed_lookup(lp["embed"], post_ids,
                                            llm_mod.embed_dtype(lp["embed"]))
        logits, cache, tail_valid, pos0 = llm_mod.prefill_continue(
            lp, cfg.llm, chunk_embeds, post_mask, prefix_k, prefix_v,
            prefix_mask, hint, quantize_cache=True, tail_len=tail_len)
        clock.mark("prefill")

        def verify(*args):
            return llm_mod.verify_step_shared(*args, rope_hint=hint)

        out, lengths, passes = _spec_loop(
            lp, cfg, logits, cache, tail_valid, pos0, post_ids.long(),
            generator, verify, _commit_shared,
            max_new_tokens=max_new_tokens, draft_len=draft_len,
            temperature=temperature, top_p=top_p, do_sample=do_sample,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id,
            draft_table=draft_table,
            verify_key=("verify_step_shared", hint), graphs=graphs)
        clock.mark("decode")
        clock.count("verify_passes", passes)
    return (out, lengths, passes) if with_stats else (out, lengths)
