"""Beam search decode (num_beams > 1), the port of
grounded_video_llm_tpu/serve/beam.py: HF GenerationMixin beam semantics with
length penalty 1.0, per-beam log-prob accumulation, EOS freezing a beam, and
a stop when every beam has finished or the budget is spent.

Beams ride the batch dimension (B·K rows), so prefill and decode_step are
reused unchanged, on a KVCache in the activations' dtype (bf16 for a bf16,
int8 or int8_full tree, as in the JAX package). Each step reorders the cache by beam
parent: a gather of [L, B·K, max_len, Hkv, Dh] into a second, preallocated
buffer, the two swapped afterwards, so the reorder never holds more than two
caches. The loop is JAX's beam ``while_loop`` over a ``BeamState`` written
in place, run through serve/graphs.StepGraphs: the swap makes two step
bodies, one per direction (buffer 0 → 1 and 1 → 0), each its own CUDA graph
on the card, stepped in turn.

Two differences from the JAX function, both where it departs from its own
greedy path (serve/generate.py):
  * JAX decodes the first new token at position sum(mask) + 1
    (beam.py:93, ``positions + 1``), one past the position generate_tokens
    gives it; the port uses generate's position, so num_beams=1 is greedy
    decoding.
  * the cache holds ceil128(S_full + max_new_tokens) slots, as generate's
    does (JAX: S_full + max_new_tokens). The extra slots are never valid,
    and the capacity is the LongRoPE hint of decode_step, whose factor
    switch (4,096 for Phi-3.5) is a multiple of 128, so the factors are the
    same.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import VLMConfig
from ..models import llm as llm_mod
from ..models import vlm
from .generate import _ceil128, _PhaseClock
from .graphs import StepGraphs, assign

NEG = -1e9


class BeamState(NamedTuple):
    """The beam loop's state (rows b·K + j: beam j of sample b); a step
    writes it in place. The cache's k/v live in two buffers, the one a step
    reads and the one its reorder writes."""
    k: tuple                    # two [L, B·K, max_len, Hkv, Dh] buffers
    v: tuple
    length: torch.Tensor        # [B·K] int32
    valid: torch.Tensor         # [B·K, max_len] bool
    positions: torch.Tensor     # [B·K] int32
    tok: torch.Tensor           # [B·K] int64
    out: torch.Tensor           # [B·K, max_new_tokens] int64
    step: torch.Tensor          # [1] int64 next column of out
    done: torch.Tensor          # [B·K] bool
    scores: torch.Tensor        # [B·K] fp32 summed log-probs
    live: torch.Tensor          # [1] bool: JAX's cond


def beam_search_tokens(params, cfg: VLMConfig, input_ids: torch.Tensor,
                       attn_mask: torch.Tensor,
                       spatial_pixels: torch.Tensor,
                       temporal_pixels: torch.Tensor, *,
                       max_new_tokens: int, num_beams: int = 4,
                       eos_token_id: int = 2, pad_token_id: int = 0,
                       return_scores: bool = False,
                       timings: Optional[dict] = None,
                       graphs: Optional[StepGraphs] = None):
    """→ (tokens [B, max_new_tokens] of the best beam, lengths [B]), and
    with return_scores the best beam's summed log-prob [B] fp32.

    input_ids/attn_mask [B, S] left-padded with one IMAGE_TOKEN_INDEX a
    row; pixels as generate_tokens takes them. lengths counts the non-pad
    tokens, as the JAX function does. timings (a dict) gets encode,
    prefill, decode and decode_steps, as generate_tokens' does."""
    B = input_ids.shape[0]
    K = num_beams
    clock = _PhaseClock(timings, input_ids.device)
    with torch.inference_mode():
        video_features = vlm.encode_video(params, cfg, spatial_pixels,
                                          temporal_pixels)
        clock.mark("encode")
        embeds, _, mask = vlm.splice_multimodal(
            input_ids, None, attn_mask, video_features,
            params["llm"]["embed"])
        S_full = embeds.shape[1]
        max_len = _ceil128(S_full + max_new_tokens)
        dev = embeds.device
        cache = llm_mod.KVCache.create(
            llm_mod.rank_config(params["llm"], cfg.llm), B, max_len,
            dtype=embeds.dtype, device=dev)
        logits, cache = llm_mod.prefill(params["llm"], cfg.llm, embeds, mask,
                                        cache)
        # the beams along the batch: row b·K + j is beam j of sample b
        k = cache.k.repeat_interleave(K, dim=1)
        v = cache.v.repeat_interleave(K, dim=1)
        length = cache.length.repeat_interleave(K)
        del cache
        valid = torch.zeros(B * K, max_len, dtype=torch.bool, device=dev)
        valid[:, :S_full] = mask.bool().repeat_interleave(K, dim=0)
        positions = mask.sum(dim=-1).to(torch.int32).repeat_interleave(K)
        clock.mark("prefill")

        logp = torch.log_softmax(logits.float(), dim=-1)       # [B, V]
        V = logp.shape[-1]
        top_lp, top_tok = torch.topk(logp, K, dim=-1)          # [B, K]
        scores = top_lp.reshape(B * K)
        tok = top_tok.reshape(B * K)
        out = torch.full((B * K, max_new_tokens), pad_token_id,
                         dtype=torch.int64, device=dev)
        out[:, 0] = tok
        done = tok == eos_token_id
        step = torch.ones(1, dtype=torch.int64, device=dev)
        state = BeamState((k, torch.empty_like(k)), (v, torch.empty_like(v)),
                          length, valid, positions, tok, out, step, done,
                          scores, (step < max_new_tokens) & ~done.all())
        del k, v
        lp = params["llm"]

        def body(src: int):
            dst = 1 - src

            def run(st: BeamState) -> BeamState:
                token_embeds = llm_mod.embed_lookup(lp["embed"],
                                                    st.tok)[:, None, :]
                logits, cache, valid = llm_mod.decode_step(
                    lp, cfg.llm, token_embeds.to(st.k[src].dtype),
                    llm_mod.KVCache(st.k[src], st.v[src], st.length),
                    st.valid, st.positions)
                logp = torch.log_softmax(logits.float(), dim=-1)  # [B·K, V]
                # a finished beam continues with pad only, its score
                # unchanged
                frozen = torch.full((V,), NEG, dtype=torch.float32,
                                    device=dev)
                frozen[pad_token_id].fill_(0.0)
                logp = torch.where(st.done[:, None], frozen[None, :], logp)
                cand = (st.scores[:, None] + logp).reshape(B, K * V)
                new_scores, flat = torch.topk(cand, K, dim=-1)  # [B, K]
                base = (torch.arange(B, device=dev) * K)[:, None]
                gidx = (base + flat // V).reshape(B * K)
                tok = (flat % V).reshape(B * K)
                # reorder the cache by parent into the other buffers
                torch.index_select(st.k[src], 1, gidx, out=st.k[dst])
                torch.index_select(st.v[src], 1, gidx, out=st.v[dst])
                out = st.out[gidx]
                out.index_copy_(1, st.step, tok[:, None])
                done = st.done[gidx] | (tok == eos_token_id)
                step = st.step + 1
                return assign(st, st._replace(
                    length=cache.length[gidx], valid=valid[gidx],
                    positions=st.positions[gidx] + 1, tok=tok, out=out,
                    step=step, done=done, scores=new_scores.reshape(B * K),
                    live=(step < max_new_tokens) & ~done.all()))
            return run

        graphs = StepGraphs() if graphs is None else graphs
        loop = graphs.loop(("beam", K, eos_token_id, pad_token_id), state,
                           (body(0), body(1)), refs=(lp, cfg), params=lp)
        steps = 0
        while loop.read(loop.state.live):
            loop.step(steps % 2)
            steps += 1
        clock.mark("decode")
        clock.count("decode_steps", steps)
        st = loop.state
        scores, out = st.scores.clone(), st.out.clone()

        # the best beam of each sample (length penalty 1.0: the raw score)
        best = scores.reshape(B, K).argmax(dim=-1)             # [B]
        rows = torch.arange(B, device=dev)
        out = out.reshape(B, K, max_new_tokens)[rows, best]
        lengths = (out != pad_token_id).sum(dim=-1)
        if return_scores:
            return out, lengths, scores.reshape(B, K)[rows, best]
        return out, lengths
