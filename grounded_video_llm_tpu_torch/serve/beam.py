"""Beam search decode (num_beams > 1), the port of
grounded_video_llm_tpu/serve/beam.py: HF GenerationMixin beam semantics with
length penalty 1.0, per-beam log-prob accumulation, EOS freezing a beam, and
a stop when every beam has finished or the budget is spent.

Beams ride the batch dimension (B·K rows), so prefill and decode_step are
reused unchanged, on a KVCache in the activations' dtype (bf16 for a bf16,
int8 or int8_full tree, as in the JAX package). Each step reorders the cache by beam
parent: a gather of [L, B·K, max_len, Hkv, Dh] into a second, preallocated
buffer, the two swapped afterwards, so the reorder never holds more than two
caches. The loop is a host loop, like the port's other decode loops.

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

from typing import Optional

import torch

from ..core.config import VLMConfig
from ..models import llm as llm_mod
from ..models import vlm
from .generate import _ceil128, _PhaseClock

NEG = -1e9


def beam_search_tokens(params, cfg: VLMConfig, input_ids: torch.Tensor,
                       attn_mask: torch.Tensor,
                       spatial_pixels: torch.Tensor,
                       temporal_pixels: torch.Tensor, *,
                       max_new_tokens: int, num_beams: int = 4,
                       eos_token_id: int = 2, pad_token_id: int = 0,
                       return_scores: bool = False,
                       timings: Optional[dict] = None):
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
        cache = llm_mod.KVCache.create(cfg.llm, B, max_len,
                                       dtype=embeds.dtype, device=dev)
        logits, cache = llm_mod.prefill(params["llm"], cfg.llm, embeds, mask,
                                        cache)
        # the beams along the batch: row b·K + j is beam j of sample b
        k = cache.k.repeat_interleave(K, dim=1)
        v = cache.v.repeat_interleave(K, dim=1)
        cache = llm_mod.KVCache(k, v, cache.length.repeat_interleave(K))
        spare = (torch.empty_like(k), torch.empty_like(v))
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
        # a finished beam continues with pad only, its score unchanged
        frozen = torch.full((V,), NEG, dtype=torch.float32, device=dev)
        frozen[pad_token_id] = 0.0
        base = (torch.arange(B, device=dev) * K)[:, None]
        step = 1
        while step < max_new_tokens and not bool(done.all()):
            token_embeds = llm_mod.embed_lookup(params["llm"]["embed"],
                                                tok)[:, None, :]
            logits, cache, valid = llm_mod.decode_step(
                params["llm"], cfg.llm, token_embeds.to(cache.k.dtype), cache,
                valid, positions)
            logp = torch.log_softmax(logits.float(), dim=-1)   # [B·K, V]
            logp = torch.where(done[:, None], frozen[None, :], logp)
            cand = (scores[:, None] + logp).reshape(B, K * V)
            new_scores, flat = torch.topk(cand, K, dim=-1)     # [B, K]
            gidx = (base + flat // V).reshape(B * K)
            tok = (flat % V).reshape(B * K)
            # reorder the cache by parent into the spare buffers, then swap
            torch.index_select(cache.k, 1, gidx, out=spare[0])
            torch.index_select(cache.v, 1, gidx, out=spare[1])
            spare, cache = (cache.k, cache.v), llm_mod.KVCache(
                spare[0], spare[1], cache.length[gidx])
            valid = valid[gidx]
            out = out[gidx]
            out[:, step] = tok
            done = done[gidx] | (tok == eos_token_id)
            positions = positions[gidx] + 1
            scores = new_scores.reshape(B * K)
            step += 1
        clock.mark("decode")
        clock.count("decode_steps", step - 1)

        # the best beam of each sample (length penalty 1.0: the raw score)
        best = scores.reshape(B, K).argmax(dim=-1)             # [B]
        rows = torch.arange(B, device=dev)
        out = out.reshape(B, K, max_new_tokens)[rows, best]
        lengths = (out != pad_token_id).sum(dim=-1)
        if return_scores:
            return out, lengths, scores.reshape(B, K)[rows, best]
        return out, lengths
