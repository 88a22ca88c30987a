"""Generation: multimodal prefill + decode loop (port of the lockstep path of
grounded_video_llm_tpu/serve/generate.py).

Prompts are left-padded so the newest token sits at a fixed position; the KV
cache (bf16, or int8 with ``quantize_cache``) is preallocated for
prompt+video+max_new slots rounded up to 128; the decode loop is a Python
loop with per-row EOS (finished rows emit pad) that stops when every row is
done. Only new tokens are returned.

The decode loop is JAX's ``while_loop`` over a ``DecodeState``: each step
(JAX's body) writes the state in place and runs through
``serve/graphs.StepGraphs``, as a captured CUDA graph on the card; the host
reads JAX's ``cond`` (a device flag) after each step and stops where JAX's
loop stops. ``graphs``: the caller's runner (an engine's), else one for the
call; ``StepGraphs.eager()`` is the eager loop on the card.

Sampling draws from an explicit torch.Generator. Greedy decoding is
token-exact against the JAX package; sampled decoding is not (the two
frameworks' random streams differ).

Prefix-KV serving: ``build_prefix_kv`` runs the shared [pre-image text |
video tokens] head of a video's prompts once into a bf16 prefix K/V, and
``generate_tokens_from_prefix`` prefills each batch's question chunk
against it (llm.prefill_continue), then decodes with decode_step or, with
``shared_prefix``, the cascade decode_step_shared.

``timings``: pass a dict to have the phases (encode, prefill, decode)
timed on the host clock; each boundary synchronizes the device first, so
the seconds are device work, not enqueue time. It also gets
``decode_steps``, the number of decode steps. Values add up over calls
that share the dict.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.config import VLMConfig
from ..models import llm as llm_mod
from ..models import vlm
from .graphs import StepGraphs, assign


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float, top_p: Optional[float],
                  do_sample: bool) -> torch.Tensor:
    """logits [B, V] → token ids [B] (int64)."""
    if not do_sample or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        sorted_probs = torch.softmax(sorted_logits, dim=-1)
        cumprobs = torch.cumsum(sorted_probs, dim=-1)
        # keep the smallest set with cumulative prob > top_p (HF semantics)
        cutoff = (cumprobs - sorted_probs) >= top_p
        threshold = torch.where(cutoff, torch.inf, sorted_logits).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, -torch.inf, logits)
    probs = torch.softmax(logits.float(), dim=-1)
    return draw_categorical(probs, generator)


def draw_categorical(probs: torch.Tensor,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of probs [N, V] (non-negative, no row all zero) →
    [N] int64: torch.multinomial(probs, 1)'s own algorithm (the argmax of
    probs over Exp(1) noise) without its host-side checks of the
    probabilities, which a CUDA graph cannot capture. The same generator
    state gives multinomial's draws."""
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / noise, dim=-1)


class DecodeState(NamedTuple):
    """The decode loop's state, JAX's DecodeState without its key (draws
    come from the caller's torch.Generator). A step writes it in place."""
    cache: object               # KVCache, QuantKVCache or SharedPrefixCache
    valid_mask: torch.Tensor    # [B, max_len] ([B, tail] for the cascade)
    positions: torch.Tensor     # [B] int32 position of the next token
    cur_token: torch.Tensor     # [B] int64 last sampled token
    out_tokens: torch.Tensor    # [B, max_new_tokens] int64
    step: torch.Tensor          # [1] int64 next column of out_tokens
    done: torch.Tensor          # [B] bool
    live: torch.Tensor          # [1] bool: JAX's cond


class _PhaseClock:
    """Host-clock phase timer that synchronizes the device at each mark."""

    def __init__(self, timings: Optional[dict], device: torch.device):
        self.timings = timings
        self.device = device
        self.t = self._now() if timings is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, phase: str) -> None:
        if self.timings is None:
            return
        now = self._now()
        self.timings[phase] = self.timings.get(phase, 0.0) + now - self.t
        self.t = now

    def count(self, name: str, n: int) -> None:
        if self.timings is not None:
            self.timings[name] = self.timings.get(name, 0) + n


def _ceil128(n: int) -> int:
    """Cache capacities round up to a multiple of 128 slots, as in the JAX
    package."""
    return -(-n // 128) * 128


def _generate_from_features(params, cfg: VLMConfig, input_ids, attn_mask,
                            video_features, generator, *, max_new_tokens,
                            temperature, top_p, do_sample, eos_token_id,
                            pad_token_id, quantize_cache, clock, graphs):
    """splice → prefill → decode loop."""
    B, S = input_ids.shape
    embeds, _, mask = vlm.splice_multimodal(
        input_ids, None, attn_mask, video_features, params["llm"]["embed"])
    S_full = embeds.shape[1]
    max_len = _ceil128(S_full + max_new_tokens)

    rank_cfg = llm_mod.rank_config(params["llm"], cfg.llm)
    if quantize_cache:
        cache = llm_mod.QuantKVCache.create(rank_cfg, B, max_len,
                                            device=embeds.device)
    else:
        cache = llm_mod.KVCache.create(rank_cfg, B, max_len,
                                       dtype=embeds.dtype,
                                       device=embeds.device)
    logits, cache = llm_mod.prefill(params["llm"], cfg.llm, embeds, mask,
                                    cache)
    clock.mark("prefill")

    valid0 = torch.zeros(B, max_len, dtype=torch.bool, device=embeds.device)
    valid0[:, :S_full] = mask.bool()
    # the next position continues after the last valid one
    pos0 = mask.sum(dim=-1).to(torch.int32)
    out, lengths, steps = _decode_loop(
        params, cfg, logits, cache, valid0, pos0, generator,
        max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
        do_sample=do_sample, eos_token_id=eos_token_id,
        pad_token_id=pad_token_id, graphs=graphs)
    clock.mark("decode")
    clock.count("decode_steps", steps)
    return out, lengths


def _decode_loop(params, cfg: VLMConfig, logits, cache, valid0, pos0,
                 generator, *, max_new_tokens, temperature, top_p, do_sample,
                 eos_token_id, pad_token_id, step_fn=llm_mod.decode_step,
                 step_key: tuple = ("decode_step",),
                 graphs: Optional[StepGraphs] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Sample the first token from the prefill logits, then decode until
    max_new_tokens or every row has emitted EOS → (tokens, lengths, number
    of decode steps). step_fn(params, cfg, embeds, cache, valid, positions)
    is llm.decode_step or the cascade's decode_step_shared; step_key names
    it in the step graph's key (with what it closes over). The loop owns
    cache, valid0 and pos0 and writes them in place."""
    B = logits.shape[0]
    dev = logits.device
    lp = params["llm"]
    tok = sample_logits(logits, generator, temperature, top_p, do_sample)
    out = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.int64,
                     device=dev)
    out[:, 0] = tok
    done = tok == eos_token_id
    step = torch.ones(1, dtype=torch.int64, device=dev)
    state = DecodeState(cache, valid0.bool(), pos0.to(torch.int32), tok,
                        out, step, done,
                        (step < max_new_tokens) & ~done.all())

    def body(st: DecodeState) -> DecodeState:
        token_embeds = llm_mod.embed_lookup(lp["embed"],
                                            st.cur_token)[:, None, :]
        logits, cache, valid = step_fn(lp, cfg.llm, token_embeds, st.cache,
                                       st.valid_mask, st.positions)
        nxt = sample_logits(logits, generator, temperature, top_p, do_sample)
        nxt = torch.where(st.done, pad_token_id, nxt)
        st.out_tokens.index_copy_(1, st.step, nxt[:, None])
        done = st.done | (nxt == eos_token_id)
        step = st.step + 1
        return assign(st, DecodeState(
            cache, valid, st.positions + 1, nxt, st.out_tokens, step, done,
            (step < max_new_tokens) & ~done.all()))

    graphs = StepGraphs() if graphs is None else graphs
    key = ("decode", *step_key, temperature, top_p, do_sample, eos_token_id,
           pad_token_id)
    loop = graphs.loop(key, state, body, refs=(lp, cfg, generator),
                       params=lp, generator=generator)
    steps = 0
    while loop.read(loop.state.live):
        loop.step()
        steps += 1
    out = loop.state.out_tokens.clone()
    lengths = (out != pad_token_id).sum(dim=-1)
    return out, lengths, steps


def generate_tokens(params, cfg: VLMConfig, input_ids: torch.Tensor,
                    attn_mask: torch.Tensor, spatial_pixels: torch.Tensor,
                    temporal_pixels: torch.Tensor,
                    generator: Optional[torch.Generator], *,
                    max_new_tokens: int, temperature: float = 0.2,
                    top_p: Optional[float] = None, do_sample: bool = True,
                    eos_token_id: int = 2, pad_token_id: int = 0,
                    quantize_cache: bool = False,
                    timings: Optional[dict] = None,
                    graphs: Optional[StepGraphs] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens [B, max_new_tokens] pad-filled after EOS, lengths [B]).

    input_ids [B, S] left-padded with one IMAGE_TOKEN_INDEX per row;
    spatial_pixels [B, segs, 336, 336, 3], temporal_pixels
    [B, frames, 224, 224, 3], uint8 or normalized float."""
    clock = _PhaseClock(timings, input_ids.device)
    with torch.inference_mode():
        video_features = vlm.encode_video(params, cfg, spatial_pixels,
                                          temporal_pixels)
        clock.mark("encode")
        return _generate_from_features(
            params, cfg, input_ids, attn_mask, video_features, generator,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, do_sample=do_sample, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, quantize_cache=quantize_cache,
            clock=clock, graphs=graphs)


def generate_tokens_from_features(params, cfg: VLMConfig,
                                  input_ids: torch.Tensor,
                                  attn_mask: torch.Tensor,
                                  video_features: torch.Tensor,
                                  generator: Optional[torch.Generator], *,
                                  max_new_tokens: int,
                                  temperature: float = 0.2,
                                  top_p: Optional[float] = None,
                                  do_sample: bool = True,
                                  eos_token_id: int = 2,
                                  pad_token_id: int = 0,
                                  quantize_cache: bool = False,
                                  timings: Optional[dict] = None,
                                  graphs: Optional[StepGraphs] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """generate_tokens from precomputed vlm.encode_video features."""
    clock = _PhaseClock(timings, input_ids.device)
    with torch.inference_mode():
        return _generate_from_features(
            params, cfg, input_ids, attn_mask, video_features, generator,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, do_sample=do_sample, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, quantize_cache=quantize_cache,
            clock=clock, graphs=graphs)


def build_prefix_kv(params, cfg: VLMConfig, pre_ids: torch.Tensor,
                    pre_mask: torch.Tensor, video_features: torch.Tensor,
                    rope_hint: int):
    """The bf16 prefix K/V of prefix-KV serving: the shared [pre-image text
    | video features] head (pre_ids/pre_mask [Bp, St], video_features [Bp,
    NV, H]) through the decoder once → (k, v [L, Bp, Sp, Hkv, Dh] bf16,
    mask [Bp, Sp]), Sp = St + NV, for prefill_continue. The prefill writes
    them into a bf16 KVCache of capacity exactly Sp. rope_hint must be the
    continuation's LongRoPE hint, so the prefix keys and every later query
    use one factor set."""
    lp = params["llm"]
    with torch.inference_mode():
        emb = llm_mod.embed_lookup(lp["embed"], pre_ids,
                                   llm_mod.embed_dtype(lp["embed"]))
        embeds = torch.cat([emb, video_features.to(emb.dtype)], dim=1)
        Bp, NV = video_features.shape[:2]
        mask = torch.cat([pre_mask.long(),
                          torch.ones(Bp, NV, dtype=torch.long,
                                     device=pre_mask.device)], dim=1)
        cache = llm_mod.KVCache.create(llm_mod.rank_config(lp, cfg.llm), Bp,
                                       embeds.shape[1], dtype=torch.bfloat16,
                                       device=embeds.device)
        llm_mod.forward_hidden(lp, cfg.llm, embeds, mask, cache,
                               rope_hint=rope_hint)
    return cache.k, cache.v, mask


def generate_tokens_from_prefix(params, cfg: VLMConfig,
                                post_ids: torch.Tensor,
                                post_mask: torch.Tensor,
                                prefix_k: torch.Tensor,
                                prefix_v: torch.Tensor,
                                prefix_mask: torch.Tensor,
                                generator: Optional[torch.Generator], *,
                                max_new_tokens: int,
                                temperature: float = 0.2,
                                top_p: Optional[float] = None,
                                do_sample: bool = True,
                                eos_token_id: int = 2,
                                pad_token_id: int = 0,
                                quantize_cache: bool = False,
                                shared_prefix: bool = False,
                                rope_hint: Optional[int] = None,
                                timings: Optional[dict] = None,
                                graphs: Optional[StepGraphs] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generation over a cached prefix (build_prefix_kv): each row prefills
    only its left-padded question chunk post_ids/post_mask [B, Sq] →
    (tokens [B, max_new_tokens], lengths [B]).

    shared_prefix decodes through the cascade (llm.decode_step_shared: the
    prefix int8 K/V stored once at batch 1, a per-row tail); it requires
    quantize_cache. rope_hint: the hint the prefix was built with; every
    program of the continuation uses it. Default: ceil128(Sp + Sq +
    max_new_tokens), this call's capacity. The single-cache routes size
    their cache to the hint (their decode steps read it from the capacity)
    and refuse a hint below the capacity they need."""
    B, Sq = post_ids.shape
    Sp = prefix_k.shape[2]
    need = _ceil128(Sp + Sq + max_new_tokens)
    hint = need if rope_hint is None else rope_hint
    if shared_prefix and not quantize_cache:
        raise ValueError("shared_prefix decodes over int8 caches: it needs "
                         "quantize_cache=True")
    if not shared_prefix and hint < need:
        raise ValueError(f"rope_hint {hint} is below the {need} slots this "
                         "call's cache needs")
    clock = _PhaseClock(timings, post_ids.device)
    lp = params["llm"]
    with torch.inference_mode():
        chunk_embeds = llm_mod.embed_lookup(lp["embed"], post_ids,
                                            llm_mod.embed_dtype(lp["embed"]))
        if shared_prefix:
            logits, cache, valid0, pos0 = llm_mod.prefill_continue(
                lp, cfg.llm, chunk_embeds, post_mask, prefix_k, prefix_v,
                prefix_mask, hint, quantize_cache=True,
                tail_len=_ceil128(Sq + max_new_tokens))

            def step_fn(*args):
                return llm_mod.decode_step_shared(*args, rope_hint=hint)
            step_key = ("decode_step_shared", hint)
        else:
            logits, cache, valid0, pos0 = llm_mod.prefill_continue(
                lp, cfg.llm, chunk_embeds, post_mask, prefix_k, prefix_v,
                prefix_mask, hint, quantize_cache=quantize_cache)
            step_fn, step_key = llm_mod.decode_step, ("decode_step",)
        clock.mark("prefill")
        out, lengths, steps = _decode_loop(
            params, cfg, logits, cache, valid0, pos0, generator,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, do_sample=do_sample, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, step_fn=step_fn, step_key=step_key,
            graphs=graphs)
        clock.mark("decode")
        clock.count("decode_steps", steps)
    return out, lengths


def decode_texts(tokenizer, tokens, lengths, eos_token_id: int):
    """Host-side detokenization: strip eos and pad, skip specials, strip
    whitespace."""
    tokens = np.asarray(torch.as_tensor(tokens).cpu())
    lengths = np.asarray(torch.as_tensor(lengths).cpu())
    texts = []
    for row, n in zip(tokens, lengths):
        ids = [int(t) for t in row[:n] if int(t) != eos_token_id]
        texts.append(tokenizer.decode(ids, skip_special_tokens=True).strip())
    return texts
