"""Generation: multimodal prefill + decode loop (port of the lockstep path of
grounded_video_llm_tpu/serve/generate.py).

Prompts are left-padded so the newest token sits at a fixed position; the KV
cache (bf16, or int8 with ``quantize_cache``) is preallocated for
prompt+video+max_new slots rounded up to 128; the decode loop is a Python
loop with per-row EOS (finished rows emit pad) that stops when every row is
done. Only new tokens are returned.

Sampling draws from an explicit torch.Generator. Greedy decoding is
token-exact against the JAX package; sampled decoding is not (the two
frameworks' random streams differ).

``timings``: pass a dict to have the phases (encode, prefill, decode)
timed on the host clock; each boundary synchronizes the device first, so
the seconds are device work, not enqueue time. It also gets
``decode_steps``, the number of decode_step calls.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import VLMConfig
from ..models import llm as llm_mod
from ..models import vlm


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
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


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


def _generate_from_features(params, cfg: VLMConfig, input_ids, attn_mask,
                            video_features, generator, *, max_new_tokens,
                            temperature, top_p, do_sample, eos_token_id,
                            pad_token_id, quantize_cache, clock):
    """splice → prefill → decode loop."""
    B, S = input_ids.shape
    embeds, _, mask = vlm.splice_multimodal(
        input_ids, None, attn_mask, video_features, params["llm"]["embed"])
    S_full = embeds.shape[1]
    max_len = -(-(S_full + max_new_tokens) // 128) * 128

    if quantize_cache:
        cache = llm_mod.QuantKVCache.create(cfg.llm, B, max_len,
                                            device=embeds.device)
    else:
        cache = llm_mod.KVCache.create(cfg.llm, B, max_len,
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
        pad_token_id=pad_token_id)
    clock.mark("decode")
    clock.count("decode_steps", steps)
    return out, lengths


def _decode_loop(params, cfg: VLMConfig, logits, cache, valid0, pos0,
                 generator, *, max_new_tokens, temperature, top_p, do_sample,
                 eos_token_id, pad_token_id
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Sample the first token from the prefill logits, then decode until
    max_new_tokens or every row has emitted EOS → (tokens, lengths, number
    of decode steps)."""
    B = logits.shape[0]
    tok = sample_logits(logits, generator, temperature, top_p, do_sample)
    out = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.int64,
                     device=logits.device)
    out[:, 0] = tok
    done = tok == eos_token_id
    valid, positions = valid0, pos0
    step = 1
    while step < max_new_tokens and not bool(done.all()):
        token_embeds = llm_mod.embed_lookup(params["llm"]["embed"],
                                            tok)[:, None, :]
        logits, cache, valid = llm_mod.decode_step(
            params["llm"], cfg.llm, token_embeds, cache, valid, positions)
        nxt = sample_logits(logits, generator, temperature, top_p, do_sample)
        nxt = torch.where(done, pad_token_id, nxt)
        out[:, step] = nxt
        done = done | (nxt == eos_token_id)
        positions = positions + 1
        tok = nxt
        step += 1
    lengths = (out != pad_token_id).sum(dim=-1)
    return out, lengths, step - 1


def generate_tokens(params, cfg: VLMConfig, input_ids: torch.Tensor,
                    attn_mask: torch.Tensor, spatial_pixels: torch.Tensor,
                    temporal_pixels: torch.Tensor,
                    generator: Optional[torch.Generator], *,
                    max_new_tokens: int, temperature: float = 0.2,
                    top_p: Optional[float] = None, do_sample: bool = True,
                    eos_token_id: int = 2, pad_token_id: int = 0,
                    quantize_cache: bool = False,
                    timings: Optional[dict] = None
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
            clock=clock)


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
                                  timings: Optional[dict] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """generate_tokens from precomputed vlm.encode_video features."""
    clock = _PhaseClock(timings, input_ids.device)
    with torch.inference_mode():
        return _generate_from_features(
            params, cfg, input_ids, attn_mask, video_features, generator,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, do_sample=do_sample, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, quantize_cache=quantize_cache,
            clock=clock)


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
