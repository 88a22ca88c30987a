"""Decoder-only causal LM, Phi-3.5-mini bf16 path (port of
grounded_video_llm_tpu/models/llm.py).

Pre-RMSNorm blocks with a fused qkv projection, SiLU-gated fused gate_up MLP,
LongRoPE and fp32 logits. Weights are [D_in, D_out] kernels stacked along a
leading layer axis, as in the JAX package.

Decode uses a fixed-shape KV cache [L, B, max_len, Hkv, Dh] with a validity
mask over slots. Not ported yet: the int8 serving stack (int8 weights,
QuantKVCache), LoRA, training, prefix-KV and cascade decode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.config import LLMConfig
from ..core.dtypes import matmul_f32
from ..ops.attention import decode_attention, mha
from ..ops.normalization import rms_norm
from ..ops.rope import apply_rope, llm_rope_tables
from .param_utils import layer_slice, normal


class KVCache(NamedTuple):
    k: torch.Tensor       # [L, B, max_len, Hkv, Dh]
    v: torch.Tensor       # [L, B, max_len, Hkv, Dh]
    length: torch.Tensor  # [B] int32 — number of filled slots

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(batch, dtype=torch.int32, device=device))


def init_params(cfg: LLMConfig, *, generator: torch.Generator, device,
                dtype=torch.float32):
    D = cfg.hidden_size
    I = cfg.intermediate_size
    L = cfg.num_layers
    V = cfg.padded_vocab_size
    qkv_out = cfg.q_dim + 2 * cfg.kv_dim
    kw = dict(generator=generator, device=device, dtype=dtype)

    def init(shape):
        return normal(shape, 0.02, **kw)

    def ones(*shape):
        return torch.ones(*shape, device=device, dtype=dtype)

    return {
        "embed": init((V, D)),
        "layers": {
            "input_norm_w": ones(L, D),
            "qkv_kernel": init((L, D, qkv_out)),
            "o_kernel": init((L, cfg.q_dim, D)),
            "post_norm_w": ones(L, D),
            "gate_up_kernel": init((L, D, 2 * I)),
            "down_kernel": init((L, I, D)),
        },
        "final_norm_w": ones(D),
        "lm_head": init((D, V)),
    }


def embed_lookup(embed: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Dense embedding gather (the int8 table comes with the int8 stack)."""
    if not isinstance(embed, torch.Tensor):
        raise NotImplementedError(
            "embed_lookup: only the dense bf16/fp32 table is ported; the "
            "int8 embedding table comes with the int8 serving slice")
    return embed[token_ids]


def _dense(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    return x @ kernel


def _qkv(x, lp, cfg: LLMConfig):
    B, S, _ = x.shape
    q, k, v = _dense(x, lp["qkv_kernel"]).split(
        [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    return (q.reshape(B, S, cfg.num_heads, cfg.head_dim),
            k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim))


def _mlp(h, lp, cfg: LLMConfig):
    gate, up = _dense(h, lp["gate_up_kernel"]).chunk(2, dim=-1)
    return _dense(F.silu(gate) * up, lp["down_kernel"])


def _layer_full(x, lp, cfg: LLMConfig, cos, sin, attn_mask):
    """Full-sequence (prefill) layer → (x, (k, v))."""
    B, S, D = x.shape
    h = rms_norm(x, lp["input_norm_w"], cfg.rms_eps)
    q, k, v = _qkv(h, lp, cfg)
    q, k = apply_rope(q, k, cos, sin)
    attn = mha(q, k, v, causal=True, mask=attn_mask,
               sliding_window=cfg.sliding_window).reshape(B, S, cfg.q_dim)
    x = x + _dense(attn, lp["o_kernel"])
    h = rms_norm(x, lp["post_norm_w"], cfg.rms_eps)
    x = x + _mlp(h, lp, cfg)
    return x, (k, v)


def forward_hidden(params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
                   attn_mask: torch.Tensor, kv_out: tuple) -> torch.Tensor:
    """Run all decoder layers → hidden [B, S, D]; the JAX function with
    collect_kv=True and kv_pad_to=max_len.

    Every layer's k/v is written in place into kv_out, a cache's own
    [L, B, max_len, Hkv, Dh] buffers, so no second prompt-length copy
    exists. The LongRoPE factors are chosen from max_len, the cache
    capacity, as in JAX prefill."""
    S = inputs_embeds.shape[1]
    k_out, v_out = kv_out
    # left-padded prompts: position = cumsum(mask) - 1, clamped
    positions = (torch.cumsum(attn_mask.long(), dim=-1) - 1).clamp_min(0)
    cos, sin = llm_rope_tables(cfg, positions, seq_len_hint=k_out.shape[2])

    lay = params["layers"]
    x = inputs_embeds
    for i in range(lay["input_norm_w"].shape[0]):
        x, (k, v) = _layer_full(x, layer_slice(lay, i), cfg, cos, sin,
                                attn_mask)
        k_out[i, :, :S] = k
        v_out[i, :, :S] = v
    return rms_norm(x, params["final_norm_w"], cfg.rms_eps)


def logits_from_hidden(params, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits, accumulated in fp32 over the stored-dtype lm_head (no
    fp32 copy of the [D, V] matrix per step)."""
    return matmul_f32(hidden, params["lm_head"])


def prefill(params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
            attn_mask: torch.Tensor, cache: KVCache):
    """Run the left-padded prompt once → (last-position logits [B, V] fp32,
    KVCache filled up to S). The prompt's k/v are written into the given
    cache's buffers in place."""
    B, S, _ = inputs_embeds.shape
    hidden = forward_hidden(params, cfg, inputs_embeds, attn_mask,
                            (cache.k, cache.v))
    length = torch.full((B,), S, dtype=torch.int32,
                        device=inputs_embeds.device)
    logits = logits_from_hidden(params, hidden[:, -1:, :])
    return logits[:, 0], KVCache(cache.k, cache.v, length)


def decode_step(params, cfg: LLMConfig, token_embeds: torch.Tensor,
                cache: KVCache, valid_mask: torch.Tensor,
                positions: torch.Tensor,
                active: Optional[torch.Tensor] = None):
    """One decode step on the bf16 cache → (logits [B, V] fp32, cache,
    valid_mask with the new slot set). token_embeds [B, 1, D]; valid_mask
    [B, max_len] attendable slots; positions [B] of the new token."""
    if active is not None:
        # the bf16 write below uses one slot shared by every row; ragged
        # per-row slots (continuous batching) need the int8 scatter path
        raise NotImplementedError(
            "decode_step(active=...) (continuous batching) requires a "
            "QuantKVCache; the bf16 KVCache path writes one shared slot")
    B = token_embeds.shape[0]
    max_len = cache.k.shape[2]
    cos, sin = llm_rope_tables(cfg, positions[:, None], seq_len_hint=max_len)

    write_idx = cache.length.clamp_max(max_len - 1)      # [B]
    if cfg.sliding_window is not None:
        # keep the most recent `window` TOKENS: compare token positions (the
        # rank of each valid slot), not slot indices
        kpos = torch.cumsum(valid_mask.int(), dim=-1) - 1
        window_keep = positions[:, None] - kpos < cfg.sliding_window
        attn_valid = valid_mask.bool() & window_keep
    else:
        attn_valid = valid_mask.bool()

    # The cache is read-only inside the layer loop; the new token's k/v ride
    # as an extra attention slot and are written once afterwards.
    lay = params["layers"]
    x = token_embeds
    new_ks, new_vs = [], []
    for i in range(lay["input_norm_w"].shape[0]):
        lp = layer_slice(lay, i)
        h = rms_norm(x, lp["input_norm_w"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg)
        q, k = apply_rope(q, k, cos, sin)
        attn = decode_attention(q, cache.k[i], cache.v[i], attn_valid,
                                k_new=k, v_new=v)
        x = x + _dense(attn.reshape(B, 1, cfg.q_dim), lp["o_kernel"])
        h = rms_norm(x, lp["post_norm_w"], cfg.rms_eps)
        x = x + _mlp(h, lp, cfg)
        new_ks.append(k[:, 0])
        new_vs.append(v[:, 0])

    # One deferred write per cache, IN PLACE: batch serving keeps lengths
    # uniform (left-padded prompts), so every row writes the same slot. The
    # index stays a device tensor (no host sync per token). The caller's
    # cache tensors are updated; the returned cache shares them.
    slot_idx = write_idx[:1].long()
    for buf, new in ((cache.k, new_ks), (cache.v, new_vs)):
        buf.index_copy_(2, slot_idx,
                        torch.stack(new)[:, :, None].to(buf.dtype))
    new_cache = KVCache(cache.k, cache.v, cache.length + 1)
    slot = (torch.arange(max_len, device=valid_mask.device)[None, :]
            == write_idx[:, None])
    valid_mask = valid_mask.bool() | slot
    x = rms_norm(x, params["final_norm_w"], cfg.rms_eps)
    logits = logits_from_hidden(params, x)[:, 0]
    return logits, new_cache, valid_mask
