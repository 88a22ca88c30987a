"""Decoder-only causal LM, Phi-3.5-mini serving and training paths (port of
grounded_video_llm_tpu/models/llm.py).

Pre-RMSNorm blocks with a fused qkv projection, SiLU-gated fused gate_up MLP,
LongRoPE and fp32 logits. Weights are [D_in, D_out] kernels stacked along a
leading layer axis, as in the JAX package; after ``serve/quantize.py`` they
are ``Int8Weight``s and the embedding an ``Int8Embedding`` (activations then
run in bf16).

Decode uses a fixed-shape cache with a validity mask over slots: the bf16
``KVCache`` [L, B, max_len, Hkv, Dh] or the int8 ``QuantKVCache``
(ops/decode_attention_int8 for its layout). int8 projections below the
GEMM switch run ops/int8_matmul.int8_matmul, weight-only, except in a decode
step on the int8 cache, where a weight under the w8a8 marker runs its w8a8
branch (JAX's K3); there the attention runs K4 and the cache write K5.

Speculative verification (``verify_step``) scores S candidate tokens in one
pass over the int8 cache: the attention runs K8, the candidates' k/v ride
as bf16 in-pass slots and are written once afterwards by K9; neither the
cache length nor the valid mask moves until ``commit_verify`` advances them
by each row's accepted count.

Training runs ``forward_hidden`` without a cache: LoRA adapters on the four
fused projections (``layers/lora``, train/lora.py) with inverted dropout on
their input, per-layer or grouped activation checkpointing, and the
sequence-chunked cross entropy ``causal_lm_loss_from_hidden``. Serving and
training share one ``_layer_full``. Not ported yet: prefix-KV, cascade
decode (with ``verify_step_shared``) and continuous batching.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.config import LLMConfig
from ..core.dtypes import matmul_f32
from ..ops.attention import decode_attention, mha
from ..ops.cache_write import scatter_write, scatter_write_multi
from ..ops.decode_attention_int8 import (decode_attention_int8, quantize_kv,
                                         verify_attention_int8)
from ..ops.int8_matmul import (INT8_GEMM_MIN_ROWS, Int8Embedding, Int8Weight,
                               dynamic_int8_matmul, int8_matmul)
from ..ops.normalization import rms_norm
from ..ops.rope import apply_rope, llm_rope_tables
from .param_utils import child_generator, layer_slice, normal


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

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


class QuantKVCache(NamedTuple):
    """int8 KV cache with one fp32 scale per (slot, kv head). Unwritten
    slots hold 0 with scale 1, the JAX package's padding."""
    k: torch.Tensor        # [L, B, Hkv, max_len, Dh] int8
    k_scale: torch.Tensor  # [L, B, Hkv, max_len] fp32
    v: torch.Tensor
    v_scale: torch.Tensor
    length: torch.Tensor   # [B] int32

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int, max_len: int, device=None):
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len,
                 cfg.head_dim)

        def values():
            return torch.zeros(shape, dtype=torch.int8, device=device)

        def scales():
            return torch.ones(shape[:4], dtype=torch.float32, device=device)

        return cls(values(), scales(), values(), scales(),
                   torch.zeros(batch, dtype=torch.int32, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def init_params(cfg: LLMConfig, *, generator: Optional[torch.Generator],
                device, dtype=torch.float32, skip=frozenset()):
    """The seeded random LLM: embed, layers and lm_head each draw from their
    own generator, seeded from ``generator`` in that order; skip: top-level
    paths (("embed",), ("lm_head",), ...) left on the meta device."""
    D = cfg.hidden_size
    I = cfg.intermediate_size
    L = cfg.num_layers
    V = cfg.padded_vocab_size
    qkv_out = cfg.q_dim + 2 * cfg.kv_dim

    def entry(name, make):
        g = child_generator(generator, device)
        if (name,) in skip:
            return make(None, "meta")
        return make(g, device)

    def init(shape, g, dev):
        return normal(shape, 0.02, generator=g, device=dev, dtype=dtype)

    def ones(*shape, dev):
        return torch.ones(*shape, device=dev, dtype=dtype)

    return {
        "embed": entry("embed", lambda g, dev: init((V, D), g, dev)),
        "layers": entry("layers", lambda g, dev: {
            "input_norm_w": ones(L, D, dev=dev),
            "qkv_kernel": init((L, D, qkv_out), g, dev),
            "o_kernel": init((L, cfg.q_dim, D), g, dev),
            "post_norm_w": ones(L, D, dev=dev),
            "gate_up_kernel": init((L, D, 2 * I), g, dev),
            "down_kernel": init((L, I, D), g, dev),
        }),
        "final_norm_w": entry("final_norm_w",
                              lambda g, dev: ones(D, dev=dev)),
        "lm_head": entry("lm_head", lambda g, dev: init((D, V), g, dev)),
    }


def embed_lookup(embed, token_ids: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding gather; an int8 table dequantizes its rows into dtype."""
    if isinstance(embed, Int8Embedding):
        rows = embed.q[token_ids].float()
        return (rows * embed.scale[token_ids][..., None]).to(dtype)
    return embed[token_ids]


def embed_dtype(embed) -> torch.dtype:
    """Activation dtype implied by an embedding table (int8 → bf16)."""
    return torch.bfloat16 if isinstance(embed, Int8Embedding) else embed.dtype


def _matmul_maybe_int8(x: torch.Tensor, kernel,
                       w8a8_decode: bool = False) -> torch.Tensor:
    """x [..., D] @ kernel for a dense or int8 weight. int8 with rows at or
    above INT8_GEMM_MIN_ROWS: W8A8 under the w8a8 marker, else the weight
    dequantized once into x's dtype and a plain matmul; fewer rows: the int8
    decode kernel, weight-only unless w8a8_decode (a decode step on the int8
    cache) and the weight carries the marker."""
    if not isinstance(kernel, Int8Weight):
        return x @ kernel
    rows = x.numel() // x.shape[-1]
    if rows >= INT8_GEMM_MIN_ROWS:
        if kernel.w8a8:
            return dynamic_int8_matmul(x, kernel.q, kernel.scale)
        w = kernel.q.to(x.dtype) * kernel.scale.to(x.dtype)
        return matmul_f32(x, w).to(x.dtype)
    out = int8_matmul(x.reshape(-1, x.shape[-1]), kernel.q, kernel.scale,
                      w8a8_decode and kernel.w8a8)
    return out.reshape(*x.shape[:-1], out.shape[-1])


_LORA_SLOT = {"qkv": 0, "o": 1, "gate_up": 2, "down": 3}


def mix_seed(*ints: int) -> int:
    """One 63-bit seed from a tuple of integers (numpy SeedSequence): the
    port's counterpart of jax.random.fold_in / split for dropout keys."""
    return int(np.random.SeedSequence([int(i) for i in ints])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


def lora_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout, keep probability 1 - rate, kept values scaled by
    1 / (1 - rate). The mask is drawn from a torch.Generator seeded with
    ``seed`` on x's device, so an activation-checkpoint recompute draws the
    same mask whatever the global RNG state is."""
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _dense(x, kernel, lp, name: str, drop=None, w8a8_decode: bool = False):
    """x @ kernel plus the LoRA overlay ((x @ A) @ B) * scale when the layer
    carries one for ``name``; the delta matrix is never formed. drop:
    (rate, layer seed) for training-only dropout on the LoRA branch input,
    as peft does (the frozen base path sees x untouched)."""
    y = _matmul_maybe_int8(x, kernel, w8a8_decode)
    lora = lp.get("lora")
    if lora is not None and name in lora:
        la = lora[name]
        xl = x
        if drop is not None:
            rate, seed = drop
            xl = lora_dropout(x, rate, mix_seed(seed, _LORA_SLOT[name]))
        y = y + ((xl @ la["a"]) @ la["b"]) * la["scale"][..., None, None]
    return y


def _qkv(x, lp, cfg: LLMConfig, w8a8_decode: bool = False, drop=None):
    B, S, _ = x.shape
    q, k, v = _dense(x, lp["qkv_kernel"], lp, "qkv", drop,
                     w8a8_decode).split(
        [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    return (q.reshape(B, S, cfg.num_heads, cfg.head_dim),
            k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim))


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu as the JAX package computes it, x * 1 / (1 + exp(-x)),
    rounding to x's dtype after each step (in bf16 that is not
    F.silu's single rounding)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _mlp(h, lp, cfg: LLMConfig, w8a8_decode: bool = False, drop=None):
    gate, up = _dense(h, lp["gate_up_kernel"], lp, "gate_up", drop,
                      w8a8_decode).chunk(2, dim=-1)
    return _dense(silu(gate) * up, lp["down_kernel"], lp, "down", drop,
                  w8a8_decode)


def _layer_full(x, lp, cfg: LLMConfig, cos, sin, attn_mask, drop=None):
    """Full-sequence (train / prefill) layer → (x, (k, v))."""
    B, S, D = x.shape
    h = rms_norm(x, lp["input_norm_w"], cfg.rms_eps)
    q, k, v = _qkv(h, lp, cfg, drop=drop)
    q, k = apply_rope(q, k, cos, sin)
    attn = mha(q, k, v, causal=True, mask=attn_mask,
               sliding_window=cfg.sliding_window).reshape(B, S, cfg.q_dim)
    x = x + _dense(attn, lp["o_kernel"], lp, "o", drop)
    h = rms_norm(x, lp["post_norm_w"], cfg.rms_eps)
    x = x + _mlp(h, lp, cfg, drop=drop)
    return x, (k, v)


def _write_prompt_kv(cache, i: int, k: torch.Tensor, v: torch.Tensor):
    """Layer i's prompt k/v [B, S, Hkv, Dh] into the cache's slots [0, S):
    as they are (bf16 cache) or quantized per (slot, kv head) (int8)."""
    S = k.shape[1]
    if isinstance(cache, KVCache):
        cache.k[i, :, :S] = k
        cache.v[i, :, :S] = v
        return
    for vals, scales, x in ((cache.k, cache.k_scale, k),
                            (cache.v, cache.v_scale, v)):
        xq, xs = quantize_kv(x)                  # [B,S,Hkv,Dh], [B,S,Hkv]
        vals[i, :, :, :S] = xq.transpose(1, 2)
        scales[i, :, :, :S] = xs.transpose(1, 2)


def forward_hidden(params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
                   attn_mask: torch.Tensor, cache=None, *, remat: bool = False,
                   remat_group: int = 1, lora_dropout: float = 0.0,
                   dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Run all decoder layers → hidden [B, S, D] after the final norm.

    With a cache (prefill; the JAX function with collect_kv=True and
    kv_pad_to=max_len): every layer's k/v is written in place into the
    cache's buffers (a KVCache or QuantKVCache), so no second prompt-length
    copy exists, and the LongRoPE factors are chosen from max_len, the cache
    capacity.

    Without one (training): the factors are chosen from S, the reference's
    per-forward rule. remat checkpoints every layer, or every remat_group
    layers (torch.utils.checkpoint, non-reentrant): the backward recomputes
    each group's forward once, so only the group boundaries stay alive.
    lora_dropout > 0 with a dropout_seed drops the LoRA branch inputs, each
    layer and projection with its own seed derived from dropout_seed."""
    # left-padded prompts: position = cumsum(mask) - 1, clamped
    positions = (torch.cumsum(attn_mask.long(), dim=-1) - 1).clamp_min(0)
    S = inputs_embeds.shape[1]
    cos, sin = llm_rope_tables(
        cfg, positions,
        seq_len_hint=cache.max_len if cache is not None else S)

    lay = params["layers"]
    L = lay["input_norm_w"].shape[0]
    x = inputs_embeds
    if cache is not None:
        if remat or lora_dropout > 0.0:
            raise ValueError("forward_hidden: remat and dropout are for the "
                             "cache-free training forward")
        for i in range(L):
            x, (k, v) = _layer_full(x, layer_slice(lay, i), cfg, cos, sin,
                                    attn_mask)
            _write_prompt_kv(cache, i, k, v)
        return rms_norm(x, params["final_norm_w"], cfg.rms_eps)

    def drop_for(i):
        if lora_dropout > 0.0 and dropout_seed is not None:
            return (lora_dropout, mix_seed(dropout_seed, i))
        return None

    def run(h, first, count):
        for i in range(first, first + count):
            h, _ = _layer_full(h, layer_slice(lay, i), cfg, cos, sin,
                               attn_mask, drop_for(i))
        return h

    group = remat_group if remat else 1
    if L % group:
        raise ValueError(f"remat_group {group} must divide num_layers {L}")
    for first in range(0, L, group):
        if remat:
            # the dropout masks come from explicit per-layer seeds, so the
            # recompute needs no saved RNG state
            x = checkpoint(run, x, first, group, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = run(x, first, group)
    return rms_norm(x, params["final_norm_w"], cfg.rms_eps)


def logits_from_hidden(params, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits. A dense lm_head accumulates in fp32 over its stored
    dtype (no fp32 copy of the [D, V] matrix per step); an int8 lm_head
    gives x's dtype first, then fp32, as in the JAX package."""
    lm_head = params["lm_head"]
    if isinstance(lm_head, Int8Weight):
        return _matmul_maybe_int8(hidden, lm_head).float()
    return matmul_f32(hidden, lm_head)


def forward_logits(params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
                   attn_mask: torch.Tensor, remat: bool = False,
                   lora_dropout: float = 0.0,
                   dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Training forward → fp32 logits [B, S, V]."""
    hidden = forward_hidden(params, cfg, inputs_embeds, attn_mask,
                            remat=remat, lora_dropout=lora_dropout,
                            dropout_seed=dropout_seed)
    return logits_from_hidden(params, hidden)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -100) -> torch.Tensor:
    """Shifted cross entropy in fp32, the mean over non-ignored targets
    (HF CausalLM loss semantics)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != ignore_index
    safe = torch.where(valid, shift_labels, 0).long()
    logp = torch.log_softmax(shift_logits, dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    total = torch.where(valid, -ll, 0.0).sum()
    return total / valid.sum().clamp_min(1)


class _ChunkedCE(torch.autograd.Function):
    """Sum of the shifted cross entropy over chunks of the sequence, the
    fp32 [chunk, V] logits of one chunk at a time: the forward keeps none of
    them, the backward recomputes each chunk's logits (the JAX scan body
    under jax.checkpoint). d lm_head is summed over the chunks in fp32 and
    cast once. Returns (total, count) as fp32 scalars; count has no
    gradient."""

    @staticmethod
    def forward(ctx, hidden, lm_head, labels, ignore_index, chunk):
        B, S, _ = hidden.shape
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        count = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, S - 1, chunk):
            c1 = min(c0 + chunk, S - 1)
            logits = matmul_f32(hidden[:, c0:c1], lm_head)
            lab = labels[:, c0 + 1:c1 + 1]
            valid = lab != ignore_index
            safe = torch.where(valid, lab, 0).long()
            logp = torch.log_softmax(logits, dim=-1)
            ll = torch.gather(logp, -1, safe[..., None])[..., 0]
            total = total + torch.where(valid, -ll, 0.0).sum()
            count = count + valid.sum()
        ctx.save_for_backward(hidden, lm_head, labels)
        ctx.ignore_index, ctx.chunk = ignore_index, chunk
        ctx.mark_non_differentiable(count)
        return total, count

    @staticmethod
    def backward(ctx, g_total, _g_count):
        hidden, lm_head, labels = ctx.saved_tensors
        B, S, D = hidden.shape
        d_hidden = torch.zeros_like(hidden) if ctx.needs_input_grad[0] \
            else None
        d_head = (torch.zeros(lm_head.shape, dtype=torch.float32,
                              device=lm_head.device)
                  if ctx.needs_input_grad[1] else None)
        for c0 in range(0, S - 1, ctx.chunk):
            c1 = min(c0 + ctx.chunk, S - 1)
            h_c = hidden[:, c0:c1]
            logits = matmul_f32(h_c, lm_head)
            lab = labels[:, c0 + 1:c1 + 1]
            valid = lab != ctx.ignore_index
            safe = torch.where(valid, lab, 0).long()
            # d(-log softmax[label]) / d logits = softmax - onehot(label)
            g = torch.softmax(logits, dim=-1)
            g.scatter_add_(-1, safe[..., None],
                           -torch.ones_like(g[..., :1]))
            g = g * (valid[..., None] * g_total)
            g = g.to(hidden.dtype)
            if d_hidden is not None:
                d_hidden[:, c0:c1] = matmul_f32(g, lm_head.t()).to(
                    hidden.dtype)
            if d_head is not None:
                d_head += matmul_f32(h_c.reshape(-1, D).t(),
                                     g.reshape(-1, g.shape[-1]))
        if d_head is not None:
            d_head = d_head.to(lm_head.dtype)
        return d_hidden, d_head, None, None, None


def causal_lm_loss_from_hidden(params, hidden: torch.Tensor,
                               labels: torch.Tensor, ignore_index: int = -100,
                               chunk: int = 1024) -> torch.Tensor:
    """Sequence-chunked shifted cross entropy: the same value as
    logits_from_hidden + causal_lm_loss, but the fp32 [S, V] logits never
    exist whole (at S = 7.5k and V = 32k they would be 0.93 GB, twice over
    in the backward); each chunk's are recomputed in the backward."""
    total, count = _ChunkedCE.apply(hidden, params["lm_head"], labels,
                                    ignore_index, chunk)
    return total / count.clamp_min(1)


def prefill(params, cfg: LLMConfig, inputs_embeds: torch.Tensor,
            attn_mask: torch.Tensor, cache):
    """Run the left-padded prompt once → (last-position logits [B, V] fp32,
    the cache filled up to S). The cache's type (KVCache or QuantKVCache)
    decides how the prompt's k/v are stored; its buffers are written in
    place."""
    B, S, _ = inputs_embeds.shape
    hidden = forward_hidden(params, cfg, inputs_embeds, attn_mask, cache)
    length = torch.full((B,), S, dtype=torch.int32,
                        device=inputs_embeds.device)
    logits = logits_from_hidden(params, hidden[:, -1:, :])
    return logits[:, 0], cache._replace(length=length)


def decode_step(params, cfg: LLMConfig, token_embeds: torch.Tensor,
                cache, valid_mask: torch.Tensor, positions: torch.Tensor,
                active: Optional[torch.Tensor] = None):
    """One decode step → (logits [B, V] fp32, cache, valid_mask with the new
    slot set). token_embeds [B, 1, D]; cache a KVCache or QuantKVCache;
    valid_mask [B, max_len] attendable slots; positions [B] of the new
    token. The caller's cache buffers are updated in place; the returned
    cache shares them."""
    if active is not None:
        raise NotImplementedError(
            "decode_step(active=...) (continuous batching) is not ported yet")
    quant = isinstance(cache, QuantKVCache)
    B = token_embeds.shape[0]
    max_len = cache.max_len
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
        q, k, v = _qkv(h, lp, cfg, w8a8_decode=quant)
        q, k = apply_rope(q, k, cos, sin)
        if quant:
            attn = decode_attention_int8(
                q, cache.k[i], cache.k_scale[i], cache.v[i], cache.v_scale[i],
                attn_valid, k, v, scale=cfg.head_dim ** -0.5)
        else:
            attn = decode_attention(q, cache.k[i], cache.v[i], attn_valid,
                                    k_new=k, v_new=v)
        x = x + _dense(attn.reshape(B, 1, cfg.q_dim), lp["o_kernel"], lp,
                       "o", w8a8_decode=quant)
        h = rms_norm(x, lp["post_norm_w"], cfg.rms_eps)
        x = x + _mlp(h, lp, cfg, w8a8_decode=quant)
        new_ks.append(k[:, 0])
        new_vs.append(v[:, 0])

    if quant:
        # quantize the step's k/v per (layer, row, kv head), then one K5
        # launch writes values and scales at each row's own slot
        kq, ks = quantize_kv(torch.stack(new_ks))        # [L,B,Hkv,Dh]
        vq, vs = quantize_kv(torch.stack(new_vs))
        scatter_write([cache.k, cache.k_scale, cache.v, cache.v_scale],
                      [kq, ks, vq, vs], write_idx)
    else:
        # batch serving keeps lengths uniform (left-padded prompts), so every
        # row writes the same slot; the index stays a device tensor (no host
        # sync per token)
        slot_idx = write_idx[:1].long()
        for buf, new in ((cache.k, new_ks), (cache.v, new_vs)):
            buf.index_copy_(2, slot_idx,
                            torch.stack(new)[:, :, None].to(buf.dtype))
    new_cache = cache._replace(length=cache.length + 1)
    slot = (torch.arange(max_len, device=valid_mask.device)[None, :]
            == write_idx[:, None])
    valid_mask = valid_mask.bool() | slot
    x = rms_norm(x, params["final_norm_w"], cfg.rms_eps)
    logits = logits_from_hidden(params, x)[:, 0]
    return logits, new_cache, valid_mask


def verify_step(params, cfg: LLMConfig, token_embeds: torch.Tensor, cache,
                valid_mask: torch.Tensor, positions: torch.Tensor):
    """Speculative verify: score S candidate tokens (the last committed
    token and S - 1 drafts) in one pass over the int8 cache → (logits
    [B, S, V] fp32, cache). logits[:, i] is the next-token distribution
    after candidate i, what S sequential decode_steps would give up to the
    in-pass candidates' k/v staying bf16.

    token_embeds [B, S, D]; valid_mask [B, max_len] committed slots;
    positions [B, S]. All S candidates' k/v are written at slots
    base..base+S-1, base = min(length, max_len - S), in place; length and
    valid_mask do not move (commit_verify does that). Requires a
    QuantKVCache; S <= 128."""
    if not isinstance(cache, QuantKVCache):
        raise NotImplementedError(
            "verify_step requires a QuantKVCache (int8 serving path)")
    B, S = token_embeds.shape[:2]
    max_len = cache.max_len
    cos, sin = llm_rope_tables(cfg, positions, seq_len_hint=max_len)
    base = cache.length.clamp_max(max_len - S)
    valid = valid_mask.bool()
    if cfg.sliding_window is not None:
        # per candidate position, by token position (the valid-slot rank)
        kpos = torch.cumsum(valid.int(), dim=-1) - 1
        window_keep = (positions[:, :, None] - kpos[:, None, :]
                       < cfg.sliding_window)
        attn_valid = valid[:, None, :] & window_keep
    else:
        attn_valid = valid[:, None, :].expand(B, S, max_len)
    attn_valid = attn_valid.contiguous()

    lay = params["layers"]
    x = token_embeds
    new_ks, new_vs = [], []
    for i in range(lay["input_norm_w"].shape[0]):
        lp = layer_slice(lay, i)
        h = rms_norm(x, lp["input_norm_w"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, w8a8_decode=True)
        q, k = apply_rope(q, k, cos, sin)
        attn = verify_attention_int8(
            q, cache.k[i], cache.k_scale[i], cache.v[i], cache.v_scale[i],
            attn_valid, k, v, scale=cfg.head_dim ** -0.5)
        x = x + _dense(attn.reshape(B, S, cfg.q_dim), lp["o_kernel"], lp,
                       "o", w8a8_decode=True)
        h = rms_norm(x, lp["post_norm_w"], cfg.rms_eps)
        x = x + _mlp(h, lp, cfg, w8a8_decode=True)
        new_ks.append(k)
        new_vs.append(v)

    # quantize the candidates' k/v per (layer, row, slot, kv head), then one
    # K9 launch writes values and scales at base..base+S-1 of each row
    kq, ks = quantize_kv(torch.stack(new_ks))            # [L,B,S,Hkv,Dh]
    vq, vs = quantize_kv(torch.stack(new_vs))
    scatter_write_multi([cache.k, cache.k_scale, cache.v, cache.v_scale],
                        [kq, ks, vq, vs], base)
    x = rms_norm(x, params["final_norm_w"], cfg.rms_eps)
    return logits_from_hidden(params, x), cache


def commit_verify(cache, valid_mask: torch.Tensor, n_accept: torch.Tensor,
                  draft_len: int):
    """Commit the first n_accept[b] of the draft_len candidate slots that
    verify_step wrote → (cache with length advanced, valid_mask with those
    slots set). Rejected slots stay invalid and are rewritten by the next
    verify_step."""
    max_len = cache.max_len
    base = cache.length.clamp_max(max_len - draft_len)
    slots = torch.arange(max_len, device=valid_mask.device)[None, :]
    newly = (slots >= base[:, None]) & (slots < (base + n_accept)[:, None])
    return (cache._replace(length=cache.length + n_accept.to(torch.int32)),
            valid_mask.bool() | newly)
