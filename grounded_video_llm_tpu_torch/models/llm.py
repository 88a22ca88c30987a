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
training share one ``_layer_full``.

Prefix-KV serving (serve/generate.build_prefix_kv): ``prefill_continue``
prefills a question chunk against a per-video bf16 prefix K/V built once
(its queries attend [prefix ; chunk] in ``_rect_attention``, the prefix
kept at batch 1), into a bf16 ``KVCache``, a ``QuantKVCache`` or, with
``tail_len``, a ``SharedPrefixCache``: the prefix quantized once at batch
1 and a per-row int8 tail. ``decode_step_shared`` and
``verify_step_shared`` attend over that cascade (``_cascade_attention``,
plain torch as the JAX package's is plain XLA); the tail is written by K5
and K9.

Continuous batching (serve/continuous.py) runs ``decode_step`` and
``decode_step_shared`` with ``active`` [B]: an inactive row (a free or
finished pool slot) still writes its step's k/v at its clamped slot, in the
same K5 launch as every other row, but neither advances its length nor sets
a valid slot, so it idles in place.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..core.config import LLMConfig
from ..core.dtypes import matmul_f32
from ..ops.attention import decode_attention, mha
from ..ops.cache_write import scatter_write, scatter_write_multi
from ..ops.decode_attention_int8 import (decode_attention_int8, quantize_kv,
                                         verify_attention_int8)
from ..ops.flash_attention import NEG_INF
from ..ops.int8_matmul import (INT8_GEMM_MIN_ROWS, Int8Embedding, Int8Weight,
                               dynamic_int8_matmul, int8_matmul)
from ..ops.normalization import rms_norm
from ..ops.rope import apply_rope, llm_rope_tables
from ..parallel import tensor as tp
from ..parallel.partitioning import gather
from ..parallel.tensor import (TensorGroup, ce_local_grad, ce_local_logits,
                               ce_local_sums, local_columns, tensor_group,
                               vocab_shard)
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
    """Embedding gather; an int8 table dequantizes its rows into dtype. A
    sharded table is gathered over fsdp; one whose hidden dim 'tensor'
    splits gives this rank's columns of the rows, then all-gathers
    them."""
    if isinstance(embed, Int8Embedding):
        rows = embed.q[token_ids].float()
        return (rows * embed.scale[token_ids][..., None]).to(dtype)
    rows = gather(embed)[token_ids]
    tg = tensor_group(embed)
    return rows if tg is None else tp.gather_last(rows, tg)


def embed_dtype(embed) -> torch.dtype:
    """Activation dtype implied by an embedding table (int8 → bf16)."""
    return torch.bfloat16 if isinstance(embed, Int8Embedding) else embed.dtype


def _rank_view(params, cfg: LLMConfig):
    """(the tensor group that splits the layers or None, rank_config).
    parallel/partitioning.shard_params has checked that t divides the
    heads and the MLP width."""
    tg = tensor_group(params["layers"]["qkv_kernel"])
    if tg is None:
        return None, cfg
    t = tg.size
    return tg, dataclasses.replace(
        cfg, num_heads=cfg.num_heads // t,
        num_kv_heads=cfg.num_kv_heads // t,
        intermediate_size=cfg.intermediate_size // t)


def rank_config(params, cfg: LLMConfig) -> LLMConfig:
    """This rank's view of cfg: the heads, kv heads and MLP width over the
    'tensor' axis that splits params' layers (cfg itself where none does;
    the hidden size is whole). The layers run on it, and KVCache.create /
    QuantKVCache.create from it hold the rank's kv heads."""
    return _rank_view(params, cfg)[1]


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


def lora_dropout(x: torch.Tensor, rate: float, seed: int,
                 cols=None) -> torch.Tensor:
    """Inverted dropout, keep probability 1 - rate, kept values scaled by
    1 / (1 - rate). The mask is drawn from a torch.Generator seeded with
    ``seed`` on x's device, so an activation-checkpoint recompute draws the
    same mask whatever the global RNG state is. cols (width, first): x is
    those columns of a wider input (a row-split product's), and its mask
    is the same columns of the mask the whole input draws."""
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    shape = x.shape if cols is None else x.shape[:-1] + (cols[0],)
    keep = torch.rand(shape, generator=g, device=x.device) < 1.0 - rate
    if cols is not None:
        keep = keep[..., cols[1]:cols[1] + x.shape[-1]]
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _dense(x, kernel, lp, name: str, drop=None, w8a8_decode: bool = False,
           tg: Optional[TensorGroup] = None, blocks=None):
    """x @ kernel plus the LoRA overlay ((x @ A) @ B) * scale when the layer
    carries one for ``name``; the delta matrix is never formed. drop:
    (rate, layer seed) for training-only dropout on the LoRA branch input,
    as peft does (the frozen base path sees x untouched).

    tg: the layer is split over it. With blocks (the leaf's whole column
    blocks) the product is column-split: x is whole and the kernel holds
    this rank's columns; without, row-split: x is this rank's columns of
    the input and the kernel its rows."""
    if tg is not None:
        return (_dense_columns(x, kernel, lp, name, drop, tg, blocks)
                if blocks is not None
                else _dense_rows(x, kernel, lp, name, drop, tg))
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


def _dense_columns(x, kernel, lp, name, drop, tg: TensorGroup, blocks):
    """A column-split _dense: the whole x through tp.copy (its gradient is
    summed over the group), this rank's columns out. The LoRA B is
    replicated and sliced to the same columns; A and B go through tp.copy,
    as each rank's gradient of them is a part."""
    x = tp.copy(x, tg)
    y = x @ kernel
    la = lp.get("lora", {}).get(name)
    if la is not None:
        xl = x
        if drop is not None:
            rate, seed = drop
            xl = lora_dropout(x, rate, mix_seed(seed, _LORA_SLOT[name]))
        b = local_columns(tp.copy(la["b"], tg), blocks, tg.size, tg.rank)
        y = y + ((xl @ tp.copy(la["a"], tg)) @ b) * la["scale"][..., None,
                                                               None]
    return y


def _dense_rows(x, kernel, lp, name, drop, tg: TensorGroup):
    """A row-split _dense: this rank's partial product of its input
    columns, accumulated in fp32 with its partial LoRA term ((x @ A's rows)
    @ B), then one fp32 all-reduce over the group and one rounding to x's
    dtype: the single-process product up to the order of its sum. A
    dropout mask is the slice of the mask the whole input draws."""
    n = x.shape[-1]
    y = tp.partial_product(x, kernel)
    la = lp.get("lora", {}).get(name)
    if la is not None:
        xl = x
        if drop is not None:
            rate, seed = drop
            xl = lora_dropout(x, rate, mix_seed(seed, _LORA_SLOT[name]),
                              cols=(n * tg.size, n * tg.rank))
        a = tp.copy(la["a"], tg).narrow(-2, n * tg.rank, n)
        h = tp.partial_product(xl, a).to(x.dtype)
        y = y + (tp.partial_product(h, tp.copy(la["b"], tg))
                 * la["scale"].float())
    return tp.reduce(y, tg).to(x.dtype)


def _qkv(x, lp, cfg: LLMConfig, w8a8_decode: bool = False, drop=None,
         tg: Optional[TensorGroup] = None):
    """cfg: the rank's (rank_config); under tg this rank's heads."""
    B, S, _ = x.shape
    blocks = None if tg is None else tuple(
        tg.size * n for n in (cfg.q_dim, cfg.kv_dim, cfg.kv_dim))
    q, k, v = _dense(x, lp["qkv_kernel"], lp, "qkv", drop,
                     w8a8_decode, tg, blocks).split(
        [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    return (q.reshape(B, S, cfg.num_heads, cfg.head_dim),
            k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim))


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu as the JAX package computes it, x * 1 / (1 + exp(-x)),
    rounding to x's dtype after each step (in bf16 that is not
    F.silu's single rounding)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _mlp(h, lp, cfg: LLMConfig, w8a8_decode: bool = False, drop=None,
         tg: Optional[TensorGroup] = None):
    """Under tg: this rank's gate and up columns (gate_up's shard is gate
    block r then up block r), down row-split."""
    blocks = (None if tg is None
              else (tg.size * cfg.intermediate_size,) * 2)
    gate, up = _dense(h, lp["gate_up_kernel"], lp, "gate_up", drop,
                      w8a8_decode, tg, blocks).chunk(2, dim=-1)
    return _dense(silu(gate) * up, lp["down_kernel"], lp, "down", drop,
                  w8a8_decode, tg)


def _layer_full(x, lp, cfg: LLMConfig, cos, sin, attn_mask, drop=None,
                tg: Optional[TensorGroup] = None):
    """Full-sequence (train / prefill) layer → (x, (k, v)); cfg and the
    k/v are the rank's."""
    B, S, D = x.shape
    h = rms_norm(x, lp["input_norm_w"], cfg.rms_eps)
    q, k, v = _qkv(h, lp, cfg, drop=drop, tg=tg)
    q, k = apply_rope(q, k, cos, sin)
    attn = mha(q, k, v, causal=True, mask=attn_mask,
               sliding_window=cfg.sliding_window).reshape(B, S, cfg.q_dim)
    x = x + _dense(attn, lp["o_kernel"], lp, "o", drop, tg=tg)
    h = rms_norm(x, lp["post_norm_w"], cfg.rms_eps)
    x = x + _mlp(h, lp, cfg, drop=drop, tg=tg)
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
                   dropout_seed: Optional[int] = None,
                   rope_hint: Optional[int] = None) -> torch.Tensor:
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
    layer and projection with its own seed derived from dropout_seed.

    rope_hint overrides the capacity (or S) as the LongRoPE factor choice:
    build_prefix_kv fills a cache of the prefix's own length but must pick
    the factors of the continuation's capacity.

    On a mesh whose 'tensor' axis splits the layers, each rank runs its
    heads and MLP columns (rank_config) and the cache holds its kv
    heads."""
    tg, cfg = _rank_view(params, cfg)
    # left-padded prompts: position = cumsum(mask) - 1, clamped
    positions = (torch.cumsum(attn_mask.long(), dim=-1) - 1).clamp_min(0)
    S = inputs_embeds.shape[1]
    if rope_hint is None:
        rope_hint = cache.max_len if cache is not None else S
    cos, sin = llm_rope_tables(cfg, positions, seq_len_hint=rope_hint)

    lay = params["layers"]
    L = lay["input_norm_w"].shape[0]
    x = inputs_embeds
    if cache is not None:
        if remat or lora_dropout > 0.0:
            raise ValueError("forward_hidden: remat and dropout are for the "
                             "cache-free training forward")
        for i in range(L):
            x, (k, v) = _layer_full(x, layer_slice(lay, i), cfg, cos, sin,
                                    attn_mask, tg=tg)
            _write_prompt_kv(cache, i, k, v)
        return rms_norm(x, params["final_norm_w"], cfg.rms_eps)

    def drop_for(i):
        if lora_dropout > 0.0 and dropout_seed is not None:
            return (lora_dropout, mix_seed(dropout_seed, i))
        return None

    def run(h, first, count):
        for i in range(first, first + count):
            h, _ = _layer_full(h, layer_slice(lay, i), cfg, cos, sin,
                               attn_mask, drop_for(i), tg)
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
    gives x's dtype first, then fp32, as in the JAX package. An lm_head
    whose hidden dim 'tensor' splits: this rank's hidden columns times its
    rows, the partial fp32 logits all-reduced, so every rank of the group
    holds the whole vocabulary (and samples the same token)."""
    lm_head = params["lm_head"]
    if isinstance(lm_head, Int8Weight):
        return _matmul_maybe_int8(hidden, lm_head).float()
    tg = tensor_group(lm_head)
    if tg is None:
        return matmul_f32(hidden, gather(lm_head))
    return tp.reduce(tp.partial_product(tp.split_last(hidden, tg),
                                        gather(lm_head)), tg)


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


def _vp_logits(h: torch.Tensor, lm_head: torch.Tensor, tg: TensorGroup,
               n: int, real: int) -> torch.Tensor:
    """This rank's [B, c, n] fp32 chunk logits: its hidden columns times
    its lm_head rows, the partial logits (V padded to n·t) reduce-scattered
    over the vocabulary; padding columns at -inf."""
    partial = matmul_f32(h, lm_head)
    pad = n * tg.size - partial.shape[-1]
    if pad:
        partial = torch.nn.functional.pad(partial, (0, pad))
    return ce_local_logits(tp.reduce_scatter(partial, partial.dim() - 1,
                                             tg.size, tg.group), real)


class _VocabParallelCE(torch.autograd.Function):
    """_ChunkedCE over a tensor group (the JAX package's vocabulary-split
    chunk logits): hidden is this rank's columns [B, S, D/t], lm_head its
    rows [D/t, V]. Each chunk's logits are reduce-scattered over V, so a
    rank holds [B, c, V/t]; the row maxima are all-reduced (max), then the
    sums of exponentials and the target logit, which only the label's
    owner holds (sum). The backward recomputes the rank's logits, takes
    its columns of softmax - onehot from the saved log-sum-exp,
    all-gathers them over V, and gives d hidden for its columns and
    d lm_head for its rows. (total, count) as _ChunkedCE's, the same on
    every rank of the group."""

    @staticmethod
    def forward(ctx, hidden, lm_head, labels, ignore_index, chunk, tg):
        B, S, _ = hidden.shape
        n, v0, real = vocab_shard(lm_head.shape[-1], tg.size, tg.rank)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        count = torch.zeros((), dtype=torch.float32, device=hidden.device)
        lses = []
        for c0 in range(0, S - 1, chunk):
            c1 = min(c0 + chunk, S - 1)
            logits = _vp_logits(hidden[:, c0:c1], lm_head, tg, n, real)
            lab = labels[:, c0 + 1:c1 + 1]
            valid = lab != ignore_index
            safe = torch.where(valid, lab, 0).long()
            row_max = logits.amax(dim=-1)
            dist.all_reduce(row_max, op=dist.ReduceOp.MAX, group=tg.group)
            sums = torch.stack(ce_local_sums(logits, safe, v0, row_max))
            dist.all_reduce(sums, group=tg.group)
            lse = row_max + torch.log(sums[0])
            total = total + torch.where(valid, lse - sums[1], 0.0).sum()
            count = count + valid.sum()
            lses.append(lse)
        ctx.save_for_backward(hidden, lm_head, labels, torch.cat(lses, 1))
        ctx.ignore_index, ctx.chunk, ctx.tg = ignore_index, chunk, tg
        ctx.mark_non_differentiable(count)
        return total, count

    @staticmethod
    def backward(ctx, g_total, _g_count):
        hidden, lm_head, labels, lse = ctx.saved_tensors
        tg = ctx.tg
        B, S, D = hidden.shape
        V = lm_head.shape[-1]
        n, v0, real = vocab_shard(V, tg.size, tg.rank)
        d_hidden = torch.zeros_like(hidden) if ctx.needs_input_grad[0] \
            else None
        d_head = (torch.zeros(lm_head.shape, dtype=torch.float32,
                              device=lm_head.device)
                  if ctx.needs_input_grad[1] else None)
        for c0 in range(0, S - 1, ctx.chunk):
            c1 = min(c0 + ctx.chunk, S - 1)
            h_c = hidden[:, c0:c1]
            logits = _vp_logits(h_c, lm_head, tg, n, real)
            lab = labels[:, c0 + 1:c1 + 1]
            valid = lab != ctx.ignore_index
            safe = torch.where(valid, lab, 0).long()
            g = ce_local_grad(logits, safe, v0, lse[:, c0:c1])
            g = (g * (valid[..., None] * g_total)).to(hidden.dtype)
            g = tp.all_gather(g, g.dim() - 1, tg.size, tg.group)[..., :V]
            if d_hidden is not None:
                d_hidden[:, c0:c1] = matmul_f32(g, lm_head.t()).to(
                    hidden.dtype)
            if d_head is not None:
                d_head += matmul_f32(h_c.reshape(-1, D).t(),
                                     g.reshape(-1, V))
        if d_head is not None:
            d_head = d_head.to(lm_head.dtype)
        return d_hidden, d_head, None, None, None, None


def causal_lm_loss_from_hidden(params, hidden: torch.Tensor,
                               labels: torch.Tensor, ignore_index: int = -100,
                               chunk: int = 1024, mesh=None) -> torch.Tensor:
    """Sequence-chunked shifted cross entropy: the same value as
    logits_from_hidden + causal_lm_loss, but the fp32 [S, V] logits never
    exist whole (at S = 7.5k and V = 32k they would be 0.93 GB, twice over
    in the backward); each chunk's are recomputed in the backward.

    mesh: this rank holds only its batch rows. The count of valid targets
    is summed over the batch ranks (data x fsdp) and this rank's total is
    divided by that global count, so the ranks' losses sum to the loss of
    the whole batch and their summed gradients are its gradient (the
    train step sums both). An lm_head whose hidden dim 'tensor' splits
    takes the vocabulary-parallel route (_VocabParallelCE)."""
    lm_head = params["lm_head"]
    tg = tensor_group(lm_head)
    if tg is None:
        total, count = _ChunkedCE.apply(hidden, gather(lm_head), labels,
                                        ignore_index, chunk)
    else:
        total, count = _VocabParallelCE.apply(
            tp.split_last(hidden, tg), gather(lm_head), labels, ignore_index,
            chunk, tg)
    if mesh is not None:
        count = count.clone()
        dist.all_reduce(count, group=mesh.batch_group)
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


def _query_rows(q: torch.Tensor, Hkv: int) -> torch.Tensor:
    """q [B, S, H, Dh] → [B, Hkv, G·S, Dh]: each kv head's G·S query rows
    (head h = kv head · G + g, the JAX package's grouping)."""
    B, S, H, Dh = q.shape
    G = H // Hkv
    return q.reshape(B, S, Hkv, G, Dh).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, G * S, Dh)


def _from_query_rows(o: torch.Tensor, S: int) -> torch.Tensor:
    """_query_rows' inverse: [B, Hkv, G·S, Dh] → [B, S, H, Dh]."""
    B, Hkv, GS, Dh = o.shape
    G = GS // S
    return o.reshape(B, Hkv, G, S, Dh).permute(0, 3, 1, 2, 4).reshape(
        B, S, Hkv * G, Dh)


def _scores_f32(qh: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """qh [B, Hkv, M, Dh] times k [Bk, Hkv, Sk, Dh] transposed, Bk 1 or B →
    fp32 [B, Hkv, M, Sk]. A batch-1 k is shared by every row: each kv head
    runs one product over all B·M query rows, so k is read once and never
    broadcast B times."""
    B, Hkv, M, Dh = qh.shape
    if k.shape[0] == 1 and B > 1:
        s = matmul_f32(qh.transpose(0, 1).reshape(Hkv, B * M, Dh),
                       k[0].transpose(1, 2))
        return s.reshape(Hkv, B, M, -1).transpose(0, 1)
    return matmul_f32(qh, k.transpose(2, 3))


def _pv_f32(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [B, Hkv, M, Sk] (in v's dtype) times v [Bv, Hkv, Sk, Dh], Bv 1 or B
    → fp32 [B, Hkv, M, Dh]; a batch-1 v as in _scores_f32."""
    B, Hkv, M, Sk = p.shape
    if v.shape[0] == 1 and B > 1:
        o = matmul_f32(p.transpose(0, 1).reshape(Hkv, B * M, Sk), v[0])
        return o.reshape(Hkv, B, M, -1).transpose(0, 1)
    return matmul_f32(p, v)


def _rect_attention(q, pk, pv, k_c, v_c, keep, scale: float) -> torch.Tensor:
    """prefill_continue's attention: the chunk's queries q [B, Sq, H, Dh]
    over [prefix ; chunk]. pk/pv [Bp, Sp, Hkv, Dh] (Bp 1 or B) stay at
    their batch; k_c/v_c [B, Sq, Hkv, Dh]; keep [B, Sq, Sp + Sq]. fp32
    scores and one fp32 softmax over the whole row, as the JAX package's
    plain XLA version."""
    B, Sq, H, Dh = q.shape
    Sp, Hkv = pk.shape[1], pk.shape[2]
    G = H // Hkv
    qh = _query_rows(q, Hkv)
    s = torch.cat([_scores_f32(qh, pk.transpose(1, 2)),
                   _scores_f32(qh, k_c.transpose(1, 2))], dim=-1) * scale
    s = torch.where(keep[:, None, None], s.reshape(B, Hkv, G, Sq, Sp + Sq),
                    NEG_INF)
    p = torch.softmax(s, dim=-1).reshape(B, Hkv, G * Sq, Sp + Sq)
    out = (_pv_f32(p[..., :Sp].to(pv.dtype), pv.transpose(1, 2))
           + _pv_f32(p[..., Sp:].to(v_c.dtype), v_c.transpose(1, 2)))
    return _from_query_rows(out, Sq).to(q.dtype)


def quantize_kv_head_major(kv: torch.Tensor, pad_to: int):
    """A K or V stack [L, B, S, Hkv, Dh] → the int8 caches' layout: values
    [L, B, Hkv, pad_to, Dh] int8 and scales [L, B, Hkv, pad_to] fp32, one
    per (slot, kv head); slots past S hold 0 with scale 1."""
    L, B, S, Hkv, Dh = kv.shape
    q8, sc = quantize_kv(kv)
    vals = torch.zeros(L, B, Hkv, pad_to, Dh, dtype=torch.int8,
                       device=kv.device)
    scales = torch.ones(L, B, Hkv, pad_to, dtype=torch.float32,
                        device=kv.device)
    vals[:, :, :, :S] = q8.transpose(2, 3)
    scales[..., :S] = sc.transpose(2, 3)
    return vals, scales


class SharedPrefixCache(NamedTuple):
    """The cascade decode cache of prefix-KV serving: the per-video prefix
    stored once at batch 1 (int8, quantized once), and a per-row int8 tail
    (question chunk, then generated tokens). A decode step streams the
    prefix once for the whole batch."""
    pk: torch.Tensor           # [L, 1, Hkv, Sp, Dh] int8
    pk_scale: torch.Tensor     # [L, 1, Hkv, Sp] fp32
    pv: torch.Tensor
    pv_scale: torch.Tensor
    prefix_mask: torch.Tensor  # [1, Sp] valid prefix slots
    tail: QuantKVCache         # [L, B, Hkv, Mt, Dh]


def prefill_continue(params, cfg: LLMConfig, chunk_embeds: torch.Tensor,
                     chunk_mask: torch.Tensor, prefix_k: torch.Tensor,
                     prefix_v: torch.Tensor, prefix_mask: torch.Tensor,
                     max_len: int, quantize_cache: bool = True,
                     tail_len: Optional[int] = None):
    """Prefill a left-padded question chunk [B, Sq, D] (chunk_mask [B, Sq])
    against a bf16 prefix K/V [L, Bp, Sp, Hkv, Dh] (Bp 1 or B, prefix_mask
    [Bp, Sp]) from serve/generate.build_prefix_kv → (last-position logits
    [B, V] fp32, cache, valid mask, next positions [B]).

    The chunk attends the prefix in bf16, as a full prefill does; the cache
    quantizes the same bf16 prefix values a full prefill would. max_len is
    the LongRoPE hint and the capacity of the cache returned: a bf16
    KVCache, a QuantKVCache (quantize_cache; the prefix quantized once and
    broadcast to B), valid mask [B, max_len]; or, with tail_len, a
    SharedPrefixCache whose tail holds the chunk at slots [0, Sq) of
    tail_len, valid mask [B, tail_len] over the tail (requires
    quantize_cache and Bp = 1). Under a 'tensor' split the prefix and the
    caches hold the rank's kv heads."""
    tg, cfg = _rank_view(params, cfg)
    B, Sq, _ = chunk_embeds.shape
    L, Bp, Sp, Hkv, Dh = prefix_k.shape
    dev = chunk_embeds.device
    if tail_len is not None and (not quantize_cache or Bp != 1):
        raise NotImplementedError("shared-prefix caches require "
                                  "quantize_cache=True and a batch-1 prefix")
    if tail_len is None and max_len < Sp + Sq:
        raise ValueError(f"max_len {max_len} cannot hold the prefix ({Sp}) "
                         f"and the chunk ({Sq})")
    pm = prefix_mask.bool().expand(B, Sp)
    cmask = chunk_mask.bool()
    plen = pm.sum(dim=-1)
    positions = plen[:, None] + (torch.cumsum(chunk_mask.long(), dim=-1)
                                 - 1).clamp_min(0)                  # [B, Sq]
    cos, sin = llm_rope_tables(cfg, positions, seq_len_hint=max_len)
    # keep [B, Sq, Sp + Sq]: prefix slots by their validity, chunk slots
    # causal and valid; a window compares token positions, not slots
    causal = torch.ones(Sq, Sq, dtype=torch.bool, device=dev).tril()
    keep = torch.cat([pm[:, None, :].expand(B, Sq, Sp),
                      causal[None] & cmask[:, None, :]], dim=-1)
    if cfg.sliding_window is not None:
        kpos = torch.cat([torch.cumsum(pm.long(), dim=-1) - 1, positions],
                         dim=-1)
        keep = keep & (positions[:, :, None] - kpos[:, None, :]
                       < cfg.sliding_window)

    lay = params["layers"]
    x = chunk_embeds
    new_ks, new_vs = [], []
    for i in range(L):
        lp = layer_slice(lay, i)
        h = rms_norm(x, lp["input_norm_w"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, tg=tg)
        q, k = apply_rope(q, k, cos, sin)
        attn = _rect_attention(q, prefix_k[i].to(k.dtype),
                               prefix_v[i].to(v.dtype), k, v, keep,
                               cfg.head_dim ** -0.5)
        x = x + _dense(attn.reshape(B, Sq, cfg.q_dim), lp["o_kernel"], lp,
                       "o", tg=tg)
        h = rms_norm(x, lp["post_norm_w"], cfg.rms_eps)
        x = x + _mlp(h, lp, cfg, tg=tg)
        new_ks.append(k)
        new_vs.append(v)
    new_ks, new_vs = torch.stack(new_ks), torch.stack(new_vs)
    x = rms_norm(x[:, -1:], params["final_norm_w"], cfg.rms_eps)
    logits = logits_from_hidden(params, x)[:, 0]
    pos_next = (plen + chunk_mask.sum(dim=-1)).to(torch.int32)

    if tail_len is not None:
        pk, pks = quantize_kv_head_major(prefix_k, Sp)
        pv, pvs = quantize_kv_head_major(prefix_v, Sp)
        tk, tks = quantize_kv_head_major(new_ks, tail_len)
        tv, tvs = quantize_kv_head_major(new_vs, tail_len)
        tail = QuantKVCache(tk, tks, tv, tvs,
                            torch.full((B,), Sq, dtype=torch.int32,
                                       device=dev))
        tail_valid = torch.zeros(B, tail_len, dtype=torch.bool, device=dev)
        tail_valid[:, :Sq] = cmask
        return (logits, SharedPrefixCache(pk, pks, pv, pvs,
                                          prefix_mask.to(torch.int32,
                                                         copy=True), tail),
                tail_valid, pos_next)

    valid = torch.zeros(B, max_len, dtype=torch.bool, device=dev)
    valid[:, :Sp] = pm
    valid[:, Sp:Sp + Sq] = cmask
    length = torch.full((B,), Sp + Sq, dtype=torch.int32, device=dev)
    if quantize_cache:
        cache = QuantKVCache.create(cfg, B, max_len, device=dev)
        for vals, scales, pref, chunk in (
                (cache.k, cache.k_scale, prefix_k, new_ks),
                (cache.v, cache.v_scale, prefix_v, new_vs)):
            # the prefix quantized once at Bp, then broadcast into B rows
            pq, ps = quantize_kv_head_major(pref, Sp)
            cq, cs = quantize_kv_head_major(chunk, Sq)
            vals[:, :, :, :Sp] = pq
            scales[..., :Sp] = ps
            vals[:, :, :, Sp:Sp + Sq] = cq
            scales[..., Sp:Sp + Sq] = cs
        return logits, cache._replace(length=length), valid, pos_next
    cache = KVCache.create(cfg, B, max_len, dtype=chunk_embeds.dtype,
                           device=dev)
    for buf, pref, chunk in ((cache.k, prefix_k, new_ks),
                             (cache.v, prefix_v, new_vs)):
        buf[:, :, :Sp] = pref
        buf[:, :, Sp:Sp + Sq] = chunk
    return logits, cache._replace(length=length), valid, pos_next


def decode_step(params, cfg: LLMConfig, token_embeds: torch.Tensor,
                cache, valid_mask: torch.Tensor, positions: torch.Tensor,
                active: Optional[torch.Tensor] = None):
    """One decode step → (logits [B, V] fp32, cache, valid_mask with the new
    slot set). token_embeds [B, 1, D]; cache a KVCache or QuantKVCache;
    valid_mask [B, max_len] attendable slots; positions [B] of the new
    token. The caller's cache buffers are updated in place; the returned
    cache shares them.

    active [B] bool (continuous-pool rows still generating; QuantKVCache
    only): an inactive row's k/v are written at its clamped slot as any
    row's, but its length does not advance and no valid slot is set, so the
    next step writes the same slot again. None: every row active.

    Under a 'tensor' split the cache holds the rank's kv heads."""
    tg, cfg = _rank_view(params, cfg)
    quant = isinstance(cache, QuantKVCache)
    if active is not None and not quant:
        # the bf16 write below is one shared slot for every row (uniform
        # lengths, batch serving); ragged per-row slots would corrupt rows
        raise NotImplementedError(
            "decode_step(active=...) (continuous batching) requires a "
            "QuantKVCache; the bf16 KVCache path writes one shared slot")
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
        q, k, v = _qkv(h, lp, cfg, w8a8_decode=quant, tg=tg)
        q, k = apply_rope(q, k, cos, sin)
        if quant:
            attn = decode_attention_int8(
                q, cache.k[i], cache.k_scale[i], cache.v[i], cache.v_scale[i],
                attn_valid, k, v, scale=cfg.head_dim ** -0.5)
        else:
            attn = decode_attention(q, cache.k[i], cache.v[i], attn_valid,
                                    k_new=k, v_new=v)
        x = x + _dense(attn.reshape(B, 1, cfg.q_dim), lp["o_kernel"], lp,
                       "o", w8a8_decode=quant, tg=tg)
        h = rms_norm(x, lp["post_norm_w"], cfg.rms_eps)
        x = x + _mlp(h, lp, cfg, w8a8_decode=quant, tg=tg)
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
    new_cache = cache._replace(length=cache.length + _advance(active))
    slot = (torch.arange(max_len, device=valid_mask.device)[None, :]
            == write_idx[:, None])
    if active is not None:
        slot = slot & active[:, None]
    valid_mask = valid_mask.bool() | slot
    x = rms_norm(x, params["final_norm_w"], cfg.rms_eps)
    logits = logits_from_hidden(params, x)[:, 0]
    return logits, new_cache, valid_mask


def _advance(active: Optional[torch.Tensor]):
    """What a decode step adds to each row's length: 1, or 1 on the active
    rows of a continuous pool and 0 on the others."""
    return 1 if active is None else active.to(torch.int32)


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
    QuantKVCache; S <= 128. Under a 'tensor' split the cache holds the
    rank's kv heads."""
    tg, cfg = _rank_view(params, cfg)
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
        q, k, v = _qkv(h, lp, cfg, w8a8_decode=True, tg=tg)
        q, k = apply_rope(q, k, cos, sin)
        attn = verify_attention_int8(
            q, cache.k[i], cache.k_scale[i], cache.v[i], cache.v_scale[i],
            attn_valid, k, v, scale=cfg.head_dim ** -0.5)
        x = x + _dense(attn.reshape(B, S, cfg.q_dim), lp["o_kernel"], lp,
                       "o", w8a8_decode=True, tg=tg)
        h = rms_norm(x, lp["post_norm_w"], cfg.rms_eps)
        x = x + _mlp(h, lp, cfg, w8a8_decode=True, tg=tg)
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


def _dequant(q8: torch.Tensor, scale: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """int8 [..., S, Dh] times fp32 scales [..., S] → dtype, the JAX
    package's _dequant_hd in the port's layout. XLA fuses it into the
    product that reads it; eager torch writes the dequantized copy."""
    return (q8 * scale[..., None]).to(dtype)


def _cascade_attention(q, k_new, v_new, keep_new, prefix, keep_p, tail,
                       keep_t, scale: float) -> torch.Tensor:
    """S queries q [B, S, H, Dh] over [shared prefix ; per-row tail ; the S
    in-pass tokens' own k/v (k_new, v_new [B, S, Hkv, Dh])], one fp32
    softmax across the three segments: decode_step_shared (S = 1) and
    verify_step_shared (S candidates, causal among themselves). prefix
    (k8, k_scale, v8, v_scale) [1, Hkv, Sp, Dh] / [1, Hkv, Sp], read once
    for the whole batch; tail the same at batch B over Mt slots; keep_p
    [B or 1, S or 1, Sp], keep_t [B, S or 1, Mt], keep_new [S, S]."""
    B, S, H, Dh = q.shape
    dt = q.dtype
    pk, pks, pv, pvs = prefix
    tk, tks, tv, tvs = tail
    Hkv, Sp, Mt = tk.shape[1], pk.shape[2], tk.shape[2]
    G = H // Hkv
    qh = _query_rows(q, Hkv)
    s = torch.cat([_scores_f32(qh, _dequant(pk, pks, dt)),
                   _scores_f32(qh, _dequant(tk, tks, dt)),
                   _scores_f32(qh, k_new.transpose(1, 2))], dim=-1) * scale
    keep = torch.cat([keep_p.expand(B, S, Sp), keep_t.expand(B, S, Mt),
                      keep_new.expand(B, S, S)], dim=-1)
    s = torch.where(keep[:, None, None], s.reshape(B, Hkv, G, S, -1), NEG_INF)
    p = torch.softmax(s, dim=-1).reshape(B, Hkv, G * S, -1).to(dt)
    out = (_pv_f32(p[..., :Sp], _dequant(pv, pvs, dt))
           + _pv_f32(p[..., Sp:Sp + Mt], _dequant(tv, tvs, dt))
           + _pv_f32(p[..., Sp + Mt:], v_new.transpose(1, 2)))
    return _from_query_rows(out, S).to(dt)


def _shared_keep(cfg: LLMConfig, prefix_mask: torch.Tensor,
                 tail_valid: torch.Tensor, positions: torch.Tensor):
    """Attendable prefix and tail slots for queries at positions [B, S] →
    keep_p [1 or B, 1 or S, Sp], keep_t [B, 1 or S, Mt]. A sliding window
    compares token positions: a prefix slot's is its valid rank, a tail
    slot's the prefix length plus its valid rank."""
    pm = prefix_mask.bool()                                  # [1, Sp]
    tv = tail_valid.bool()                                   # [B, Mt]
    keep_p, keep_t = pm[:, None, :], tv[:, None, :]
    if cfg.sliding_window is not None:
        pkpos = torch.cumsum(pm.long(), dim=-1) - 1
        tkpos = pm.sum(dim=-1)[:, None] + torch.cumsum(tv.long(), dim=-1) - 1
        keep_p = keep_p & (positions[:, :, None] - pkpos[:, None, :]
                           < cfg.sliding_window)
        keep_t = keep_t & (positions[:, :, None] - tkpos[:, None, :]
                           < cfg.sliding_window)
    return keep_p, keep_t


def _shared_layers(params, cfg: LLMConfig, x: torch.Tensor,
                   cache: SharedPrefixCache, keep_p, keep_t, keep_new, cos,
                   sin):
    """The decoder layers of a cascade step on x [B, S, D] → (hidden after
    the final norm, the S tokens' k and v [L, B, S, Hkv, Dh]). Projections
    of an int8 tree run K3, w8a8 under the marker; under a 'tensor' split
    the rank's heads."""
    tg, cfg = _rank_view(params, cfg)
    B, S, _ = x.shape
    lay, tail = params["layers"], cache.tail
    new_ks, new_vs = [], []
    for i in range(lay["input_norm_w"].shape[0]):
        lp = layer_slice(lay, i)
        h = rms_norm(x, lp["input_norm_w"], cfg.rms_eps)
        q, k, v = _qkv(h, lp, cfg, w8a8_decode=True, tg=tg)
        q, k = apply_rope(q, k, cos, sin)
        attn = _cascade_attention(
            q, k, v, keep_new,
            (cache.pk[i], cache.pk_scale[i], cache.pv[i], cache.pv_scale[i]),
            keep_p, (tail.k[i], tail.k_scale[i], tail.v[i], tail.v_scale[i]),
            keep_t, cfg.head_dim ** -0.5)
        x = x + _dense(attn.reshape(B, S, cfg.q_dim), lp["o_kernel"], lp,
                       "o", w8a8_decode=True, tg=tg)
        h = rms_norm(x, lp["post_norm_w"], cfg.rms_eps)
        x = x + _mlp(h, lp, cfg, w8a8_decode=True, tg=tg)
        new_ks.append(k)
        new_vs.append(v)
    return (rms_norm(x, params["final_norm_w"], cfg.rms_eps),
            torch.stack(new_ks), torch.stack(new_vs))


def decode_step_shared(params, cfg: LLMConfig, token_embeds: torch.Tensor,
                       cache: SharedPrefixCache, tail_valid: torch.Tensor,
                       positions: torch.Tensor,
                       rope_hint: Optional[int] = None,
                       active: Optional[torch.Tensor] = None):
    """decode_step over a SharedPrefixCache → (logits [B, V] fp32, cache,
    tail_valid with the new slot set). The new token's k/v go to the tail
    at each row's own slot, one K5 launch for values and scales; the prefix
    is read once per layer for the whole batch. token_embeds [B, 1, D];
    tail_valid [B, Mt]; positions [B]; rope_hint: the LongRoPE hint of the
    equivalent single cache (default Sp + Mt). The tail's buffers are
    updated in place. active [B]: decode_step's, on the tail."""
    tail = cache.tail
    Sp, Mt = cache.pk.shape[3], tail.max_len
    cos, sin = llm_rope_tables(
        cfg, positions[:, None],
        seq_len_hint=rope_hint if rope_hint is not None else Sp + Mt)
    write_idx = tail.length.clamp_max(Mt - 1)
    keep_p, keep_t = _shared_keep(cfg, cache.prefix_mask, tail_valid,
                                  positions[:, None])
    keep_new = torch.ones(1, 1, dtype=torch.bool, device=positions.device)
    x, ks, vs = _shared_layers(params, cfg, token_embeds, cache, keep_p,
                               keep_t, keep_new, cos, sin)
    kq, ksc = quantize_kv(ks[:, :, 0])                   # [L, B, Hkv, Dh]
    vq, vsc = quantize_kv(vs[:, :, 0])
    scatter_write([tail.k, tail.k_scale, tail.v, tail.v_scale],
                  [kq, ksc, vq, vsc], write_idx)
    slot = (torch.arange(Mt, device=tail_valid.device)[None, :]
            == write_idx[:, None])
    if active is not None:
        slot = slot & active[:, None]
    logits = logits_from_hidden(params, x)[:, 0]
    tail = tail._replace(length=tail.length + _advance(active))
    return logits, cache._replace(tail=tail), tail_valid.bool() | slot


def verify_step_shared(params, cfg: LLMConfig, token_embeds: torch.Tensor,
                       cache: SharedPrefixCache, tail_valid: torch.Tensor,
                       positions: torch.Tensor,
                       rope_hint: Optional[int] = None):
    """verify_step over a SharedPrefixCache → (logits [B, S, V] fp32,
    cache): S candidates score over the cascade with a causal S×S block;
    their k/v go to tail slots base..base+S-1, base = min(tail length,
    Mt - S), one K9 launch; the tail's length and tail_valid do not move
    (commit_verify on the tail does that). positions [B, S]."""
    B, S = token_embeds.shape[:2]
    tail = cache.tail
    Sp, Mt = cache.pk.shape[3], tail.max_len
    cos, sin = llm_rope_tables(
        cfg, positions,
        seq_len_hint=rope_hint if rope_hint is not None else Sp + Mt)
    base = tail.length.clamp_max(Mt - S)
    keep_p, keep_t = _shared_keep(cfg, cache.prefix_mask, tail_valid,
                                  positions)
    causal = torch.ones(S, S, dtype=torch.bool,
                        device=positions.device).tril()
    x, ks, vs = _shared_layers(params, cfg, token_embeds, cache, keep_p,
                               keep_t, causal, cos, sin)
    kq, ksc = quantize_kv(ks)                            # [L, B, S, Hkv, Dh]
    vq, vsc = quantize_kv(vs)
    scatter_write_multi([tail.k, tail.k_scale, tail.v, tail.v_scale],
                        [kq, ksc, vq, vsc], base)
    return logits_from_hidden(params, x), cache
