"""Rotary position embeddings, fp32 tables, HF rotate-half convention (port of
grounded_video_llm_tpu/ops/rope.py).

Plain RoPE plus Phi-3's LongRoPE: per-dim frequency rescale factors (the
short table up to original_max_position_embeddings, the long table beyond)
and a global sqrt(1 + ln(scale)/ln(orig_max)) magnitude correction.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def rope_inv_freq(head_dim: int, theta: float,
                  factors: Optional[Tuple[float, ...]] = None,
                  device=None) -> torch.Tensor:
    """Computed on the host in float64 and rounded once to fp32, exactly as
    the JAX package does, so both packages share the same table bits."""
    exponent = np.arange(0, head_dim, 2, dtype=np.float64) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    if factors:
        inv_freq = inv_freq / np.asarray(factors, dtype=np.float64)
    return torch.from_numpy(inv_freq.astype(np.float32)).to(device)


# rope_inv_freq's tables, made once on each device and kept: a CUDA graph
# that reads one holds its address, and a capture cannot copy from pageable
# host memory
_INV_FREQ: dict = {}


def _inv_freq_on(head_dim: int, theta: float,
                 factors: Optional[Tuple[float, ...]],
                 device: torch.device) -> torch.Tensor:
    key = (head_dim, float(theta), tuple(factors) if factors else None,
           device)
    table = _INV_FREQ.get(key)
    if table is None:
        table = _INV_FREQ[key] = rope_inv_freq(head_dim, theta, factors,
                                               device)
    return table


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                factors: Optional[Tuple[float, ...]] = None,
                mscale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin fp32 tables for positions [..., S] → [..., S, head_dim]."""
    inv_freq = _inv_freq_on(head_dim, theta, factors, positions.device)
    freqs = positions[..., None].float() * inv_freq         # [..., S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)                 # [..., S, D]
    return torch.cos(emb) * mscale, torch.sin(emb) * mscale


def longrope_mscale(max_position_embeddings: int,
                    original_max_position_embeddings: int) -> float:
    scale = max_position_embeddings / original_max_position_embeddings
    if scale <= 1.0:
        return 1.0
    return math.sqrt(1.0 + math.log(scale)
                     / math.log(original_max_position_embeddings))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: [..., S, H, D]; cos/sin: [..., S, D] broadcast over heads. The
    rotation runs in fp32 and casts back at the end."""
    cos_b = cos[..., :, None, :]
    sin_b = sin[..., :, None, :]
    qf = q.float()
    kf = k.float()
    q_rot = qf * cos_b + rotate_half(qf) * sin_b
    k_rot = kf * cos_b + rotate_half(kf) * sin_b
    return q_rot.to(q.dtype), k_rot.to(k.dtype)


def llm_rope_tables(cfg, positions: torch.Tensor,
                    seq_len_hint: Optional[int] = None):
    """cos/sin for an LLMConfig. The LongRoPE factor set is chosen
    statically: long factors iff seq_len_hint (default: the positions'
    length) exceeds original_max_position_embeddings. Prefill passes the
    cache capacity and decode passes max_len, so cached keys and later
    queries always share one factor set."""
    factors = None
    mscale = 1.0
    if cfg.rope_scaling_short or cfg.rope_scaling_long:
        limit = (seq_len_hint if seq_len_hint is not None
                 else int(positions.shape[-1]))
        use_long = limit > cfg.original_max_position_embeddings
        factors = (cfg.rope_scaling_long if use_long
                   else cfg.rope_scaling_short)
        mscale = longrope_mscale(cfg.max_position_embeddings,
                                 cfg.original_max_position_embeddings)
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta, factors,
                       mscale)
