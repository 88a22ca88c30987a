"""Attention: plain PyTorch versions and the dispatch to the flash kernel
(port of grounded_video_llm_tpu/ops/attention.py).

Layout everywhere: [B, S, H, D]; GQA by head-group einsum, no materialized
K/V head repeat. ``mha`` sends a [B, Sk] or absent mask to
``flash_attention.flash_mha`` on every device: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors. There is no fallback: on CUDA it
is the kernel or an error.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.dtypes import matmul_f32
from .flash_attention import NEG_INF, flash_mha


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = False, mask: Optional[torch.Tensor] = None,
        scale: Optional[float] = None, bounded_softmax: bool = False,
        sliding_window: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention with fp32 softmax → [B, Sq, H, D].

    mask: [B, Sk] keep-mask, or [B, 1, Sq, Sk] keep-mask (CPU only: the
    kernel takes key masks). bounded_softmax: the kernel's fixed-offset
    softmax for known-bounded (QK-normed) scores."""
    if mask is None or mask.dim() == 2:
        return flash_mha(q, k, v, causal=causal, mask=mask, scale=scale,
                         bounded_softmax=bounded_softmax,
                         sliding_window=sliding_window)
    if q.device.type != "cpu":
        raise NotImplementedError(
            "mha: the flash kernel takes [B, Sk] masks only; no kernel for "
            f"a {mask.dim()}-d mask")
    return xla_mha(q, k, v, causal=causal, mask=mask, scale=scale,
                   sliding_window=sliding_window)


def xla_mha(q, k, v, *, causal=False, mask=None, scale=None,
            sliding_window=None):
    """The JAX package's reference attention, in plain PyTorch."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if scale is None:
        scale = D ** -0.5
    groups = H // Hkv
    qg = q.reshape(B, Sq, Hkv, groups, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk, device=q.device)[None, :]
        keep = kpos <= qpos
        if sliding_window is not None:
            keep = keep & (qpos - kpos < sliding_window)
        scores = torch.where(keep, scores, NEG_INF)
    if mask is not None:
        if mask.dim() == 2:
            keep = mask[:, None, None, None, :].bool()
        else:
            keep = mask[:, :, None].bool()
        scores = torch.where(keep, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor,        # [B, 1, H, D]
                     k_cache: torch.Tensor,  # [B, L, Hkv, D]
                     v_cache: torch.Tensor,  # [B, L, Hkv, D]
                     valid_mask: torch.Tensor,  # [B, L] attendable slots
                     *, k_new: Optional[torch.Tensor] = None,  # [B,1,Hkv,D]
                     v_new: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention over a fixed-size cache with a slot-validity
    mask. k_new/v_new: the current token's k/v as one extra slot, so the
    caller can write the cache once after the layer loop."""
    B, L, Hkv, D = k_cache.shape
    H = q.shape[2]
    if scale is None:
        scale = D ** -0.5
    groups = H // Hkv
    # Both products read the cache in its stored dtype and give fp32 (the
    # softmax island), as preferred_element_type=float32 does in JAX.
    # The permutes are views; at B=1 so is matmul_f32's batch flattening.
    qg = q.reshape(B, Hkv, groups, D)
    scores = matmul_f32(qg, k_cache.permute(0, 2, 3, 1)) * scale
    scores = torch.where(valid_mask[:, None, None, :].bool(), scores,
                         NEG_INF)
    if k_new is not None:
        s_new = matmul_f32(qg, k_new.permute(0, 2, 3, 1)) * scale
        scores = torch.cat([scores, s_new], dim=-1)     # [B, Hkv, g, L+1]
    probs = torch.softmax(scores, dim=-1)
    if k_new is not None:
        p_cache, p_new = probs[..., :L], probs[..., L:]
        out = matmul_f32(p_cache.to(v_cache.dtype),
                         v_cache.permute(0, 2, 1, 3))
        out = out + matmul_f32(p_new.to(v_new.dtype),
                               v_new.permute(0, 2, 1, 3))
    else:
        out = matmul_f32(probs.to(v_cache.dtype), v_cache.permute(0, 2, 1, 3))
    return out.reshape(B, 1, H, D).to(q.dtype)
