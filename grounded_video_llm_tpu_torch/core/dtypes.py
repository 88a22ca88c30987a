"""fp32 islands over operands kept in their stored dtype (the port's side of
grounded_video_llm_tpu/core/dtypes.py).

The JAX package realises its fp32 products (attention scores, P·V, logits)
as ``preferred_element_type=float32`` over bf16 operands. ``matmul_f32`` is
the same contract: casting the operands up instead would write an fp32 copy
of the lm_head (or of a layer's K/V cache) on every decode step.
"""

from __future__ import annotations

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b → fp32, accumulated in fp32. b is [K, N], or [..., K, N] with
    the same leading dims as a. On CUDA, bf16/fp16 operands go to cuBLAS
    as they are, with an fp32 output (``out_dtype``); on the CPU, which
    serves the fp32 tests, they are cast."""
    if a.device.type != "cuda" or a.dtype == b.dtype == torch.float32:
        return a.float() @ b.float()
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])
