"""Normalization ops with fp32 accumulation islands (port of
grounded_video_llm_tpu/ops/normalization.py).

RMSNorm computes its variance in fp32 then casts back; LayerScale multiplies
in fp32; LayerNorm accumulates in fp32 and casts the affine result.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * (var + eps) ** -0.5).to(dtype)
    return weight.to(dtype) * normed


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    normed = (xf - mean) * (var + eps) ** -0.5
    return (normed * weight.float() + bias.float()).to(dtype)


def layer_scale(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """LayerScale with a forced-fp32 multiply."""
    return (x.float() * gamma.float()).to(x.dtype)
