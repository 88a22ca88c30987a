"""Parameter helpers shared by the models: seeded random initializers with
the JAX package's schemes (jax.nn.initializers.normal, truncated_normal and
lecun_normal) drawn from an explicit torch.Generator, and per-layer slicing
of stacked parameter trees (dense tensors and ``Int8Weight``s).

Samples are drawn in fp32 one leading-axis slice at a time and cast into a
tensor of the target dtype, so a stacked [L, ...] weight never exists twice
in fp32 on the device.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..ops.int8_matmul import Int8Weight

# std of a unit normal truncated to [-2, 2]; JAX divides by it so the
# truncated draw keeps the requested stddev
_TRUNC_STD = 0.87962566103423978


def _sample(shape: Sequence[int], generator: torch.Generator, device,
            dtype, draw) -> torch.Tensor:
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    rows = out.view(1, *out.shape) if out.dim() < 3 else out
    for sl in rows:
        sl.copy_(draw(torch.empty(sl.shape, dtype=torch.float32,
                                  device=device)))
    return out


def normal(shape, stddev: float, *, generator, device, dtype):
    return _sample(shape, generator, device, dtype,
                   lambda t: t.normal_(0.0, stddev, generator=generator))


def truncated_normal(shape, stddev: float, *, generator, device, dtype):
    def draw(t):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return t.mul_(stddev / _TRUNC_STD)

    return _sample(shape, generator, device, dtype, draw)


def lecun_normal(shape, *, generator, device, dtype):
    """Truncated normal with variance 1/fan_in, fan_in = shape[-2]."""
    return truncated_normal(shape, math.sqrt(1.0 / shape[-2]),
                            generator=generator, device=device, dtype=dtype)


def layer_slice(tree, i: int):
    """Layer i of a tree of stacked [L, ...] tensors or int8 weights, as
    views."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, Int8Weight):
        return tree.layer(i)
    return tree[i]
