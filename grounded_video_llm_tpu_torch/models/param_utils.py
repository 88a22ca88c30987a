"""Parameter helpers shared by the models: seeded random initializers with
the JAX package's schemes (jax.nn.initializers.normal, truncated_normal and
lecun_normal) drawn from an explicit torch.Generator, and per-layer slicing
of stacked parameter trees (dense tensors, ``Int8Weight``s and the
sharded leaves of parallel/partitioning.shard_params, gathered over fsdp one
layer at a time).

Samples are drawn in fp32 one leading-axis slice at a time and cast into a
tensor of the target dtype, so a stacked [L, ...] weight never exists twice
in fp32 on the device.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..ops.int8_matmul import Int8Weight
from ..parallel.partitioning import gather_layer, is_sharded

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


def normal_slices(shape, stddev: float, *, generator, device):
    """The fp32 draws ``normal`` rounds into its dtype, in order: one per
    leading slice of a shape of 3 or more dimensions, one whole draw of a
    smaller one (serve/quantize.py quantizes them as they come)."""
    shape = tuple(shape)
    n, part = (shape[0], shape[1:]) if len(shape) >= 3 else (1, shape)
    for _ in range(n):
        yield torch.empty(part, dtype=torch.float32, device=device).normal_(
            0.0, stddev, generator=generator)


def normal(shape, stddev: float, *, generator, device, dtype):
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    rows = out.view(1, *out.shape) if out.dim() < 3 else out
    for sl, draw in zip(rows, normal_slices(shape, stddev,
                                            generator=generator,
                                            device=device)):
        sl.copy_(draw)
    return out


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


def child_generator(generator, device):
    """A new generator on ``device`` seeded by one draw from ``generator``
    (None for None): each piece of a tree draws from its own, so skipping
    one leaves the others' values as they were."""
    if generator is None:
        return None
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    child = torch.Generator(device=device)
    child.manual_seed(seed)
    return child


def layer_slice(tree, i: int):
    """Layer i of a tree of stacked [L, ...] tensors or int8 weights, as
    views; a sharded leaf's layer i gathered over fsdp (only its shards
    move): whole, or this rank's tensor shard of a leaf that 'tensor'
    splits, which the layers compute with (parallel/tensor.py)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, Int8Weight):
        return tree.layer(i)
    if is_sharded(tree):
        return gather_layer(tree, i)
    return tree[i]
