"""Seeded random weights, made by the benchmark on the device.

The tree's layout (names and shapes) is the one the model's parameter
functions lay out (the JAX package's layout: stacked [L, ...] kernels,
[D_in, D_out]); its values are the benchmark's own. Each leaf is one draw,
made on the device in the dtype it is served in, from a generator seeded
by (seed, leaf index), so the same seed gives the same weights and a leaf
does not depend on the others. The configuration file's ``init`` rules
give each leaf its mean and spread: the first rule whose pattern matches
the leaf's path ("llm/layers/qkv_kernel") wins.
"""

from __future__ import annotations

import fnmatch
from typing import List

import numpy as np
import torch


def leaf_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([int(seed) & (2 ** 128 - 1), index])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


def rule_for(path: str, rules: List[list]):
    for pattern, kind, mean, std in rules:
        if fnmatch.fnmatchcase(path, pattern):
            return kind, float(mean), float(std)
    raise ValueError(f"no init rule matches {path}")


def fill(layout: dict, rules: List[list], seed: int, device,
         dtype: torch.dtype) -> dict:
    """A tree with layout's nesting and shapes (layout's leaves may be on
    the meta device), every leaf drawn anew."""
    index = iter(range(10 ** 9))

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                out[k] = walk(v, path)
                continue
            kind, mean, std = rule_for(path, rules)
            if kind != "normal":
                raise ValueError(f"unknown init kind {kind!r} for {path}")
            g = torch.Generator(device=device)
            g.manual_seed(leaf_seed(seed, next(index)))
            out[k] = torch.empty(tuple(v.shape), dtype=dtype,
                                 device=device).normal_(mean, std,
                                                        generator=g)
        return out

    return walk(layout, "")
