"""Weight bridge from the JAX package: its ``vlm.init_params`` pytree,
converted to numpy arrays, becomes this package's parameter tree, so both
packages compute the same function in the parity tests.

The two trees share names, nesting and layouts ([D_in, D_out] kernels, HWIO
patch kernels, stacked layers). The bridge builds the expected tree on the
meta device (shapes only, no memory), fills every leaf from the numpy tree
by its path, and fails loudly on a missing, extra, reused or misshapen
tensor.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.config import VLMConfig
from . import vlm


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def params_from_jax(np_tree, cfg: VLMConfig, device,
                    dtype=torch.float32) -> dict:
    """np_tree: the JAX ``vlm.init_params`` pytree with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) → this package's params
    on ``device`` in ``dtype``. Every leaf is used exactly once."""
    expected = vlm.init_params(cfg, generator=None, device="meta",
                               dtype=dtype)
    want = _flatten(expected)
    have = _flatten(np_tree)
    missing = sorted(set(want) - set(have))
    extra = sorted(set(have) - set(want))
    if missing or extra:
        raise ValueError(f"params_from_jax: missing {missing}, "
                         f"unexpected {extra}")
    used = 0
    for path, meta in want.items():
        arr = np.asarray(have[path])
        if tuple(arr.shape) != tuple(meta.shape):
            raise ValueError(f"params_from_jax: {'/'.join(path)} has shape "
                             f"{arr.shape}, expected {tuple(meta.shape)}")
        _set(expected, path, torch.from_numpy(
            np.array(arr, dtype=np.float32)).to(device=device, dtype=dtype))
        used += 1
    if used != len(have) or used != len(want):
        raise ValueError(f"params_from_jax: used {used} of {len(have)} JAX "
                         f"leaves for {len(want)} parameters")
    return expected
