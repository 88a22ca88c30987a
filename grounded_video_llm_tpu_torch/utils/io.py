# The port's own copy of grounded_video_llm_tpu/utils/io.py, which imports no
# framework, except get_parameter_number, which counts the port's parameter
# tree; tests/test_torch_shared_modules.py holds the two to each other.
"""Small IO + introspection helpers (reference mm_utils/utils.py:256-293)."""

from __future__ import annotations

import json
import pickle
from typing import Any, Dict, Iterator, List

import numpy as np


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_json(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def load_jsonl(path: str) -> List[Any]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def save_jsonl(rows: List[Any], path: str) -> None:
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def load_pkl(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def load_csv(path: str) -> List[Dict]:
    import csv

    with open(path, newline="") as f:
        return [dict(row) for row in csv.DictReader(f)]


def _leaves(tree) -> Iterator[Any]:
    """The leaves of a nested dict / list / tuple, in order; an Int8Weight
    or Int8Embedding is one leaf per array field (q, scale, x_scale), as the
    JAX package's {"q", "scale"} dicts are."""
    from ..ops.int8_matmul import Int8Embedding, Int8Weight

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (Int8Weight, Int8Embedding)):
        for v in tree:
            if hasattr(v, "shape"):
                yield v
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _size(x) -> int:
    return int(np.prod(x.shape)) if hasattr(x, "shape") else 0


def _pairs(tree, mask) -> Iterator[Any]:
    """(array, flag) for every array leaf of tree, the flag read from the
    same place in mask; an Int8Weight's arrays share its one flag."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, mask[k])
    elif isinstance(tree, (list, tuple)) and not isinstance(mask, bool):
        for v, m in zip(tree, mask):
            yield from _pairs(v, m)
    else:
        for x in _leaves(tree):
            yield x, bool(mask)


def get_parameter_number(params, trainable_mask=None) -> Dict[str, int]:
    """Total / trainable parameter counts for a param tree (reference
    mm_utils/utils.py:288-291). trainable_mask: the same nesting with a bool
    at each leaf (train/optimizer.trainable_mask), else all counted
    trainable. An int8 weight counts its int8 values (the [D, O] view) and
    its scales."""
    total = sum(_size(x) for x in _leaves(params))
    if trainable_mask is None:
        trainable = total
    else:
        trainable = sum(_size(x) for x, m in _pairs(params, trainable_mask)
                        if m)
    return {"Total": total, "Trainable": trainable}
