"""Checkpoint store: the port's own train-state files and the reference's
.pth interop (port of grounded_video_llm_tpu/core/checkpoint.py).

Two formats:
  * native — a nested dict of tensors (train state + resume bundles) in one
    torch.save file, copied back into the live tensors of a template of the
    same paths and shapes (the JAX package keeps orbax checkpoints here);
  * interop — the reference's split-by-module layout
    ({stage}_{model}_{llm}_{dataset}.pth holding {"model": {module:
    state_dict}}, reference fsdp.py:116-127) for weight exchange with the
    original codebase and with the JAX package, read with
    torch.load(map_location="cpu", weights_only=True).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from ..train.optimizer import tree_items


def save_pytree(path: str, tree: Any) -> None:
    torch.save(tree, os.path.abspath(path))


@torch.no_grad()
def load_pytree(path: str, template: Any, map_location="cpu") -> Any:
    """Read a save_pytree file into a template (a nested dict of the same
    paths): every tensor leaf of the file is copied into the template's
    tensor of that path (shapes must match). Returns the file's tree, from
    which the caller reads the non-tensor leaves."""
    saved = torch.load(os.path.abspath(path), map_location=map_location,
                       weights_only=True)
    have = dict(tree_items(template))
    got = dict(tree_items(saved))
    if set(have) != set(got):
        raise ValueError(f"load_pytree: paths differ from the template: "
                         f"{sorted(set(have) ^ set(got))}")
    for p, t in have.items():
        if isinstance(t, torch.Tensor):
            t.copy_(got[p])
    return saved


def save_json(path: str, obj: Dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Reference-format interop (torch .pth)
# ---------------------------------------------------------------------------

#: module-key names used by the reference's split checkpoints
#: (reference llava_next_video.py:153 all_module_keys)
REF_MODULE_KEYS = ("vision_tower", "language_model", "video_encoder",
                   "multi_modal_projector", "video_projecter")


def export_reference_pth(path: str,
                         module_dicts: Dict[str, Dict[str, np.ndarray]]):
    """Write {"model": {module: {param_name: tensor}}} the way the reference
    saves (fsdp.py:122-127). module_dicts values are flat name → numpy
    arrays in the reference's torch naming; each is written from its own
    copy, so a view never carries its base array into the file."""
    payload = {"model": {
        k: {name: torch.from_numpy(np.array(v, copy=True))
            for name, v in d.items()}
        for k, d in module_dicts.items()}}
    torch.save(payload, path)


def import_reference_pth(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a reference checkpoint into {module: {name: float32 numpy}}."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model = payload.get("model", payload)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for k, d in model.items():
        if isinstance(d, dict):
            out[k] = {name: t.to(torch.float32).numpy()
                      for name, t in d.items()}
    return out
