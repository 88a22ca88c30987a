"""Checkpoint store: the port's own train-state files and the reference's
.pth interop (port of grounded_video_llm_tpu/core/checkpoint.py).

Two formats:
  * native — a nested dict of tensors (train state + resume bundles) in one
    torch.save file, copied back into the live tensors of a template of the
    same paths and shapes (the JAX package keeps orbax checkpoints here).
    In a process group of more than one rank the path is a directory and
    every rank writes its own file, rank{r}-of-{n}.pt: its view of the
    tree, each sharded leaf (parallel/partitioning) as its local shard
    (a fused leaf's tensor shard in its head-aligned order), each
    replicated leaf whole; it is read back by the same ranks on the same
    mesh. save_pytree_async snapshots the tree into host memory
    before it returns and writes it on a background thread;
  * interop — the reference's split-by-module layout
    ({stage}_{model}_{llm}_{dataset}.pth holding {"model": {module:
    state_dict}}, reference fsdp.py:116-127) for weight exchange with the
    original codebase and with the JAX package, read with
    torch.load(map_location="cpu", weights_only=True).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.partitioning import local
from ..train.optimizer import tree_items, tree_map


def _rank_file() -> Optional[str]:
    """This rank's file name inside a per-rank checkpoint directory, or
    None for a single process."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return f"rank{dist.get_rank()}-of-{dist.get_world_size()}.pt"
    return None


def _write(path: str, tree: Any) -> None:
    """torch.save through a temporary name, so the path never holds a
    partly written file."""
    name = _rank_file()
    if name is not None:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, name)
    torch.save(tree, path + ".tmp")
    os.replace(path + ".tmp", path)


def _local_view(tree: Any) -> Any:
    return tree_map(lambda _, x: local(x).detach()
                    if isinstance(x, torch.Tensor) else x, tree)


def save_pytree(path: str, tree: Any) -> None:
    _write(os.path.abspath(path), _local_view(tree))


# The background writer of save_pytree_async: at most one save in flight
# (a new one first waits for it, which also bounds the host memory to one
# snapshot), its error kept for the next save or wait_for_saves. The
# pinned host buffers are reused by the next save of the same leaves.
_ASYNC = {"thread": None, "error": None}
_PINNED: Dict[Tuple, torch.Tensor] = {}


def _wait() -> None:
    t = _ASYNC["thread"]
    if t is not None:
        t.join()
        _ASYNC["thread"] = None
    err, _ASYNC["error"] = _ASYNC["error"], None
    if err is not None:
        raise RuntimeError("an asynchronous checkpoint save failed") from err


def _host_snapshot(tree: Any) -> Any:
    """The tree's local view copied into host memory now: device tensors
    into pinned buffers (one synchronization for all of them), host
    tensors cloned."""
    on_device = []

    def copy(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        x = local(x).detach()
        if x.device.type == "cpu":
            return x.clone()
        key = (path, tuple(x.shape), x.dtype)
        buf = _PINNED.get(key)
        if buf is None:
            buf = _PINNED[key] = torch.empty(x.shape, dtype=x.dtype,
                                             pin_memory=True)
        buf.copy_(x, non_blocking=True)
        on_device.append(x.device)
        return buf

    out = tree_map(copy, tree)
    for device in set(on_device):
        torch.cuda.synchronize(device)
    return out


def save_pytree_async(path: str, tree: Any) -> None:
    """save_pytree on a background thread. The tree is copied into host
    memory before this returns (the train step updates the parameters in
    place, so the next step cannot change what is written); the file is
    written afterwards. A new save first waits for the previous one; a
    writer's error is raised at the next save or at wait_for_saves. Call
    wait_for_saves before reading the file or exiting."""
    _wait()
    snapshot = _host_snapshot(tree)
    path = os.path.abspath(path)

    def write():
        try:
            _write(path, snapshot)
        except BaseException as e:     # raised again by _wait
            _ASYNC["error"] = e

    t = threading.Thread(target=write, name="checkpoint-writer")
    _ASYNC["thread"] = t
    t.start()


def save_in_flight() -> bool:
    """Whether a save_pytree_async file is still being written."""
    t = _ASYNC["thread"]
    return t is not None and t.is_alive()


def wait_for_saves() -> None:
    """Block until every save_pytree_async has written its file (raising
    the writer's error, if any) and free the pinned buffers."""
    try:
        _wait()
    finally:
        _PINNED.clear()


@torch.no_grad()
def load_pytree(path: str, template: Any, map_location="cpu") -> Any:
    """Read a save_pytree file into a template (a nested dict of the same
    paths): every tensor leaf of the file is copied into the template's
    tensor of that path (shapes must match; a sharded leaf's local shard
    from this rank's file of a per-rank directory). Returns the file's
    tree, from which the caller reads the non-tensor leaves."""
    path = os.path.abspath(path)
    name = _rank_file()
    if os.path.isdir(path) != (name is not None):
        raise ValueError(f"load_pytree: {path} was not written by a group "
                         "of this size")
    if name is not None:
        path = os.path.join(path, name)
    saved = torch.load(path, map_location=map_location, weights_only=True)
    have = {p: local(t) for p, t in tree_items(template)}
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
