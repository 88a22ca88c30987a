"""Per-group AdamW with warmup-cosine schedules and stage-based freezing
(port of grounded_video_llm_tpu/train/optimizer.py, with optax's semantics).

Parameters are grouped by path: video_projector, mm_projector, lora (the
adapters' a and b), llm (lm_head and embed) and frozen (everything else,
including the adapters' scale). The update is optax's

    chain(clip_by_global_norm(grad_clip), multi_transform(per-group adamw))

written out: the global norm is taken over every trainable gradient
together, and when it reaches max_norm each gradient becomes
g * max_norm / norm (torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm,
which is not the same). Then per group AdamW (b1 0.9, b2 0.999, eps 1e-8
outside the square root, the stage's weight decay) at the learning rate of
a warmup-cosine schedule from 0, evaluated at the count before it is
incremented, so the first update is a no-op. A group whose peak rate is 0
is optax.set_to_zero: its parameters keep their gradients (they count in
the norm) but never move. Frozen leaves get requires_grad=False, so no
gradient is formed for them at all.

The moments are kept in each parameter's dtype, as optax keeps them. The
global norm accumulates in fp32 (optax sums each leaf in its own dtype).

On a mesh (``use_mesh``) a leaf may be a DTensor of this rank's shard
(parallel/partitioning): its moments are shaped like the shard (ZeRO), the
update runs on the shard, and the global norm counts every gradient
element once: each rank sums the squares of its shards, each leaf's share
divided by the number of ranks that hold the same shard, and the sums are
added over every rank.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import StageConfig
from ..parallel.partitioning import local, replicas

GROUPS = ("video_projector", "mm_projector", "llm", "lora")
B1, B2, EPS = 0.9, 0.999, 1e-8


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path "a/b/c", leaf) for every leaf of a nested dict, in order."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from tree_items(v, path)
        else:
            yield path, v


def tree_map(fn: Callable, tree, prefix: str = ""):
    """The same nesting with fn(path, leaf) at every leaf."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out[k] = tree_map(fn, v, path) if isinstance(v, dict) else fn(path,
                                                                       v)
    return out


def label_for(path: str) -> str:
    if "video_projector" in path:
        return "video_projector"
    if "mm_projector" in path:
        return "mm_projector"
    if "/lora/" in path and path.endswith(("/a", "/b")):
        return "lora"
    if path.startswith("llm/") and ("lm_head" in path or "embed" in path):
        return "llm"
    return "frozen"


def label_params(params) -> dict:
    """Label tree: the params' nesting with each leaf's group name."""
    return tree_map(lambda path, _: label_for(path), params)


def trainable_mask(labels) -> dict:
    """Bool tree: True where the leaf belongs to a trainable group."""
    return tree_map(lambda _, label: label != "frozen", labels)


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then cosine to end_value at decay_steps
    (which includes the warmup). Evaluated in float32."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    f32 = np.float32
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(
                warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        c = f32(min(count - warmup_steps, cos_steps))
        cosine = f32(0.5) * (f32(1) + f32(math.cos(math.pi * c / cos_steps)))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


class Optimizer:
    """clip_by_global_norm, then AdamW per group (see the module doc).
    ``labels`` maps every parameter path to its group. The state is a dict
    of tensors and a count, so torch.save writes it as it is."""

    def __init__(self, stage: StageConfig, total_steps: int,
                 labels: Dict[str, str]):
        self.grad_clip = stage.grad_clip
        self.weight_decay = stage.weight_decay
        self.labels = labels
        warmup = max(int(total_steps * stage.warmup_ratio), 1)
        peaks = {"video_projector": stage.lr_video_projector,
                 "mm_projector": stage.lr_mm_projector,
                 "llm": stage.lr_llm, "lora": stage.lr_lora}
        self.schedules: Dict[str, Optional[Callable[[int], float]]] = {
            g: (warmup_cosine_decay(0.0, peak, warmup,
                                    max(total_steps, warmup + 1), 0.0)
                if peak > 0.0 else None)
            for g, peak in peaks.items()}
        self.replicas: Optional[Dict[str, int]] = None

    def use_mesh(self, mesh, params) -> None:
        """Sharded training over mesh: ``params`` is the sharded tree."""
        self.replicas = {p: replicas(t, mesh.size)
                         for p, t in tree_items(params)}

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of ``grads`` (path → this rank's shard)."""
        if self.replicas is None:
            return global_norm(list(grads.values()))
        return global_norm(list(grads.values()),
                           [self.replicas[p] for p in grads])

    def trainable(self, path: str) -> bool:
        return self.labels[path] != "frozen"

    def updated(self, path: str) -> bool:
        """Trainable and in a group with a learning rate (not set_to_zero)."""
        return (self.trainable(path)
                and self.schedules[self.labels[path]] is not None)

    def init(self, params) -> dict:
        flat = {p: local(t) for p, t in tree_items(params)}
        zeros = {p: torch.zeros_like(t, memory_format=torch.contiguous_format)
                 for p, t in flat.items() if self.updated(p)}
        return {"count": 0, "mu": zeros,
                "nu": {p: torch.zeros_like(t) for p, t in zeros.items()}}

    def lr(self, group: str, count: int) -> float:
        sched = self.schedules[group]
        return 0.0 if sched is None else sched(count)

    @torch.no_grad()
    def apply(self, params, grads: Dict[str, torch.Tensor],
              state: dict) -> None:
        """Update the trainable leaves of ``params`` in place from
        ``grads`` (path → gradient in the leaf's dtype, every trainable
        leaf; this rank's shard of a sharded one) and advance ``state``."""
        flat = {p: local(t) for p, t in tree_items(params)}
        gnorm = self.grad_norm(grads)
        clip = not bool(gnorm < self.grad_clip)
        count = state["count"]
        f32 = np.float32
        bc1 = f32(1) - f32(B1) ** f32(count + 1)
        bc2 = f32(1) - f32(B2) ** f32(count + 1)
        for path, g in grads.items():
            if not self.updated(path):
                continue
            p = flat[path]
            if clip:
                g = (g / gnorm.to(g.dtype)) * self.grad_clip
            mu, nu = state["mu"][path], state["nu"][path]
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * (g * g) + B2 * nu)
            u = (mu / torch.tensor(bc1, dtype=mu.dtype)) / (
                torch.sqrt(nu / torch.tensor(bc2, dtype=nu.dtype)) + EPS)
            if self.weight_decay:
                u = u + self.weight_decay * p
            step = -self.lr(self.labels[path], count)
            p.copy_((p + u * torch.tensor(step, dtype=u.dtype)).to(p.dtype))
        state["count"] = count + 1


def global_norm(tensors, replicas=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32. replicas: the
    tensors are shards, held by that many ranks each; the sum is taken over
    every rank of the default process group with each tensor's share
    divided by its replicas."""
    if replicas is None:
        return torch.sqrt(sum(t.float().square().sum() for t in tensors))
    total = sum(t.float().square().sum() / r
                for t, r in zip(tensors, replicas))
    dist.all_reduce(total)
    return torch.sqrt(total)


def make_optimizer(stage: StageConfig, total_steps: int,
                   params) -> Tuple[Optimizer, dict]:
    """→ (Optimizer, labels tree)."""
    labels = label_params(params)
    return Optimizer(stage, total_steps, dict(tree_items(labels))), labels
