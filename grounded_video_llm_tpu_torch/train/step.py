"""The train step (port of grounded_video_llm_tpu/train/step.py).

One function serves what the JAX package builds twice (make_train_step's
lax.scan over microbatches and make_host_accum_step's host loop; they
compute the same thing): a Python loop over the microbatches, each a
forward and a backward, with the gradients taken with respect to the
trainable leaves only and summed in fp32 accumulators. Then loss = the mean
of the microbatch losses, the gradients are divided by grad_accum and cast
to each parameter's dtype, grad_norm is their global norm before clipping,
and the optimizer updates the parameters in place. JAX's
partition_params / merge_params are requires_grad here (set_trainable:
frozen leaves form no gradient), and make_host_accum_step is this loop.

On a mesh (parallel/mesh.Mesh) the parameters are sharded by
parallel/partitioning.shard_params and each rank runs its own rows of the
batch (shard_batch splits the batch dim over data x fsdp; ranks of one
tensor group hold the same rows and compute their own heads and columns,
parallel/tensor.py). A rank's loss is its share of the whole batch's
(llm.causal_lm_loss_from_hidden), so the sums over the batch ranks are
JAX's loss and gradient: the gathers' backward reduce-scatters over fsdp,
and after the microbatches the step sums the accumulators over data (and
over fsdp for the leaves fsdp does not split) and the loss over data x
fsdp. The gradient of a tensor-split leaf is the rank's own shard's, and
that of a replicated leaf is the same on every rank of a tensor group (the
split layers sum its parts over the group), so neither is summed over
'tensor' here; the global norm counts each element once
(partitioning.replicas).

LoRA dropout masks come from seeds derived from (dropout_seed, step,
microbatch), and on more than one batch rank also from the batch rank, so
a resumed run draws the same masks; a sharded step draws other masks for
its rows than the single-process step does for the same rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.distributed as dist

from ..core.config import VLMConfig
from ..models import vlm
from ..models.llm import mix_seed
from ..parallel.mesh import DATA_AXIS, FSDP_AXIS
from ..parallel.partitioning import local, shard_params, split_axes
from .optimizer import Optimizer, tree_items


@dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int = 0


def set_trainable(params, optimizer: Optimizer) -> None:
    """requires_grad on the trainable leaves, off on every frozen one."""
    for path, t in tree_items(params):
        t.requires_grad_(optimizer.trainable(path))


def create_train_state(params, optimizer: Optimizer, mesh=None,
                       cfg=None) -> TrainState:
    """With a mesh the params are sharded first (shard_params; cfg, the
    VLMConfig, lays out the heads a 'tensor' axis splits) and the
    optimizer state is made from the shards."""
    if mesh is not None:
        params = shard_params(params, mesh, cfg)
        optimizer.use_mesh(mesh, params)
    set_trainable(params, optimizer)
    return TrainState(params, optimizer.init(params), 0)


def reduce_gradients(mesh, leaves, acc) -> None:
    """Sum each accumulator over the batch ranks its gather's backward has
    not summed it over: data always, fsdp where fsdp does not split the
    leaf. In place."""
    for t, a in zip(leaves, acc):
        if FSDP_AXIS in split_axes(t):
            if mesh.shape[DATA_AXIS] > 1:
                dist.all_reduce(a, group=mesh.group(DATA_AXIS))
        elif mesh.batch_ranks > 1:
            dist.all_reduce(a, group=mesh.batch_group)


def make_train_step(cfg: VLMConfig, optimizer: Optimizer, grad_accum: int = 1,
                    remat: bool = True, remat_group: int = 1,
                    lora_dropout: float = 0.0, dropout_seed: int = 0,
                    mesh=None):
    """→ step_fn(state, batch) → (state, {"loss", "grad_norm"}), updating
    state in place (made by create_train_state, which sets requires_grad).
    batch: a vlm.Batch with leaves [B, ...] when grad_accum is 1, else
    [grad_accum, B_micro, ...]; on a mesh, this rank's rows (shard_batch)."""
    multi = mesh is not None and mesh.batch_ranks > 1

    def step_fn(state: TrainState, batch: vlm.Batch):
        names = [p for p, _ in tree_items(state.params)
                 if optimizer.trainable(p)]
        flat = dict(tree_items(state.params))
        leaves = [flat[p] for p in names]
        acc = [torch.zeros(local(t).shape, dtype=torch.float32,
                           device=t.device) for t in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for i in range(grad_accum):
            mb = (batch if grad_accum == 1
                  else vlm.Batch(*(x[i] for x in batch)))
            seed = None
            if lora_dropout > 0.0:
                seed = (mix_seed(dropout_seed, state.step, i, mesh.batch_rank)
                        if multi else mix_seed(dropout_seed, state.step, i))
            loss = vlm.forward_loss(state.params, cfg, mb, remat=remat,
                                    remat_group=remat_group,
                                    lora_dropout=lora_dropout,
                                    dropout_seed=seed, mesh=mesh)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a += local(g)
            loss_sum += loss.detach()
            del loss, grads
        if mesh is not None:
            reduce_gradients(mesh, leaves, acc)
            dist.all_reduce(loss_sum, group=mesh.batch_group)
        g_train: Dict[str, torch.Tensor] = {
            p: (a / grad_accum).to(t.dtype)
            for p, a, t in zip(names, acc, leaves)}
        del acc
        gnorm = optimizer.grad_norm(g_train)
        optimizer.apply(state.params, g_train, state.opt_state)
        state.step += 1
        return state, {"loss": loss_sum / grad_accum, "grad_norm": gnorm}

    return step_fn


def shard_batch(batch: vlm.Batch, mesh, grad_accum: int = 1) -> vlm.Batch:
    """This rank's part of a batch, on the mesh's device: the batch dim
    (axis 1 under grad_accum, where the microbatch axis leads) split over
    data x fsdp, data-major; ranks of one tensor group take the same rows."""
    axis = 1 if grad_accum > 1 else 0
    n, r = mesh.batch_ranks, mesh.batch_rank

    def put(x):
        if x.dim() > axis:
            rows = x.shape[axis]
            if rows % n:
                raise ValueError(f"{rows} rows do not split over {n} batch "
                                 "ranks")
            x = x.narrow(axis, r * (rows // n), rows // n)
        return x.to(mesh.device)

    return vlm.Batch(*(put(x) for x in batch))
