"""The train step (port of grounded_video_llm_tpu/train/step.py).

One function serves what the JAX package builds twice (make_train_step's
lax.scan over microbatches and make_host_accum_step's host loop; they
compute the same thing): a Python loop over the microbatches, each a
forward and a backward, with the gradients taken with respect to the
trainable leaves only and summed in fp32 accumulators. Then loss = the mean
of the microbatch losses, the gradients are divided by grad_accum and cast
to each parameter's dtype, grad_norm is their global norm before clipping,
and the optimizer updates the parameters in place.

LoRA dropout masks come from seeds derived from (dropout_seed, step,
microbatch), so a resumed run draws the same masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ..core.config import VLMConfig
from ..models import vlm
from ..models.llm import mix_seed
from .optimizer import Optimizer, global_norm, tree_items


@dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int = 0


def set_trainable(params, optimizer: Optimizer) -> None:
    """requires_grad on the trainable leaves, off on every frozen one."""
    for path, t in tree_items(params):
        t.requires_grad_(optimizer.trainable(path))


def create_train_state(params, optimizer: Optimizer) -> TrainState:
    set_trainable(params, optimizer)
    return TrainState(params, optimizer.init(params), 0)


def make_train_step(cfg: VLMConfig, optimizer: Optimizer, grad_accum: int = 1,
                    remat: bool = True, remat_group: int = 1,
                    lora_dropout: float = 0.0, dropout_seed: int = 0):
    """→ step_fn(state, batch) → (state, {"loss", "grad_norm"}), updating
    state in place (made by create_train_state, which sets requires_grad).
    batch: a vlm.Batch with leaves [B, ...] when grad_accum is 1, else
    [grad_accum, B_micro, ...]."""

    def step_fn(state: TrainState, batch: vlm.Batch):
        names = [p for p, _ in tree_items(state.params)
                 if optimizer.trainable(p)]
        flat = dict(tree_items(state.params))
        leaves = [flat[p] for p in names]
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for t in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for i in range(grad_accum):
            mb = (batch if grad_accum == 1
                  else vlm.Batch(*(x[i] for x in batch)))
            seed = (mix_seed(dropout_seed, state.step, i)
                    if lora_dropout > 0.0 else None)
            loss = vlm.forward_loss(state.params, cfg, mb, remat=remat,
                                    remat_group=remat_group,
                                    lora_dropout=lora_dropout,
                                    dropout_seed=seed)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a += g
            loss_sum += loss.detach()
            del loss, grads
        g_train: Dict[str, torch.Tensor] = {
            p: (a / grad_accum).to(t.dtype)
            for p, a, t in zip(names, acc, leaves)}
        del acc
        gnorm = global_norm(list(g_train.values()))
        optimizer.apply(state.params, g_train, state.opt_state)
        state.step += 1
        return state, {"loss": loss_sum / grad_accum, "grad_norm": gnorm}

    return step_fn
