"""Training strategy: stage setup, the epoch/step loop, checkpoint and
resume, on one device or on a (data, fsdp, tensor) mesh of processes (port
of grounded_video_llm_tpu/train/strategy.py).

  setup         — stage features (vocab expansion when the embedding has
                  only the base vocabulary, LoRA attach), the per-group
                  optimizer, the parameters sharded onto the mesh, the
                  train step; grad_accum = global batch / (per-device
                  batch x ranks), JAX's arithmetic
  run_training  — epoch loop over the resumable loader (each batch rank
                  reads its own shard of every global batch), the NaN
                  abort, metrics (JSONL, optional wandb) and the loss curve
                  on rank 0
  save/resume   — core/checkpoint's save_pytree of params, optimizer
                  state and step (per rank on a mesh of more than one),
                  and the loader's JSON snapshot; the interval saves are
                  asynchronous (save_pytree_async), the loop waits for them
                  at its end and a resume waits first
  export        — the reference's split-by-module .pth (models/export)

Without a mesh and without a process group it trains on the parameters'
device alone; with a process group and no mesh it builds build_mesh().
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..core import checkpoint as ckpt
from ..core.config import NUM_SPECIAL_TOKENS, STAGE_PRESETS, VLMConfig
from ..data.collate import collate
from ..data.loader import DataLoader
from ..models import vlm
from ..obs.logger import initialize_overwatch
from ..obs.trackers import Metrics
from ..parallel.mesh import build_mesh
from ..parallel.partitioning import full_tree
from ..text.templates import get_template
from . import lora as lora_mod
from .optimizer import make_optimizer, warmup_cosine_decay
from .step import create_train_state, make_train_step
from .vocab import expand_vocab


class TrainingStrategy:
    def __init__(self, cfg: VLMConfig, stage_name: str, params: Dict,
                 tokenizer, run_dir: str = "runs/default", mesh=None,
                 n_train_examples: int = 0, seed: int = 42,
                 wandb_project: Optional[str] = None):
        self.cfg = cfg
        self.stage = STAGE_PRESETS[stage_name]
        self.tokenizer = tokenizer
        self.run_dir = run_dir
        self.seed = seed
        self.overwatch = initialize_overwatch()
        if mesh is None and dist.is_available() and dist.is_initialized():
            mesh = build_mesh()
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else params["llm"]["embed"].device)
        self.is_rank_zero = mesh is None or dist.get_rank() == 0
        os.makedirs(run_dir, exist_ok=True)

        n_ranks = mesh.size if mesh is not None else 1
        per_step_batch = self.stage.per_device_batch_size * n_ranks
        if self.stage.global_batch_size % per_step_batch:
            raise ValueError("the global batch must be a multiple of the "
                             "per-device batch times the ranks")
        self.grad_accum = self.stage.global_batch_size // per_step_batch
        self.steps_per_epoch = (
            n_train_examples // self.stage.global_batch_size
            if n_train_examples else 0)
        total_steps = max(self.steps_per_epoch * self.stage.epochs, 1)

        # stage features
        if self.stage.expand_vocab and (
                params["llm"]["embed"].shape[0] == cfg.llm.vocab_size):
            params["llm"] = expand_vocab(params["llm"], NUM_SPECIAL_TOKENS)
        if self.stage.lora and "lora" not in params["llm"]["layers"]:
            g = torch.Generator(device=self.device)
            g.manual_seed(seed)
            params["llm"] = lora_mod.attach_lora(
                params["llm"], lora_mod.init_lora(
                    cfg.llm, generator=g, device=self.device,
                    dtype=params["llm"]["embed"].dtype))

        self.optimizer, self.labels = make_optimizer(self.stage, total_steps,
                                                     params)
        # schedule mirror for lr reporting (the reference logs its lr)
        warmup = max(int(total_steps * self.stage.warmup_ratio), 1)
        self._lr_schedule = warmup_cosine_decay(
            0.0, self.stage.lr_llm or self.stage.lr_video_projector, warmup,
            max(total_steps, warmup + 1), 0.0)
        self.state = create_train_state(params, self.optimizer, mesh=mesh,
                                        cfg=cfg)
        self.step_fn = make_train_step(
            cfg, self.optimizer, grad_accum=self.grad_accum, remat=True,
            lora_dropout=self.stage.lora_dropout, dropout_seed=seed,
            mesh=mesh)
        self.save_blocked_s = []     # seconds the loop waited on each save
        hparams = {"stage": stage_name, "llm": cfg.llm_name,
                   "global_batch": self.stage.global_batch_size,
                   "grad_accum": self.grad_accum, "total_steps": total_steps}
        run_id = f"{stage_name}-{cfg.llm_name}"
        self.metrics = Metrics(run_id=run_id, run_dir=run_dir,
                               hparams=hparams, wandb_project=wandb_project,
                               write=self.is_rank_zero)
        self.total_steps = total_steps

    # ------------------------------------------------------------------

    def make_loader(self, dataset) -> DataLoader:
        """Each batch rank (data x fsdp) reads its own shard of every
        global batch: per step per_device_batch x tensor x grad_accum rows
        (the ranks of one tensor group read the same)."""
        template = get_template(self.cfg.llm_name)
        shards, shard_id, tensor = 1, 0, 1
        if self.mesh is not None:
            shards, shard_id = self.mesh.batch_ranks, self.mesh.batch_rank
            tensor = self.mesh.shape["tensor"]
        return DataLoader(
            dataset,
            collate_fn=lambda samples: collate(
                samples, self.tokenizer, template,
                max_txt_len=self.stage.max_txt_len, device=self.device),
            batch_size=(self.stage.per_device_batch_size * tensor
                        * self.grad_accum),
            shuffle=True, seed=self.seed, num_shards=shards,
            shard_id=shard_id)

    def _device_batch(self, batch: vlm.Batch) -> vlm.Batch:
        """[grad_accum * B_micro, ...] → [grad_accum, B_micro, ...] (the
        collate put this rank's rows on its device already)."""
        if self.grad_accum > 1:
            micro = batch.input_ids.shape[0] // self.grad_accum
            batch = vlm.Batch(*(x.reshape(self.grad_accum, micro,
                                          *x.shape[1:]) for x in batch))
        return batch

    # ------------------------------------------------------------------

    def run_training(self, dataset, resume_from: Optional[str] = None,
                     resume_interval: float = 0.1,
                     on_step: Optional[Callable[[int, dict], None]] = None
                     ) -> None:
        """resume_interval: save a resume bundle every this fraction of an
        epoch (0 turns the interval saves off); they are written in the
        background (save_pytree_async) and the loop waits for the last one
        before it returns. on_step(step, metrics) runs after every
        optimizer step with the step's loss and grad_norm as floats."""
        loader = self.make_loader(dataset)
        if resume_from:
            self.load_resume(resume_from, loader)

        self._loss_history = []
        save_every = (max(int(self.steps_per_epoch * resume_interval), 1)
                      if self.steps_per_epoch and resume_interval > 0 else 0)

        for epoch in range(loader.epoch, self.stage.epochs):
            self.overwatch.info(f"epoch {epoch}")
            for host_batch in loader.epoch_iterator():
                batch = self._device_batch(host_batch)
                self.state, m = self.step_fn(self.state, batch)
                loss = float(m["loss"])
                if math.isnan(loss):
                    raise RuntimeError("NaN loss encountered — aborting "
                                       "(as the reference's training loop)")
                grad_norm = float(m["grad_norm"])
                self.metrics.commit(loss)
                self._loss_history.append(loss)
                lr = float(self._lr_schedule(self.metrics.global_step))
                status = self.metrics.push(lr=lr,
                                           extra={"grad_norm": grad_norm})
                if self.metrics.global_step % 10 == 0:
                    self.overwatch.info(status)
                if on_step is not None:
                    on_step(self.state.step, {"loss": loss,
                                              "grad_norm": grad_norm})
                if save_every and self.metrics.global_step % save_every == 0:
                    t0 = time.perf_counter()
                    self.save_checkpoint("latest", loader, block=False)
                    self.save_blocked_s.append(time.perf_counter() - t0)
                    self.plot_loss()
        ckpt.wait_for_saves()

    def plot_loss(self) -> None:
        """Loss-curve jpg in run_dir (reference base_strategy.py:104-116),
        on rank 0."""
        if not getattr(self, "_loss_history", None) or not self.is_rank_zero:
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.figure(figsize=(8, 4))
            plt.plot(self._loss_history)
            plt.xlabel("step")
            plt.ylabel("loss")
            plt.tight_layout()
            plt.savefig(os.path.join(self.run_dir, "loss_curve.jpg"))
            plt.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    # Checkpointing

    def save_checkpoint(self, tag: str = "latest",
                        loader: Optional[DataLoader] = None,
                        block: bool = True) -> str:
        """params, optimizer state and step in one file (a directory of
        one file per rank on a mesh of more than one); the loader's resume
        state beside it as JSON (each batch rank's position is the same).
        block=False snapshots the state and writes it in the background
        (core/checkpoint.save_pytree_async)."""
        path = os.path.join(self.run_dir, f"state_{tag}.pt")
        tree = {"params": self.state.params,
                "opt_state": self.state.opt_state, "step": self.state.step}
        if block:
            ckpt.wait_for_saves()
            ckpt.save_pytree(path, tree)
        else:
            ckpt.save_pytree_async(path, tree)
        if loader is not None and self.is_rank_zero:
            ckpt.save_json(os.path.join(self.run_dir, f"loader_{tag}.json"),
                           loader.state_dict())
        return path

    def load_resume(self, path: str, loader: DataLoader) -> None:
        """Restore a save_checkpoint bundle into this strategy's tensors
        (paths and shapes must match; on a mesh, the same mesh) and the
        loader's position, after any save still being written."""
        ckpt.wait_for_saves()
        if self.mesh is not None:
            dist.barrier()      # every rank's file is complete
        restored = ckpt.load_pytree(path, template={
            "params": self.state.params, "opt_state": self.state.opt_state,
            "step": self.state.step}, map_location=self.device)
        self.state.opt_state["count"] = int(restored["opt_state"]["count"])
        self.state.step = int(restored["step"])
        loader_json = os.path.join(os.path.dirname(path),
                                   "loader_latest.json")
        if os.path.exists(loader_json):
            loader.load_state_dict(ckpt.load_json(loader_json))

    def export_reference_checkpoint(self, path: str,
                                    trainable_only: bool = True) -> None:
        """Trainable-only split-by-module export in the reference's .pth
        layout (fsdp.py:116-127) for cross-framework weight exchange. On a
        mesh every rank gathers the sharded leaves and rank 0 writes."""
        from ..models import export as export_mod

        params = full_tree(self.state.params)
        if self.is_rank_zero:
            export_mod.export_vlm_to_reference(params, self.cfg, path,
                                               trainable_only=trainable_only)
