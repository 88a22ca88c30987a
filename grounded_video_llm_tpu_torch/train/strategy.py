"""Training strategy on one device: stage setup, the epoch/step loop,
checkpoint and resume (port of grounded_video_llm_tpu/train/strategy.py).

  setup         — stage features (vocab expansion when the embedding has
                  only the base vocabulary, LoRA attach), the per-group
                  optimizer, the train step
  run_training  — epoch loop over the resumable loader, the NaN abort,
                  metrics (JSONL, optional wandb), the loss curve
  save/resume   — core/checkpoint's save_pytree of params, optimizer
                  state and step, and the loader's JSON snapshot
  export        — the reference's split-by-module .pth (models/export)

Not ported yet: multi-GPU sharding.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional

import torch

from ..core import checkpoint as ckpt
from ..core.config import NUM_SPECIAL_TOKENS, STAGE_PRESETS, VLMConfig
from ..data.collate import collate
from ..data.loader import DataLoader
from ..models import vlm
from ..obs.logger import initialize_overwatch
from ..obs.trackers import Metrics
from ..text.templates import get_template
from . import lora as lora_mod
from .optimizer import make_optimizer, tree_items, warmup_cosine_decay
from .step import create_train_state, make_train_step
from .vocab import expand_vocab


class TrainingStrategy:
    def __init__(self, cfg: VLMConfig, stage_name: str, params: Dict,
                 tokenizer, run_dir: str = "runs/default",
                 n_train_examples: int = 0, seed: int = 42,
                 wandb_project: Optional[str] = None):
        self.cfg = cfg
        self.stage = STAGE_PRESETS[stage_name]
        self.tokenizer = tokenizer
        self.run_dir = run_dir
        self.seed = seed
        self.overwatch = initialize_overwatch()
        self.device = params["llm"]["embed"].device
        os.makedirs(run_dir, exist_ok=True)

        per_step_batch = self.stage.per_device_batch_size
        if self.stage.global_batch_size % per_step_batch:
            raise ValueError("the global batch must be a multiple of the "
                             "per-device batch")
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
        self.state = create_train_state(params, self.optimizer)
        self.step_fn = make_train_step(
            cfg, self.optimizer, grad_accum=self.grad_accum, remat=True,
            lora_dropout=self.stage.lora_dropout, dropout_seed=seed)
        self.metrics = Metrics(
            run_id=f"{stage_name}-{cfg.llm_name}", run_dir=run_dir,
            hparams={"stage": stage_name, "llm": cfg.llm_name,
                     "global_batch": self.stage.global_batch_size,
                     "grad_accum": self.grad_accum,
                     "total_steps": total_steps},
            wandb_project=wandb_project)
        self.total_steps = total_steps

    # ------------------------------------------------------------------

    def make_loader(self, dataset) -> DataLoader:
        template = get_template(self.cfg.llm_name)
        return DataLoader(
            dataset,
            collate_fn=lambda samples: collate(
                samples, self.tokenizer, template,
                max_txt_len=self.stage.max_txt_len, device=self.device),
            batch_size=self.stage.per_device_batch_size * self.grad_accum,
            shuffle=True, seed=self.seed)

    def _device_batch(self, batch: vlm.Batch) -> vlm.Batch:
        """[grad_accum * B_micro, ...] → [grad_accum, B_micro, ...]."""
        if self.grad_accum == 1:
            return batch
        micro = batch.input_ids.shape[0] // self.grad_accum
        return vlm.Batch(*(x.reshape(self.grad_accum, micro, *x.shape[1:])
                           for x in batch))

    # ------------------------------------------------------------------

    def run_training(self, dataset, resume_from: Optional[str] = None,
                     resume_interval: float = 0.1,
                     on_step: Optional[Callable[[int, dict], None]] = None
                     ) -> None:
        """resume_interval: save a resume bundle every this fraction of an
        epoch (0 turns the interval saves off). on_step(step, metrics) runs
        after every optimizer step with the step's loss and grad_norm as
        floats."""
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
                    self.save_checkpoint("latest", loader)
                    self.plot_loss()

    def plot_loss(self) -> None:
        """Loss-curve jpg in run_dir (reference base_strategy.py:104-116)."""
        if not getattr(self, "_loss_history", None):
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
                        loader: Optional[DataLoader] = None) -> str:
        """params, optimizer state and step in one file; the loader's
        resume state beside it as JSON."""
        path = os.path.join(self.run_dir, f"state_{tag}.pt")
        ckpt.save_pytree(path, {"params": self.state.params,
                                "opt_state": self.state.opt_state,
                                "step": self.state.step})
        if loader is not None:
            ckpt.save_json(os.path.join(self.run_dir, f"loader_{tag}.json"),
                           loader.state_dict())
        return path

    def load_resume(self, path: str, loader: DataLoader) -> None:
        """Restore a save_checkpoint bundle into this strategy's tensors
        (paths and shapes must match) and the loader's position."""
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
        layout (fsdp.py:116-127) for cross-framework weight exchange."""
        from ..models import export as export_mod

        export_mod.export_vlm_to_reference(self.state.params, self.cfg, path,
                                           trainable_only=trainable_only)
