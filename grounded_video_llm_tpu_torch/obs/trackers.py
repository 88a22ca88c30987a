"""Metric trackers: JSONL + optional wandb + windowed status metrics (a
copy of the framework-free grounded_video_llm_tpu/obs/trackers.py;
tests/test_torch_shared_modules.py holds it to the original).

The reference ships these but never wires them (reference training/metrics.py,
call sites commented out in base_strategy.py:288,309,324-326). Here they are
wired into the training loop (train/strategy.py): per-step loss/lr/step-time
windows, a JSONL run log, and an optional wandb sink when the package and
credentials exist."""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, Optional


class JSONLinesTracker:
    """Append-only metric log (reference metrics.py:37-53)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write_hyperparameters(self, hparams: Dict) -> None:
        self._append({"hparams": hparams})

    def write(self, global_step: int, metrics: Dict) -> None:
        self._append({"step": global_step, **metrics})

    def _append(self, obj: Dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(obj) + "\n")


class WandbTracker:
    """Best-effort wandb sink (reference metrics.py:55-99)."""

    def __init__(self, project: str, run_id: str, hparams: Dict):
        self._run = None
        try:
            import wandb

            self._run = wandb.init(project=project, id=run_id, config=hparams,
                                   resume="allow")
        except Exception:
            pass

    def write(self, global_step: int, metrics: Dict) -> None:
        if self._run is not None:
            self._run.log(metrics, step=global_step)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()


class Metrics:
    """Windowed status metrics + tracker fan-out (reference metrics.py:104-204)."""

    def __init__(self, run_id: str, run_dir: str, hparams: Dict,
                 window: int = 128, wandb_project: Optional[str] = None,
                 write: bool = True):
        """write=False keeps the windows and the step count and writes
        nowhere (the training ranks other than 0)."""
        self.run_id = run_id
        self.global_step = 0
        self.start_time = time.time()
        self.step_start = time.time()
        self.loss_window = deque(maxlen=window)
        self.step_time_window = deque(maxlen=window)
        self.trackers = []
        if write:
            self.trackers.append(JSONLinesTracker(
                os.path.join(run_dir, f"{run_id}.jsonl")))
        if write and wandb_project:
            self.trackers.append(WandbTracker(wandb_project, run_id, hparams))
        for t in self.trackers:
            if hasattr(t, "write_hyperparameters"):
                t.write_hyperparameters(hparams)

    def commit(self, loss: float) -> None:
        self.loss_window.append(float(loss))
        now = time.time()
        self.step_time_window.append(now - self.step_start)
        self.step_start = now

    def push(self, lr: float, extra: Optional[Dict] = None) -> str:
        self.global_step += 1
        loss = (sum(self.loss_window) / len(self.loss_window)
                if self.loss_window else float("nan"))
        step_t = (sum(self.step_time_window) / len(self.step_time_window)
                  if self.step_time_window else 0.0)
        metrics = {"loss": loss, "lr": lr, "step_time_s": step_t}
        if extra:
            metrics.update(extra)
        for t in self.trackers:
            t.write(self.global_step, metrics)
        return (f"step {self.global_step:06d} | loss {loss:.4f} | "
                f"lr {lr:.2e} | {step_t:.2f}s/it")

    def finish(self) -> None:
        for t in self.trackers:
            if hasattr(t, "finish"):
                t.finish()
