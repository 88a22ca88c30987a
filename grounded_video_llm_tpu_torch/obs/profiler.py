"""Profiling hooks (port of grounded_video_llm_tpu/obs/profiler.py):
torch.profiler device traces, named trace regions, a device barrier and a
per-phase wall-clock timer.

``device_trace(log_dir)`` records CPU and CUDA activity with torch.profiler
and writes one Chrome / Perfetto trace (``*.pt.trace.json``, the layout
TensorBoard's profiler plugin reads) into log_dir when the block ends.
``annotate(name)`` is a named region (torch.profiler.record_function) that
shows in that trace on the host's timeline and around the kernels it
launched. ``sync(x)`` waits for every CUDA device that holds a tensor of
the tree x; CUDA launches return before the device has run them, so a host
clock read after ``sync`` times the work. ``PhaseTimer`` sums wall time per
phase, with that barrier at the end of each, and reports it in the JAX
module's keys and line format.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Record a torch.profiler trace (CPU and, where there is a card, CUDA
    activity) and write it into log_dir (default: torch-trace in the
    temporary directory) as it ends."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir


def annotate(name: str):
    """Named trace region (shows up in the device_trace timeline)."""
    return torch.profiler.record_function(name)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def sync(x=None):
    """Device barrier: synchronise each CUDA device that holds a tensor of
    the tree x (dicts, lists, tuples, NamedTuples); nothing for None or
    tensors on the CPU."""
    devices = {t.device for t in _tensors(x) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class PhaseTimer:
    """Accumulating wall-clock timer for pipeline phases (decode, preprocess,
    encode, prefill, decode-loop...)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, barrier_on=None):
        t0 = time.time()
        try:
            yield
        finally:
            sync(barrier_on)
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": self.totals[name],
                       "count": self.counts[name],
                       "mean_s": self.totals[name] / max(self.counts[name], 1)}
                for name in self.totals}

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:>16}: {s['mean_s']*1000:8.1f} ms/call "
                         f"x{s['count']} = {s['total_s']:.2f}s")
        return "\n".join(lines)
