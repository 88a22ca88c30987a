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

``SpanLog`` and ``record`` are the serving path's spans and counters (not in
the JAX module): ``record`` closes a span begun at a
``time.perf_counter_ns()`` stamp, always adds its seconds (and a count) to a
counter dict such as ``ContinuousServer.timings``, and appends it to a
``SpanLog`` only where one is attached (none by default).
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import threading
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


class SpanLog:
    """A bounded in-memory log of spans (name, request_id, thread_name,
    t0_ns, t1_ns) on the ``time.perf_counter_ns()`` clock; past ``limit``
    spans the oldest go. Appends from several threads are safe (a deque)."""

    def __init__(self, limit: int = 1 << 20):
        self.spans = collections.deque(maxlen=limit)

    def add(self, name: str, request_id: Optional[int], t0: int,
            t1: int) -> None:
        self.spans.append((name, request_id, threading.current_thread().name,
                           t0, t1))


def record(timings: Optional[dict], key: Optional[str], t0: int, *,
           count: Optional[str] = None, log: Optional[SpanLog] = None,
           name: Optional[str] = None, request_id: Optional[int] = None,
           t1: Optional[int] = None) -> int:
    """Close the span [t0, t1] (``time.perf_counter_ns()`` stamps; t1 now
    unless given): add its seconds to timings[key] and 1 to timings[count]
    (each where given; nothing where timings is None), and append it to log
    as ``name`` where a log is attached. → t1. A key must not take adds
    from two threads without a lock."""
    if t1 is None:
        t1 = time.perf_counter_ns()
    if timings is not None:
        if key is not None:
            timings[key] = timings.get(key, 0) + (t1 - t0) / 1e9
        if count is not None:
            timings[count] = timings.get(count, 0) + 1
    if log is not None:
        log.add(name, request_id, t0, t1)
    return t1
