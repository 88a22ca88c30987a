"""Dynamic-batching request scheduler for production serving (port of
grounded_video_llm_tpu/serve/scheduler.py).

The reference serves one video per process invocation (inference.py). For
deployment, this scheduler accepts concurrent requests, coalesces them into
batches (up to max_batch, waiting at most batch_window_s for stragglers), runs
the batched engine (one batch shape per size bucket), and resolves
per-request futures. Host preprocessing runs in the engine's thread pool and
overlaps with the previous batch's device compute.

Requests are padded up to the nearest bucket (powers of two up to
max_batch) by REUSING the last request's already-preprocessed pixel tensors
(no duplicate video decode), so steady traffic runs a handful of batch
shapes and padding costs only the duplicated device compute.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

from .engine import InferenceEngine, InferenceResult


@dataclass
class _Request:
    video_path: str
    prompt: str
    mode: str
    future: Future = field(default_factory=Future)


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class Scheduler:
    def __init__(self, engine: InferenceEngine, max_batch: int = 6,
                 batch_window_s: float = 0.05):
        self.engine = engine
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._running = True
        self._thread.start()

    # -- client API ----------------------------------------------------------

    def submit(self, video_path: str, prompt: str,
               mode: str = "qa") -> "Future[InferenceResult]":
        req = _Request(video_path, prompt, mode)
        self._queue.put(req)
        return req.future

    def shutdown(self, wait: bool = True) -> None:
        self._running = False
        self._queue.put(None)
        if wait:
            self._thread.join(timeout=60)

    # -- scheduler loop --------------------------------------------------------

    def _collect(self) -> List[_Request]:
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = threading.Event()
        timer = threading.Timer(self.batch_window_s, deadline.set)
        timer.start()
        try:
            while len(batch) < self.max_batch and not deadline.is_set():
                try:
                    item = self._queue.get(timeout=self.batch_window_s / 10)
                except queue.Empty:
                    continue
                if item is None:
                    self._running = False
                    break
                batch.append(item)
        finally:
            timer.cancel()
        return batch

    def _loop(self) -> None:
        while self._running:
            # group by mode so prompts build uniformly
            batch = self._collect()
            if not batch:
                break
            by_mode: dict = {}
            for r in batch:
                by_mode.setdefault(r.mode, []).append(r)
            for mode, reqs in by_mode.items():
                self._run_batch(reqs, mode)

    def _run_batch(self, reqs: List[_Request], mode: str) -> None:
        try:
            # decode/preprocess each REAL request once, then pad to the bucket
            # size with the last request's already-preprocessed pixels
            bucket = _bucket(len(reqs), self.max_batch)
            with ThreadPoolExecutor(max_workers=4) as pool:
                prep = list(pool.map(self.engine.preprocess_video,
                                     [r.video_path for r in reqs]))
            results = self.engine.generate_prepped(
                prep, [r.prompt for r in reqs], mode=mode, pad_to=bucket)
            for r, res in zip(reqs, results):
                r.future.set_result(res)
        except Exception as e:  # noqa: BLE001 — propagate to callers
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
