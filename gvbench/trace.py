"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a short
steady stretch of the window, read into plain lists.

``DeviceTrace`` holds every device activity (kernels, copies, sets) as
(name, start, end) in host nanoseconds, the harness's host spans (submit,
resize, encode, prefix) the same way, and the traced stretch's bounds.
Busy time is the union of the device activities inside the stretch; an
idle gap is a stretch of it with none, named by the innermost host span
open at its middle.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Tuple

Interval = Tuple[str, int, int]


@dataclass
class DeviceTrace:
    t0: int
    t1: int
    device: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def merged(self) -> List[Tuple[int, int]]:
        spans = sorted((max(s, self.t0), min(e, self.t1))
                       for _, s, e in self.device if e > self.t0
                       and s < self.t1)
        out: List[List[int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        out, cur = [], self.t0
        for s, e in self.merged():
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if cur < self.t1:
            out.append((cur, self.t1))
        return out

    def kernels(self, match) -> List[Interval]:
        """Device activities inside the stretch whose name match(name)."""
        return [(n, s, e) for n, s, e in self.device
                if s >= self.t0 and e <= self.t1 and match(n)]

    def top_ops(self, n: int = 10) -> List[list]:
        total: dict = {}
        for name, s, e in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                total[name] = total.get(name, 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def host_at(self, t: int) -> str:
        """The innermost host span open at t."""
        best = None
        for name, s, e in self.host:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return "none" if best is None else best[0][:160]

    def top_gaps(self, n: int = 10) -> List[list]:
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self.host_at((s + e) // 2), (e - s) / 1e9] for s, e in gaps]


class Tracer:
    """start() and end() bound the stretch; stop() ends the profiler once
    the program has gone quiet; read() after the run. Only the device's
    activities are recorded (CUPTI); the host's side of the timeline is the
    harness's own spans (``read(spans)``).

    The profiler is stopped only when no thread launches work: stopping it
    while the pool's thread replays a CUDA graph has hung the process on
    the card. What runs between end() and stop() is recorded and left out:
    the trace is read inside [start, end]."""

    def __init__(self):
        self._prof = None
        self.t0 = self.t1 = 0
        self._perf0 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        # a host without a card traces its CPU, which gives no device time
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU])
        self._prof.__enter__()
        self.t0, self._perf0 = time.time_ns(), time.perf_counter()

    def end(self) -> None:
        self.t1 = time.time_ns()

    def stop(self) -> None:
        self._prof.__exit__(None, None, None)

    def to_ns(self, t: float) -> int:
        """A perf_counter reading on the trace's clock."""
        return self.t0 + int((t - self._perf0) * 1e9)

    def read(self, spans=()) -> DeviceTrace:
        """The device activities; spans: the harness's (name, t0, t1)
        perf_counter spans, the host side of the timeline."""
        trace = DeviceTrace(self.t0, self.t1)
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type().name != "CPU":
                s = ev.start_ns()
                trace.device.append((ev.name(), s, s + ev.duration_ns()))
        trace.host = [(n, self.to_ns(a), self.to_ns(b)) for n, a, b in spans]
        self._prof = None
        return trace
