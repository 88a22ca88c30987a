"""Timing for the port's microbenchmarks: CUDA-event time of R back-to-back
launches (the counterpart of the TPU scripts' R iterations chained inside
one jit), TF/s and GB/s beside the milliseconds, and the card's name and
power limit on every printed line (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``)."""

from __future__ import annotations

import subprocess
from typing import Callable, Optional

import torch


def require_cuda() -> torch.device:
    """The card; raises where there is none (no CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the microbenchmarks time the card: no CUDA device")
    return torch.device("cuda")


def card() -> str:
    """'<name>, <power limit>' of card 0, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


def device_ms(fn: Callable[[], object], reps: int,
              graph: bool = False) -> float:
    """Milliseconds per call of fn(): one warm-up call, then ``reps`` calls
    back to back between two CUDA events. graph=True captures the reps
    calls in one CUDA graph and times its replay instead, so the host's
    launch cost (the Python wrappers) is left out."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def report(name: str, ms: float, card_name: str, *,
           flops: Optional[float] = None,
           nbytes: Optional[float] = None, width: int = 22) -> dict:
    """Print one variant's line and return its numbers."""
    row = {"name": name, "ms": ms}
    line = f"{name:{width}s} {ms:9.4f} ms"
    if flops is not None:
        row["tflops"] = flops / ms / 1e9
        line += f"  {row['tflops']:8.1f} TF/s"
    if nbytes is not None:
        row["gbs"] = nbytes / ms / 1e6
        line += f"  {row['gbs']:8.1f} GB/s"
    print(f"{line}  [{card_name}]", flush=True)
    return row
