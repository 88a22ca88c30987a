"""Spawn a gloo process group on the CPU: the port's counterpart of the JAX
package's virtual CPU devices, for the dry run and the tests.

``spawn(fn, world, *args)`` starts ``world`` processes; each sets one
thread, joins a gloo group over a FileStore in a fresh temporary directory
(no TCP port, so concurrent groups cannot collide) and returns
``fn(rank, world, *args)``; the call returns every rank's result in rank
order. A rank that raises fails the call with its traceback. Both the
group's collectives and the join have a timeout, so a hung rank fails the
call instead of blocking it.
"""

from __future__ import annotations

import os
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, root, collective_timeout, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=collective_timeout))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(root, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout: float = 120.0,
          collective_timeout: float = 30.0):
    """→ [fn(rank, world, *args) for each rank], run in ``world`` spawned
    processes of one gloo group. fn must be importable by name (a module's
    top-level function); results travel back through torch.save."""
    with tempfile.TemporaryDirectory(prefix="gvllm_gloo_") as root:
        ctx = mp.start_processes(
            _entry, args=(fn, world, root, collective_timeout, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} gloo ranks still running "
                                       f"after {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(root, f"result{r}.pt"),
                           weights_only=False) for r in range(world)]
