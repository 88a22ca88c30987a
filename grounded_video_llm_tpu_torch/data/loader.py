"""Resumable, prefetching data loader (a copy of the framework-free
grounded_video_llm_tpu/data/loader.py; tests/test_torch_shared_modules.py
holds it to the original).

The reference uses DistributedSampler + StatefulDataLoader (reference
training/base_strategy.py:184-220): epoch-seeded shuffle, per-rank sharding,
and a snapshot that restores mid-epoch position on resume. This loader keeps
those semantics — deterministic epoch permutation from (seed, epoch), samples
sharded by rank, `state_dict()/load_state_dict()` for exact mid-epoch
resume — and adds a background thread pool so video decode overlaps with
device compute (the reference gets this from DataLoader workers; SURVEY §2.7 notes
its rank-dependent num_workers quirk, which is NOT reproduced).

One difference from the original: every shard gets n // (num_shards *
batch_size) batches, as DistributedSampler(drop_last=True) gives each rank
n // num_shards samples. The original keeps len(shard) // batch_size, one
batch more on some shards when num_shards does not divide n, and a rank
that took one step more than the others would wait in that step's
collectives until the group timed out."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np


class ShardedSampler:
    """Deterministic epoch permutation, sharded across ranks, drop_last;
    the same number of batches on every shard."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_shards: int = 1, shard_id: int = 0):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id

    def epoch_indices(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(self.n)
        else:
            order = np.arange(self.n)
        shard = order[self.shard_id::self.num_shards]
        n_batches = self.n // (self.num_shards * self.batch_size)
        return shard[:n_batches * self.batch_size].reshape(
            n_batches, self.batch_size)


class DataLoader:
    """Iterates collated batches with background prefetch and resume state."""

    def __init__(self, dataset, collate_fn: Callable, batch_size: int,
                 shuffle: bool = True, seed: int = 0, num_shards: int = 1,
                 shard_id: int = 0, num_workers: int = 2,
                 prefetch_depth: int = 2):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.sampler = ShardedSampler(len(dataset), batch_size, shuffle, seed,
                                      num_shards, shard_id)
        self.num_workers = max(num_workers, 1)
        self.prefetch_depth = prefetch_depth
        self.epoch = 0
        self.batch_in_epoch = 0

    # -- resume (StatefulDataLoader-equivalent, base_strategy.py:124-176) ----

    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "batch_in_epoch": self.batch_in_epoch,
                "seed": self.sampler.seed}

    def load_state_dict(self, state: Dict) -> None:
        self.epoch = int(state["epoch"])
        self.batch_in_epoch = int(state["batch_in_epoch"])
        self.sampler.seed = int(state["seed"])

    def batches_per_epoch(self) -> int:
        return self.sampler.epoch_indices(0).shape[0]

    # -- iteration -----------------------------------------------------------

    def _load_batch(self, idx_row: np.ndarray):
        if hasattr(self.dataset, "set_epoch_rng"):
            pass  # per-item rng installed below for determinism
        samples = [self.dataset[int(i)] for i in idx_row]
        return self.collate_fn(samples)

    def epoch_iterator(self) -> Iterator:
        """Yield the remaining batches of the current epoch, prefetched."""
        plan = self.sampler.epoch_indices(self.epoch)
        start = self.batch_in_epoch
        rows = list(plan[start:])
        if not rows:
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def producer():
            for row in rows:
                if stop.is_set():
                    return
                try:
                    q.put(self._load_batch(row))
                except Exception as e:  # surface in consumer
                    q.put(e)
                    return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                # count BEFORE yielding: the generator suspends at yield, so a
                # post-yield increment wouldn't be reflected in state_dict()
                # until the consumer asks for the next batch
                self.batch_in_epoch += 1
                yield item
        finally:
            stop.set()
        self.epoch += 1
        self.batch_in_epoch = 0
