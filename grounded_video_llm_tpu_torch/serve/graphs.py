"""Step graphs: the port's counterpart of ``jax.jit`` over a loop body.

The JAX package runs each serving loop (the decode ``while_loop``, the
draft / verify loops, the pool's decode and speculative chunks, the beam
loop) as one compiled device program. The port keeps the loops on the host
and runs each loop body through ``StepGraphs``: a step function over a fixed
set of **state tensors** (cache buffers, valid mask, positions, tokens, a
device step counter, done flags), written in place.

    graphs = StepGraphs()
    loop = graphs.loop(key, state, body, refs=(params, cfg, generator))
    while loop.read(loop.state.live):
        loop.step()

``loop`` returns the key's entry. A first use of a key takes ``state`` as
the entry's own (the runner owns those tensors from then on); a later use
copies the values of ``state`` into the entry's tensors, so a captured graph
reads and writes the same memory on every call. The key is the caller's
tuple, the ids of ``refs`` (objects the body closes over, kept alive by the
entry so that their ids stay theirs) and the names, shapes and dtypes of
the state tensors: what fixes the captured shapes and branches.

On the card the first step of a key runs eagerly on a side stream: it is
the loop's real first step (it advances the state), and it builds the
kernels and sets their attributes before any capture. The next step
captures the body into a CUDA graph, which executes nothing and leaves the
state as it was, and replays it; every later step of the key replays. The
graphs of one runner share one memory pool (``torch.cuda.graph_pool_handle``)
and live as long as the runner: an engine or a pool owns one. It keeps at
most ``MAX_ENTRIES`` keys, and an engine's at most ``max_state_bytes`` of
state tensors (least recently used first out); a state larger than that
alone (a full-width beam cache) serves its own call and goes with it.

On the CPU every step calls the body on the same state tensors, so the
tests run the code that the card captures. Only capture and replay are
CUDA-only.

Guards, on both devices: before each step the entry holds every state
tensor's ``data_ptr()``, shape and dtype against the ones it was bound to,
and after each step it checks that the body returned the very same tensors
(a body writes in place; ``assign`` copies freshly computed values into the
state). Any difference raises ``StateRebound`` with the key and the
tensor's name: a captured step that read a stale buffer would be silent.

Launch counters count device launches. The kernel wrappers count on the
host, once per call, so a capture moves each counter once; the entry
records each counter's change over the capture (``LaunchBook``), restores
the counter and adds the change on every replay.

No fallback: on the card a capture or replay that fails raises, and the
eager loop is reached only through ``StepGraphs.eager()``, the switch the
comparison legs of chip_smoke.py and the tests use. A capture of a tree
with sharded leaves (serving on a device mesh runs collectives in every
layer) is refused on the card: such a tree serves there inside eager().
"""

from __future__ import annotations

import contextlib
import time
import weakref
from collections import OrderedDict
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch

from ..ops import cuda_build
from ..parallel.partitioning import is_sharded


class StateRebound(RuntimeError):
    """A state tensor of a step graph is not the one the key was bound to."""


def leaves(state, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """The named tensors of a state: fields of NamedTuples and items of
    tuples, nested; fields that are no tensor (None, ints) are not state."""
    if isinstance(state, torch.Tensor):
        return [(prefix or "state", state)]
    out: List[Tuple[str, torch.Tensor]] = []
    if hasattr(state, "_fields"):
        for name in state._fields:
            out += leaves(getattr(state, name),
                          f"{prefix}.{name}" if prefix else name)
    elif isinstance(state, tuple):
        for i, item in enumerate(state):
            out += leaves(item, f"{prefix}[{i}]")
    return out


def assign(dst, src):
    """Copy every tensor of src into the tensor at the same place of dst
    (one that already is that tensor is skipped) → dst. A body computes its
    next state as the JAX body does and hands it to assign, so the state
    stays in the captured tensors."""
    for (name, d), (_, s) in zip(leaves(dst), leaves(src), strict=True):
        if s is not d:
            if s.shape != d.shape:
                raise StateRebound(f"{name}: a step made {tuple(s.shape)} "
                                   f"for a state tensor of {tuple(d.shape)}")
            d.copy_(s)
    return dst


def _signature(named) -> tuple:
    return tuple((n, t.data_ptr(), tuple(t.shape), t.dtype) for n, t in named)


def _nbytes(entries) -> int:
    """The bytes of the distinct state tensors of some entries (a pool's
    chunk keys share the pool's)."""
    seen = {}
    for e in entries:
        for _, t in leaves(e.state):
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def _sharded(tree) -> bool:
    if isinstance(tree, dict):
        return any(_sharded(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_sharded(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return is_sharded(tree)
    # Int8Weight / Int8Embedding: their q and scale
    return any(is_sharded(getattr(tree, a, None)) for a in ("q", "scale"))


class LaunchBook:
    """The launch counters of the kernel wrappers (objects with an int
    ``launches``; default: every ``cuda_build.CudaKernel``)."""

    def __init__(self, counters: Optional[Sequence] = None):
        self.counters = cuda_build.REGISTRY if counters is None else counters

    def measure(self, fn: Callable[[], None]) -> Tuple[int, ...]:
        """Run fn (a capture) → each counter's change over it; the counters
        are restored, as a capture launches nothing."""
        counters = list(self.counters)
        before = [k.launches for k in counters]
        try:
            fn()
        finally:
            delta = tuple(k.launches - b for k, b in zip(counters, before))
            for k, b in zip(counters, before):
                k.launches = b
        return delta

    def add(self, delta: Tuple[int, ...]) -> None:
        """What one replay launched: delta, added to the counters."""
        for k, d in zip(list(self.counters), delta):
            k.launches += d


class StepLoop:
    """One key's entry: the state tensors, the step bodies (one, or one per
    variant, such as the beam's two directions of its buffer swap) and, on
    the card once captured, a CUDA graph per body."""

    def __init__(self, runner: "StepGraphs", key: tuple, state, refs):
        # weak: the runner holds its entries, and an engine's memory must go
        # with the engine, not wait for the cycle collector
        self._runner = weakref.ref(runner)
        self.key = key
        self.state = state
        self.refs = refs            # keeps the ids in the key theirs
        self.bodies: Tuple[Callable, ...] = ()
        self.generator: Optional[torch.Generator] = None
        self.sig = _signature(leaves(state))
        self.cuda = any(t.is_cuda for _, t in leaves(state))
        self.warm: set = set()      # bodies whose first (eager) step ran
        self.graphs: dict = {}      # body index → torch.cuda.CUDAGraph
        self.deltas: dict = {}      # body index → counter changes a replay

    def _check(self, named, when: str) -> None:
        if [n for n, _ in named] != [s[0] for s in self.sig]:
            raise StateRebound(
                f"step graph {self.key[0]}: the state {when} has the tensors "
                f"{[n for n, _ in named]}, bound {[s[0] for s in self.sig]}")
        for (n, ptr, shape, dtype), (_, t) in zip(self.sig, named):
            if (t.data_ptr(), tuple(t.shape), t.dtype) != (ptr, shape, dtype):
                raise StateRebound(
                    f"step graph {self.key[0]}: state tensor {n!r} {when} "
                    f"is not the one the key was bound to ({tuple(t.shape)} "
                    f"{t.dtype} at {t.data_ptr():#x}, bound {shape} {dtype} "
                    f"at {ptr:#x})")

    def _eager(self, i: int) -> None:
        out = self.bodies[i](self.state)
        self._check(leaves(out), "after a step")

    def step(self, i: int = 0) -> None:
        """One step of body i: eager (the CPU, the eager switch, the body's
        first step on the card), else capture once and replay."""
        self._check(leaves(self.state), "before a step")
        r = self._runner()
        if not self.cuda or not r.capture:
            self._eager(i)
            r.stats["eager_steps"] += 1
            return
        if i not in self.warm:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._eager(i)
            torch.cuda.current_stream().wait_stream(side)
            self.warm.add(i)
            r.stats["eager_steps"] += 1
            return
        if i not in self.graphs:
            self._capture(i)
        self.graphs[i].replay()
        r.book.add(self.deltas[i])
        r.stats["replays"] += 1

    def _capture(self, i: int) -> None:
        r = self._runner()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self.generator is not None and self.generator.device.type == \
                "cuda":
            graph.register_generator_state(self.generator)

        def record():
            # thread_local: other threads (a server's request staging) may
            # allocate and copy while this one captures
            with torch.cuda.graph(graph, pool=r.pool,
                                  capture_error_mode="thread_local"):
                self._eager(i)

        try:
            delta = r.book.measure(record)
            graph.instantiate()
        except BaseException:
            r._entries.pop(self.key, None)
            raise
        torch.cuda.synchronize()
        self.graphs[i], self.deltas[i] = graph, delta
        r.stats["captures"] += 1
        r.stats["capture_ms"] += (time.perf_counter() - t0) * 1e3

    def read(self, flag: torch.Tensor) -> bool:
        """A one-element device flag on the host: on the card through a
        pinned scalar and an event queued behind the last step."""
        if not flag.is_cuda:
            return bool(flag)
        r = self._runner()
        if r._pinned is None:
            r._pinned = torch.empty((), dtype=torch.bool, pin_memory=True)
            r._event = torch.cuda.Event()
        r._pinned.copy_(flag.reshape(()), non_blocking=True)
        r._event.record()
        r._event.synchronize()
        return bool(r._pinned)


class StepGraphs:
    """The step-graph runner of one engine or pool (see the module
    docstring). ``stats``: captures, capture_ms, replays and eager_steps;
    ``pool_bytes()`` the graphs' shared memory pool."""

    # keys an engine or pool keeps: a serving loop uses one or two at a time
    # (the pool's chunk and chunk_long), and each holds its state tensors
    MAX_ENTRIES = 4
    # an engine's kept state: mode A's int8 cache at B=6 and 3,840 slots is
    # 4.7 GB, a bf16 beam cache at K=4 with its spare 11.5 GB
    ENGINE_STATE_BYTES = 8 << 30

    def __init__(self, max_state_bytes: Optional[int] = ENGINE_STATE_BYTES,
                 counters: Optional[Sequence] = None):
        """max_state_bytes: None for a pool, whose state is its own."""
        self.max_state_bytes = max_state_bytes
        self.book = LaunchBook(counters)
        self.capture = True
        self._entries: "OrderedDict[tuple, StepLoop]" = OrderedDict()
        self._pool = None
        self._pinned = None
        self._event = None
        self.stats = dict(captures=0, capture_ms=0.0, replays=0,
                          eager_steps=0)

    @property
    def pool(self):
        # the allocator frees a pool with the last graph captured into it
        # (a cleared or evicted runner); a capture into a handle whose pool
        # is gone trips its assert, so it starts a new pool
        if self._pool is None or not any(e.graphs
                                         for e in self._entries.values()):
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def pool_bytes(self) -> int:
        """The bytes of the allocator's segments in this runner's pool (a
        memory snapshot: tens to hundreds of ms, not for a serving loop)."""
        if self._pool is None:
            return 0
        want = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == want)

    @contextlib.contextmanager
    def eager(self):
        """The eager loop on the card: no capture, no replay while inside
        (the comparison legs' switch)."""
        prev, self.capture = self.capture, False
        try:
            yield self
        finally:
            self.capture = prev

    def loop(self, key: tuple, state, body, *,
             refs: Iterable = (), params=None,
             generator: Optional[torch.Generator] = None) -> StepLoop:
        """The entry of (key, refs, state's tensor shapes): a first use
        owns ``state``; a later one copies state's values into the entry's
        tensors. body(state) → state is this call's step (or a tuple of
        bodies, stepped by index); generator: the sampling draws' (registered
        with the graph on the card); params: the tree the body reads,
        refused on the card if sharded, unless the runner is eager()."""
        named = leaves(state)
        refs = tuple(refs)
        full = (tuple(key), tuple(id(r) for r in refs),
                tuple((n, tuple(t.shape), t.dtype, t.device)
                      for n, t in named))
        entry = self._entries.get(full)
        if entry is None:
            if (self.capture and params is not None
                    and any(t.is_cuda for _, t in named)
                    and _sharded(params)):
                raise NotImplementedError(
                    "step graphs do not capture collectives: a tree with "
                    "sharded leaves serves on the card only inside "
                    "StepGraphs.eager()")
            entry = StepLoop(self, full, state, refs)
            budget = self.max_state_bytes
            if budget is None or _nbytes([entry]) <= budget:
                self._entries[full] = entry
                while len(self._entries) > self.MAX_ENTRIES or (
                        budget is not None
                        and _nbytes(self._entries.values()) > budget):
                    self._entries.popitem(last=False)
        else:
            self._entries.move_to_end(full)
            assign(entry.state, state)
        entry.bodies = tuple(body) if isinstance(body, (tuple, list)) \
            else (body,)
        entry.generator = generator
        return entry

    def clear(self) -> None:
        """Drop every entry: graphs and state tensors (the pool's memory
        goes with the last graph)."""
        self._entries.clear()

    def loops(self) -> List[StepLoop]:
        """The entries, least recently used first."""
        return list(self._entries.values())
