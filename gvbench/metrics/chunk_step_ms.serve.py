"""Scheduler and model step: the device time of one pool-wide decode step,
in ms: the pool's own counters ``chunk_device_ms`` (CUDA events around each
chunk's launches) / ``timed_steps`` over the window. Moves
requests_per_s."""


def read(ctx):
    n = ctx.counters.get("timed_steps", 0)
    if not n or "chunk_device_ms" not in ctx.counters:
        return None
    return ctx.counters["chunk_device_ms"] / n
