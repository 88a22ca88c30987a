"""Scheduler: the mean wall time of one admission into the decode pool
(prefill, first token, slot insert), in ms: the pool's own counters
``admit`` / ``admissions`` (ContinuousServer.timings; each admission ends
on its first token's fetch) over the window. Moves latency_p90_s."""


def read(ctx):
    n = ctx.counters.get("admissions", 0)
    if not n:
        return None
    return 1000.0 * ctx.counters["admit"] / n
