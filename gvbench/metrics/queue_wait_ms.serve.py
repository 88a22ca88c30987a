"""Scheduler: the mean time a request waits in ``ContinuousScheduler``'s
queue, from its put to the start of its admission, in ms: the program's
counters ``queue_wait`` / ``admissions`` over the window. Moves
latency_p90_s."""


def read(ctx):
    n = ctx.counters.get("admissions", 0)
    if not n or "queue_wait" not in ctx.counters:
        return None
    return 1000.0 * ctx.counters["queue_wait"] / n
