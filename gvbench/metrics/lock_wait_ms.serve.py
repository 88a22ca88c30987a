"""Front end: the mean wait of one ``ServingFrontend.submit`` for the
frontend's lock, in ms: the program's counters ``lock_wait`` / ``submits``
(``ContinuousServer.timings``) over the window. The wait is what a client's
latency pays for the other clients' holds. Moves latency_p90_s."""


def read(ctx):
    n = ctx.counters.get("submits", 0)
    if not n or "lock_wait" not in ctx.counters:
        return None
    return 1000.0 * ctx.counters["lock_wait"] / n
