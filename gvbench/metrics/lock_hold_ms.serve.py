"""Front end: the mean hold of the frontend's lock by one
``ServingFrontend.submit`` (the host resize, the encode or the feature
cache, the prefix build or its cache, tokenization), in ms: the program's
counters ``lock_hold`` / ``submits`` over the window. With the lock never
free, the rate is one request a hold. Moves requests_per_s."""


def read(ctx):
    n = ctx.counters.get("submits", 0)
    if not n or "lock_hold" not in ctx.counters:
        return None
    return 1000.0 * ctx.counters["lock_hold"] / n
