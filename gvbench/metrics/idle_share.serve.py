"""Device: the share of the traced stretch in which no kernel, copy or set
ran on the card, in % (torch.profiler's device activities, merged). Moves
requests_per_s."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
