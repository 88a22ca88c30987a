"""Scheduler: the share of the slot-steps the pool computed that carried a
live request, in %: the program's counters ``slot_tokens`` (the tokens the
read chunks gave live requests, an EOS included) / (``timed_steps`` × the
mix's ``pool_size``) over the window. Every chunk decodes the whole pool,
so the rest is decode work for empty slots. Moves requests_per_s."""


def read(ctx):
    steps = ctx.counters.get("timed_steps", 0)
    if not steps or "slot_tokens" not in ctx.counters:
        return None
    return (100.0 * ctx.counters["slot_tokens"]
            / (steps * ctx.mix["server"]["pool_size"]))
