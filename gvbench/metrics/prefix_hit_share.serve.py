"""Feature and prefix caches: the share of the prefix-KV LRU's lookups
(``InferenceEngine.prefix_kv_cached``) that found a video's prefix K/V, each
a 3.5k-token prefill saved, in %: the program's counters ``prefix_hits`` /
``prefix_lookups`` over the window. Read where the mix serves from
prefixes. Moves requests_per_s."""


def read(ctx):
    n = ctx.counters.get("prefix_lookups", 0)
    if not n:
        return None
    return 100.0 * ctx.counters.get("prefix_hits", 0) / n
