"""Feature and prefix caches: the share of the feature LRU's lookups
(``InferenceEngine.encode_video_cached``) that found a video's features,
each a resize and an encode saved, in %: the program's counters
``feature_hits`` / ``feature_lookups`` over the window. Moves
requests_per_s."""


def read(ctx):
    n = ctx.counters.get("feature_lookups", 0)
    if not n:
        return None
    return 100.0 * ctx.counters.get("feature_hits", 0) / n
