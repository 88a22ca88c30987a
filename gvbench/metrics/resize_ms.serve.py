"""Host preprocess: the mean wall time of the engine's
``preprocess_frames`` (the PIL-exact resize of one video's frames to both
streams) inside the harness's video hook, in ms a video, over the calls
that ended in the window. Moves latency_p90_s."""


def read(ctx):
    spans = ctx.in_window("resize")
    if not spans:
        return None
    return 1000.0 * sum(t1 - t0 for _, t0, t1 in spans) / len(spans)
