"""Front end: the mean wall time of one ``ServingFrontend.submit`` that
ended in the window, in ms (the harness's span: the frontend's lock wait,
the host resize, the encode or the feature cache, the prefix build or its
cache, tokenization). Moves latency_p90_s."""


def read(ctx):
    spans = ctx.in_window("submit")
    if not spans:
        return None
    return 1000.0 * sum(t1 - t0 for _, t0, t1 in spans) / len(spans)
