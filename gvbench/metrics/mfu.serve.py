"""Model step: the model FLOPs of the work the window finished, over the
window times the card's peak, in %. The count is the benchmark's own, from
the configuration's shapes and the traffic's counts: each encode that ended
in the window (both encoders and the projectors), each prefix build that
ended in it, and for each request finished in it the prompt it admitted
(only the question against a prefix where the mix serves from prefixes)
and the tokens it decoded. A product counts 2 FLOPs a multiply-add;
attention counts the pairs a causal or full mask leaves; embeddings and
softmaxes count nothing. Moves requests_per_s."""

PEAK_FLOPS = 989e12   # H100 SXM, dense bf16 (NVIDIA data sheet)


def llm_linear(c):
    """Weight FLOPs of one token through every decoder layer."""
    H, I, L = c["hidden_size"], c["intermediate_size"], c["num_layers"]
    q = c["num_heads"] * c["head_dim"]
    kv = c["num_kv_heads"] * c["head_dim"]
    return 2 * L * (H * (q + 2 * kv) + q * H + H * 2 * I + I * H)


def lm_head(c):
    return 2 * c["hidden_size"] * (c["vocab_size"] + c["num_extra_tokens"])


def attn_pair(c):
    """FLOPs of one (query, key) pair over every layer: q.k and p.v."""
    return 4 * c["num_layers"] * c["num_heads"] * c["head_dim"]


def causal_pairs(n):
    return n * (n + 1) // 2


def prefill(c, n):
    """A prompt of n tokens and its first token's logits."""
    return n * llm_linear(c) + attn_pair(c) * causal_pairs(n) + lm_head(c)


def prefill_after(c, prefix, q):
    """q question tokens against a prefix of ``prefix`` tokens."""
    return (q * llm_linear(c) + attn_pair(c) * (q * prefix + causal_pairs(q))
            + lm_head(c))


def decode(c, context, m):
    """The m - 1 steps that give tokens 2..m after a prompt of ``context``
    tokens (step j attends context + j keys)."""
    steps = max(m - 1, 0)
    return (steps * (llm_linear(c) + lm_head(c))
            + attn_pair(c) * (steps * context + steps * (steps + 1) // 2))


def video_tokens(conf):
    segs = conf["num_segs"]
    side = conf["clip"]["image_size"] // conf["clip"]["patch_size"] // 2
    per_clip = conf["num_frames"] // segs * conf["fusion"]["pool_side"] ** 2
    return segs * (side * (side + 1) + per_clip + 1)


def encode(conf):
    """One video: CLIP to its penultimate layer on each segment's frame,
    InternVideo2 to its last block used on each clip, the projectors."""
    segs = conf["num_segs"]
    H = conf["llm"]["hidden_size"]
    c = conf["clip"]
    C, Ic = c["hidden_size"], c["intermediate_size"]
    n = (c["image_size"] // c["patch_size"]) ** 2
    S = n + 1
    patch = 3 * c["patch_size"] ** 2
    layers = c["num_layers"] + c["feature_layer"] + 1
    clip = segs * (2 * patch * C * n + layers * (
        S * 2 * (4 * C * C + 2 * C * Ic) + 4 * C * S * S))
    v = conf["video"]
    D = v["embed_dim"]
    Iv = int(D * v["mlp_ratio"])
    T = v["num_frames"]
    P = (v["image_size"] // v["patch_size"]) ** 2
    Sv = 1 + T * P
    patch = 3 * v["patch_size"] ** 2
    iv2 = segs * (2 * patch * D * T * P + v["num_blocks_used"] * (
        Sv * 2 * (3 * D * D + D * D + 2 * D * Iv) + 4 * D * Sv * Sv))
    side = c["image_size"] // c["patch_size"] // 2
    mm = (segs * side * (side + 1) + 1) * 2 * (4 * C * H + H * H)
    vp = segs * T * conf["fusion"]["pool_side"] ** 2 * 2 * (D * H + H * H)
    return clip + iv2 + mm + vp


def work(ctx):
    conf, c = ctx.conf, ctx.conf["llm"]
    nv = video_tokens(conf)
    total = len(ctx.in_window("encode")) * encode(conf)
    prefixed = ctx.mix["server"]["prefix_cache"]
    for r in ctx.done:
        n = r["pre"] + nv + r["post"]
        if prefixed:
            total += prefill_after(c, r["pre"] + nv, r["post"])
        else:
            total += prefill(c, n)
        total += decode(c, n, r["served"])
    if prefixed:
        pre = ctx.done[0]["pre"] if ctx.done else 0
        total += len(ctx.in_window("prefix")) * (
            prefill(c, pre + nv) - lm_head(c))
    return total


def read(ctx):
    if not ctx.done or ctx.window_s <= 0:
        return None
    return 100.0 * work(ctx) / (ctx.window_s * PEAK_FLOPS)
