"""Kernels: the attention forward's share of its roofline, in %: the least
time the card could take for the encoders' and the prompts' attention
forward in the traced stretch (the larger of its FLOPs over the bf16 peak
and its bytes over the memory bandwidth), over the device time of the
launches that compute it, whatever kernel that is. NAMES, the data of this
metric, tells those launches by name and their instantiation (head dim,
causal): today the program's flash forward kernel, for CLIP's layers
(full, head dim 64), InternVideo2's (full, 88) and the language model's
prompts (causal, 96). A kernel that takes the work over leaves the metric
silent until a change to the benchmark adds its pattern. The work counted
is what the inputs need: the pairs a full or causal mask leaves, a
prompt's padding not counted (the shortest prompt the window finished,
where the mix left-pads to a bucket), each input byte read once and each
output written once. A launch of another instantiation counts its time
and no work. Moves requests_per_s."""

import re

PEAK_FLOPS = 989e12   # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
NAMES = (re.compile(r"flash_fwd_kernel<(\d+), *(true|false|1|0), *\d+>"),
         re.compile(r"flash_fwd_kernelILi(\d+)ELb([01])ELi\d+E"))


def instantiation(name):
    for pattern in NAMES:
        m = pattern.search(name)
        if m:
            return int(m.group(1)), m.group(2) in ("true", "1")
    return None


def attention(B, Sq, Sk, H, Hkv, D, pairs):
    flops = 4 * B * H * D * pairs
    nbytes = 2 * B * D * (2 * Sq * H + 2 * Sk * Hkv)
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def least_times(ctx):
    """(head dim, causal) → the least seconds of one launch."""
    conf = ctx.conf
    segs = conf["num_segs"]
    c, v, L = conf["clip"], conf["video"], conf["llm"]
    out = {}
    S = (c["image_size"] // c["patch_size"]) ** 2 + 1
    H = c["num_heads"]
    out[(c["hidden_size"] // H, False)] = attention(
        segs, S, S, H, H, c["hidden_size"] // H, S * S)
    S = 1 + v["num_frames"] * (v["image_size"] // v["patch_size"]) ** 2
    H = v["num_heads"]
    out[(v["embed_dim"] // H, False)] = attention(
        segs, S, S, H, H, v["embed_dim"] // H, S * S)
    if ctx.done:
        side = c["image_size"] // c["patch_size"] // 2
        nv = segs * (side * (side + 1) + conf["num_frames"] // segs
                     * conf["fusion"]["pool_side"] ** 2 + 1)
        if ctx.mix["server"]["prefix_cache"]:
            n = ctx.done[0]["pre"] + nv
        else:
            n = min(r["pre"] + nv + r["post"] for r in ctx.done)
        out[(L["head_dim"], True)] = attention(
            1, n, n, L["num_heads"], L["num_kv_heads"], L["head_dim"],
            n * (n + 1) // 2)
    return out


def read(ctx):
    if ctx.trace is None:
        return None
    least = least_times(ctx)
    launches = ctx.trace.kernels(lambda n: instantiation(n) is not None)
    if not launches:
        return None
    busy = sum(e - s for _, s, e in launches) / 1e9
    need = sum(least.get(instantiation(n), 0.0) for n, _, _ in launches)
    return 100.0 * need / busy
