#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (grounded_video_llm_tpu_torch) on one
NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py            # full run, one card, exits 0 on success

Phases, each printed on its own lines; any failure raises (exit code != 0):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the build: every kernel source in csrc/, one nvcc each, all at once;
   ptxas registers and spills per kernel;
3. each kernel against its plain PyTorch version at the serving path's
   shapes, with its error against a bound and CUDA-event medians of the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call, next to the least time the card could take (the
   int8 kernels' device times come from CUDA-graph replays, so the Python
   wrappers' launch cost is left out and printed beside them):
   flash_fwd (K1/K2: CLIP, InternVideo2 bounded, prefill causal, B=2
   left-padded, edge cases); flash_bwd (K7: the grounded training shape
   [1, 7515, 32, 96] causal with a right-padded mask, its plain version run
   kv head by kv head, the SDPA backward beside it; B=2 with right
   paddings; GQA with 8 kv heads of 128, non-causal D=88, a window, an
   explicit q_offset, left padding with dead rows whose dq must be exactly
   0); the one int8_matmul wrapper over its two
   kernels, w8a8 (int8_gemv, K3's w8a8 branch) and weight-only (int8_matmul,
   K6 and K3's weight-only branch): both at M 1 and 6 on the four Phi-3.5
   projections, weight-only also at M 1, 6, 255 on O 9216 and the lm_head's
   32,366; decode_attention_int8 (K4: B 1 and 6, 32 heads of 96, 3,840
   slots, ragged masks; a GQA case with 8 kv heads of 128) and
   scatter_write (K5: ragged slots, untouched bytes, same storage);
4. small references, a depth-cut full-width model on the card (kernels)
   against the same weights on the host (plain versions): bf16 (card) vs
   fp32 (host), then int8 and int8_full with the int8 cache (same int8
   weights on both sides): video features, prefill logits, one decode
   step's logits; then one grounded training microbatch with LoRA
   attached (B != 0): the loss and every trainable leaf's gradient;
5. the main path, full-width Phi-3.5 (vlm_config("phi3.5",
   stage="inference"), seeded random weights) on one seeded synthetic
   96-frame video resized once: a bf16 request, then the int8 modes through
   InferenceEngine.generate, greedy, 32 new tokens:
     A  quantize="int8_full", int8 KV cache, B = 6 prompts (each of the three
        modes twice, different text, ragged left padding);
     B  quantize="int8", int8 KV cache, B = 1;
     C  quantize="int8", bf16 KV cache, B = 1.
   Each path runs with every launch count set to 0 just before it; its
   counts are read just after and held against the counts the config
   implies. Phase times, peak device memory, and a shape/finiteness check of
   the features and logits;
6. the training path on the same weights: vlm_config("phi3.5",
   stage="grounded") at full width, LoRA r=128 attached, the grounded
   preset at a global batch of 2 in microbatches of 1 (grad_accum 2),
   LoRA dropout 0.05, remat on, four synthetic grounded samples each
   truncated at 4096 text tokens (spliced length 7,515), two optimizer
   steps through TrainingStrategy.run_training: per step loss, grad_norm,
   seconds, peak memory; the first step must change nothing (lr 0), the
   second move every trainable leaf, no frozen leaf may change by a bit,
   and the launch counts must be the config's (per microbatch flash_fwd
   23 + 39 + 32 + 32 for the remat recompute, flash_bwd 32); a phase split
   of one more microbatch and the model-FLOP share.

The last three lines are the card, one JSON object describing the kernels,
and {"ok": true, "device": {...}}. Without a CUDA device the script exits
with code 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
MAX_NEW_TOKENS = 32
BOUND_O = 2e-2      # max |o_kernel - o_plain|: bf16 P and bf16 output
BOUND_O_REL = 5e-3  # ||do|| / ||o_plain||; measured 1.9e-3 to 2.4e-3
BOUND_LSE = 1e-3    # max |lse_kernel - lse_plain|: fp32 row statistics
# K7 vs its plain version (same bf16 inputs, the same bf16 roundings of P
# and dS, fp32 sums in another order): ||dX - dX_plain|| / ||dX_plain|| for
# dq, dk and dv; measured at most 1.8e-4, 3.0e-4 and 3.8e-4 over every
# case (H100), so 5x the worst. A kernel that skips a k tile moves the sums
# by the share of the softmax weight it drops, far more.
BOUND_BWD_REL = (2e-3, 2e-3, 2e-3)
BOUND_SMALL = 3e-2  # relative L2, card path vs host path
# one training microbatch, card bf16 vs host fp32 (depth-cut model);
# measured 2.3e-6 on the loss and at most 2.1e-2 on a gradient (H100):
BOUND_TRAIN_LOSS = 1e-3    # relative difference of the loss
BOUND_TRAIN_GRAD = 1e-1    # relative L2 of each trainable leaf's gradient
# the same with W8A8 activations: a row is rounded to 1/254 of its absmax,
# so a sum-order difference that moves one quotient across a .5 boundary
# costs that much, where bf16 alone costs 1/256 of the element
BOUND_SMALL_W8A8 = 1e-1
# int8 kernels vs their plain versions (same roundings, other sum order):
BOUND_GEMV = 2 ** -7   # max |dy| / max |y|: fp32 sums in another order
#                        move a bf16 rounding by one ulp (2**-8 relative)
# decode attention: the same roundings, fp32 sums in another order. Those
# move a bf16 output by one ulp where they cross a rounding boundary, so a
# (batch row, head) output vector moves by at most 2**-7 of its norm and the
# whole output far less. A kernel that drops slots moves each row it touches
# by about the share of the softmax weight it drops.
BOUND_ATTN_REL = 2e-3      # ||do|| / ||o_plain||
BOUND_ATTN_ROW = 2 ** -7   # the same per (batch row, head), at most
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, bf16 and int8 ops/s
HBM_BPS, BF16_OPS, INT8_OPS = 3.35e12, 989e12, 1979e12
PKG = "grounded_video_llm_tpu_torch"
SOURCES = {
    "flash_fwd": f"{PKG}/csrc/flash_fwd.cu",
    "flash_bwd": f"{PKG}/csrc/flash_bwd.cu",
    "int8_gemv": f"{PKG}/csrc/int8_matmul.cu",
    "int8_matmul": f"{PKG}/csrc/int8_matmul.cu",
    "decode_attention_int8": f"{PKG}/csrc/decode_attention_int8.cu",
    "scatter_write": f"{PKG}/csrc/cache_write.cu",
}
REPLACES = {
    "flash_fwd": "grounded_video_llm_tpu/ops/flash_attention.py:53 "
                 "(_fwd_kernel) + :140 (_fwd_kernel_causal), pallas_call "
                 "at :299",
    "flash_bwd": "grounded_video_llm_tpu/ops/flash_attention.py:515 "
                 "(_bwd_dq_kernel :326) + :534 (_bwd_dkv_kernel :389), "
                 "driven by _flash_bwd :462",
    "int8_gemv": "grounded_video_llm_tpu/ops/int8_matmul.py:151 "
                 "(int8_matmul_layer, pallas_call; kernel at :132), its "
                 "w8a8 branch (:136-145)",
    "int8_matmul": "grounded_video_llm_tpu/ops/int8_matmul.py:192 "
                   "(int8_matmul, pallas_call; _mm_kernel at :35) and the "
                   "weight-only branch of :151 (:146-149)",
    "decode_attention_int8": "grounded_video_llm_tpu/ops/"
                             "decode_attention_int8.py:489 "
                             "(decode_attention_int8_layer) + :208 "
                             "(decode_attention_int8); _kernel at :74",
    "scatter_write": "grounded_video_llm_tpu/ops/cache_write.py:60 "
                     "(scatter_write_kv) + :194 (scatter_write_scale)",
}
MODES = (
    ("grounding", "Give you a textual query: 'The female host wearing purple "
     "clothes is reporting news in the studio'. When does the described "
     "content occur in the video? Please return the start and end "
     "timestamps."),
    ("qa", "Question: What does this TV news report about?\nOptions:\n(A) "
     "thievery\n(B) community violence incidents\n(C) fashion show\n(D) "
     "aging population"),
    ("referring", "What is happening from 70 seconds to 80 seconds?"),
)
# the second prompt of each mode in the B = 6 batch
MODES_2 = (
    ("grounding", "Give you a textual query: 'A man opens the door'. When "
     "does it happen?"),
    ("qa", "Question: Where does this take place?\nOptions:\n(A) a studio\n"
     "(B) a street"),
    ("referring", "What is happening from 10 seconds to 25 seconds in this "
     "clip of the evening news?"),
)


def log(*args):
    print(*args, flush=True)


def synthetic_video(seed: int, n_frames: int, h: int = 240, w: int = 320):
    """Seeded uint8 frames [F, h, w, 3]: a smooth moving pattern plus noise,
    so the resize and both encoders see structured content."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    for t in range(n_frames):
        for c in range(3):
            wave = np.sin(xx / (17.0 + 5 * c) + yy / 23.0 + 0.2 * t + phase[c])
            frames[t, :, :, c] = np.clip(
                127.5 + 90 * wave + rng.normal(0, 12, size=(h, w)), 0, 255)
    return frames


def cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of fn() over reps, each timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device milliseconds of fn(): fn is captured once in a CUDA graph and
    the replays are timed by CUDA events, so the host's launch overhead
    (the Python wrappers) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(torch, graph.replay, reps)
    del graph
    return ms


def bound_ms(nbytes: float, ops: float, ops_rate: float):
    """(least ms, what bounds it) from bytes moved and operations done."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Family:
    """Numbers of one kernel family for the kernels line: ms, plain_ms,
    library_ms and the bound are sums over the same unit of work (per
    request for flash_fwd, per decode step of mode A for the int8
    kernels)."""

    def __init__(self, name):
        self.name = name
        self.ms = self.plain_ms = self.bytes = 0.0
        self.ops = {"bf16": 0.0, "int8": 0.0}
        self.library_ms = None
        self.max_err = 0.0

    def add(self, n, ms, plain_ms, nbytes, ops=0.0, kind="bf16",
            library_ms=None):
        self.ms += n * ms
        self.plain_ms += n * plain_ms
        self.bytes += n * nbytes
        self.ops[kind] += n * ops
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + n * library_ms

    def bound(self):
        t_bytes = self.bytes / HBM_BPS * 1e3
        t_ops = (self.ops["bf16"] / BF16_OPS + self.ops["int8"] / INT8_OPS) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# K1/K2 flash_fwd
# ---------------------------------------------------------------------------


def check_flash(torch, fa, name, B, Sq, H, D, *, Sk=None, Hkv=None,
                causal=False, bounded=False, pads=None, window=None,
                expect_dead=False, seed=0, timed=True):
    """Kernel vs plain version at one shape → dict of measured numbers.
    pads: per batch row, how many leading keys the keep-mask removes;
    expect_dead: whether that leaves query rows with no valid key."""
    Sk = Sq if Sk is None else Sk
    Hkv = H if Hkv is None else Hkv
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    bias = None
    if pads is not None:
        mask = torch.ones(B, Sk, device="cuda", dtype=torch.bool)
        for b, n in enumerate(pads):
            mask[b, :n] = False
        bias = torch.where(mask, 0.0, fa.NEG_INF).float().contiguous()
    scale = D ** -0.5
    has_bias = bias is not None

    def kernel():
        return fa.flash_fwd(q, k, v, bias, scale, causal, bounded, window,
                            has_bias)

    def plain():
        return fa.flash_fwd_reference(q, k, v, bias, scale, causal, bounded,
                                      window, has_bias)

    def library():
        # the same function as one PyTorch call (timing yardstick only)
        attn_mask = None
        if bias is not None:
            attn_mask = bias[:, None, None, :].to(q.dtype)
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=attn_mask, is_causal=causal and bias is None,
            scale=scale, enable_gqa=Hkv != H)

    o, lse = kernel()
    o_ref, lse_ref = fa.flash_fwd_reference(
        q.float(), k.float(), v.float(), bias, scale, causal, bounded, window,
        has_bias)
    torch.cuda.synchronize()
    if torch.isnan(o).any() or torch.isnan(lse).any():
        raise AssertionError(f"{name}: NaN in kernel output")
    dead_ref = torch.isposinf(lse_ref)
    if not torch.equal(torch.isposinf(lse), dead_ref):
        raise AssertionError(f"{name}: dead rows differ from the plain "
                             "version")
    n_dead = int(dead_ref.sum())
    if n_dead:
        dead_rows = dead_ref.permute(0, 2, 1)          # [B, Sq, H]
        if not bool((o[dead_rows] == 0).all()):
            raise AssertionError(f"{name}: dead rows have o != 0")
    d_o = float((o.float() - o_ref).abs().max())
    r_o = float(torch.linalg.vector_norm(o.float() - o_ref)
                / torch.linalg.vector_norm(o_ref))
    live = ~dead_ref
    d_lse = (float((lse[live] - lse_ref[live]).abs().max())
             if bool(live.any()) else 0.0)
    ok = d_o <= BOUND_O and r_o <= BOUND_O_REL and d_lse <= BOUND_LSE
    nan = float("nan")
    ms = cuda_ms(torch, kernel, 20) if timed else nan
    plain_ms = cuda_ms(torch, plain, 5) if timed else nan
    lib_ms = cuda_ms(torch, library, 20) if timed and not causal else nan
    if timed and causal and bias is not None and B == 1 and not pads[0]:
        # an all-keep mask: SDPA's own causal path is the same function
        bias = None
        lib_ms = cuda_ms(torch, library, 20)
    # least time: q, k, v, bias read once, o and lse written once; the
    # products' flops (causal: the half the mask keeps)
    nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Sk * Hkv * D) + 4 * B * H * Sq
    flops = 4 * B * H * Sq * Sk * D * (0.5 if causal else 1.0)
    bms, by = bound_ms(nbytes, flops, BF16_OPS)
    log(f"[kernel] flash_fwd {name:<20} q={[B, Sq, H, D]} kv={[B, Sk, Hkv, D]} "
        f"causal={causal} bounded={bounded} window={window} "
        f"dead_rows={n_dead} max|do|={d_o:.3e} (<= {BOUND_O}) "
        f"rel|do|={r_o:.3e} (<= {BOUND_O_REL}) "
        f"max|dlse|={d_lse:.3e} (<= {BOUND_LSE})"
        + (f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f}"
           f" bound_ms={bms:.4f} ({by})" if timed else "")
        + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    if (n_dead > 0) != expect_dead:
        raise AssertionError(f"{name}: {n_dead} dead rows, expected "
                             f"{'some' if expect_dead else 'none'}")
    del q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return {"max_abs_err": d_o, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bytes": nbytes, "flops": flops}


def check_flash_edges(torch, fa):
    """Cases the wrapper accepts beyond the slice's shapes: the llama head
    dim with GQA and a window that bites, a rectangular causal block, a
    fully masked batch row without causality, bounded mode with a bias, and
    sequences shorter than one tile."""
    cases = [
        ("gqa_d128_window", dict(B=2, Sq=300, H=32, Hkv=8, D=128,
                                 causal=True, window=64, pads=(0, 50),
                                 expect_dead=True)),
        ("causal_rect", dict(B=1, Sq=100, Sk=333, H=4, D=96, causal=True,
                             pads=(7,))),
        ("noncausal_dead_row", dict(B=2, Sq=130, H=4, D=64,
                                    pads=(0, 130), expect_dead=True)),
        ("bounded_bias", dict(B=2, Sq=200, H=4, D=88, bounded=True,
                              pads=(0, 33))),
        ("tiny", dict(B=1, Sq=1, Sk=5, H=2, D=64, causal=True)),
    ]
    for i, (name, kw) in enumerate(cases):
        check_flash(torch, fa, name, seed=100 + i, timed=False, **kw)


def flash_phase(torch, fa, cfg, S_pre):
    fam = Family("flash_fwd")
    per_req = {"clip": cfg.clip.num_layers + cfg.clip.feature_layer + 1,
               "iv2": cfg.video.num_blocks_used, "prefill": cfg.llm.num_layers}
    res = {
        "clip": check_flash(torch, fa, "clip", 12, cfg.clip.num_patches + 1,
                            cfg.clip.num_heads, cfg.clip.head_dim, seed=1),
        "iv2": check_flash(torch, fa, "internvideo2_bounded", 12,
                           cfg.video.seq_len, cfg.video.num_heads,
                           cfg.video.head_dim, bounded=True, seed=2),
        "prefill": check_flash(torch, fa, "prefill_causal", 1, S_pre,
                               cfg.llm.num_heads, cfg.llm.head_dim,
                               causal=True, pads=(0,), seed=3),
    }
    check_flash(torch, fa, "leftpad_causal_b2", 2, 1000, cfg.llm.num_heads,
                cfg.llm.head_dim, causal=True, pads=(0, 237),
                expect_dead=True, seed=4)
    check_flash_edges(torch, fa)
    for key, n in per_req.items():
        r = res[key]
        fam.add(n, r["ms"], r["plain_ms"], r["bytes"], r["flops"], "bf16",
                r["library_ms"])
        fam.max_err = max(fam.max_err, r["max_abs_err"])
    bms, by = fam.bound()
    log(f"[kernel] flash_fwd per request ({per_req}): kernel {fam.ms:.3f} ms, "
        f"plain {fam.plain_ms:.3f} ms, sdpa {fam.library_ms:.3f} ms, bound "
        f"{bms:.3f} ms ({by})")
    return fam, sum(per_req.values())


# ---------------------------------------------------------------------------
# K7 flash_bwd
# ---------------------------------------------------------------------------


def visible_pairs(mask, Sq, Sk, causal, window, q_offset):
    """(q row, key) pairs the attention keeps, summed over the batch: the
    work this data needs (mask [B, Sk] bool on the host)."""
    valid = np.asarray(mask, bool)
    csum = np.concatenate([np.zeros((valid.shape[0], 1), np.int64),
                           np.cumsum(valid, axis=1)], axis=1)
    if not causal:
        return int(Sq * csum[:, -1].sum())
    qpos = np.arange(Sq) + q_offset
    hi = np.clip(qpos + 1, 0, Sk)                      # keys [lo, hi)
    lo = np.zeros_like(hi) if window is None else np.clip(
        qpos - window + 1, 0, Sk)
    lo = np.minimum(lo, hi)
    return int((csum[:, hi] - csum[:, lo]).sum())


def flash_bwd_plain(torch, fa, q, k, v, bias, o, lse, do, scale, causal,
                    window, q_offset):
    """The plain version kv head by kv head, so its fp32 [G, Sq, Sk]
    tensors fit on the card at the training shape."""
    Hkv = k.shape[2]
    G = q.shape[2] // Hkv
    dq, dk, dv = [], [], []
    for hk in range(Hkv):
        hs = slice(hk * G, (hk + 1) * G)
        a, b_, c = fa.flash_bwd_reference(
            q[:, :, hs], k[:, :, hk:hk + 1], v[:, :, hk:hk + 1], bias,
            o[:, :, hs], lse[:, hs], do[:, :, hs], scale, causal, window,
            q_offset)
        dq.append(a)
        dk.append(b_)
        dv.append(c)
    return torch.cat(dq, 2), torch.cat(dk, 2), torch.cat(dv, 2)


def sdpa_backward_ms(torch, q, k, v, keep, do, scale, reps):
    """Library yardstick: scaled_dot_product_attention forward + backward
    (torch.autograd.grad) minus its forward, with the mask as the boolean
    [B, 1, Sq, Sk] attn_mask SDPA takes. → (ms, backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    gqa = q.shape[2] != k.shape[2]
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                def fwd():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=keep, scale=scale,
                        enable_gqa=gqa)

                def fwd_bwd():
                    out = fwd()
                    return torch.autograd.grad(out, (qt, kt, vt), dot)

                fwd_bwd()
                ms = cuda_ms(torch, fwd_bwd, reps) - cuda_ms(torch, fwd, reps)
            return ms, backend.name
        except RuntimeError:
            continue
    return float("nan"), "none"


def check_flash_bwd(torch, fa, name, B, Sq, H, D, *, Sk=None, Hkv=None,
                    causal=True, pads=None, left=False, window=None,
                    q_offset=None, expect_dead=False, seed=0, timed=False,
                    reps=10):
    """K7 vs its plain version at one shape → dict of measured numbers.
    o and lse come from the forward kernel, do is random. pads: per batch
    row, how many keys the mask removes (at the end, or at the start with
    left=True); expect_dead: whether that leaves rows with no valid key,
    whose dq must be exactly 0."""
    Sk = Sq if Sk is None else Sk
    Hkv = H if Hkv is None else Hkv
    q_off = Sk - Sq if q_offset is None else q_offset
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, do = randn(B, Sq, H, D), randn(B, Sq, H, D)
    k, v = randn(B, Sk, Hkv, D), randn(B, Sk, Hkv, D)
    mask = torch.ones(B, Sk, device="cuda", dtype=torch.bool)
    for b, n in enumerate(pads or ()):
        if n and left:
            mask[b, :n] = False
        elif n:
            mask[b, Sk - n:] = False
    bias = (torch.where(mask, 0.0, fa.NEG_INF).float().contiguous()
            if pads is not None else None)
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, bias, scale, causal, False, window,
                          bias is not None, q_offset)
    before = fa.FLASH_BWD.launches

    def kernel():
        return fa.flash_bwd(q, k, v, bias, o, lse, do, scale, causal, window,
                            q_offset)

    def plain():
        return flash_bwd_plain(torch, fa, q, k, v, bias, o, lse, do, scale,
                               causal, window, q_offset)

    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    launched = fa.FLASH_BWD.launches == before + 1
    rels, worst = [], 0.0
    for x, y in zip(got, want):
        d = x.float() - y.float()
        rels.append(float(torch.linalg.vector_norm(d)
                          / torch.linalg.vector_norm(y.float()).clamp_min(
                              1e-30)))
        worst = max(worst, float(d.abs().max()))
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    dead = torch.isposinf(lse).permute(0, 2, 1)      # [B, Sq, H]
    n_dead = int(dead.sum())
    dead_zero = bool((got[0][dead] == 0).all()) if n_dead else True
    ok = (finite and launched and dead_zero
          and all(r <= b for r, b in zip(rels, BOUND_BWD_REL)))
    pairs = visible_pairs(mask.cpu().numpy(), Sq, Sk, causal, window, q_off)
    flops = 10.0 * D * pairs * H          # five products per visible pair
    nbytes = (2 * (3 * B * Sq * H * D + 2 * B * Sk * Hkv * D)   # q do o k v
              + 4 * B * H * Sq + (4 * B * Sk if bias is not None else 0)
              + 2 * (B * Sq * H * D + 2 * B * Sk * Hkv * D))    # dq dk dv
    bms, by = bound_ms(nbytes, flops, BF16_OPS)
    nan = float("nan")
    ms = plain_ms = lib_ms = nan
    backend = "-"
    if timed:
        ms = cuda_ms(torch, kernel, reps)
        plain_ms = cuda_ms(torch, plain, 2)
        qpos = torch.arange(Sq, device="cuda")[:, None] + q_off
        kpos = torch.arange(Sk, device="cuda")[None, :]
        keep = mask[:, None, None, :].expand(B, 1, Sq, Sk)
        if causal:
            vis = kpos <= qpos
            if window is not None:
                vis = vis & (qpos - kpos < window)
            keep = keep & vis
        lib_ms, backend = sdpa_backward_ms(torch, q, k, v, keep, do, scale,
                                           reps)
        del keep
    log(f"[kernel] flash_bwd {name:<22} q={[B, Sq, H, D]} kv={[B, Sk, Hkv, D]}"
        f" causal={causal} window={window} q_offset={q_offset} "
        f"dead_rows={n_dead} dq_dead_rows_zero={dead_zero} "
        f"rel|ddq|={rels[0]:.3e} rel|ddk|={rels[1]:.3e} rel|ddv|={rels[2]:.3e}"
        f" (<= {BOUND_BWD_REL}) max|d|={worst:.3e} visible_pairs={pairs}"
        + (f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
           f"sdpa_bwd_ms={lib_ms:.4f} ({backend}) bound_ms={bms:.4f} ({by}) "
           f"TFLOP/s={flops / ms / 1e9:.1f}" if timed else "")
        + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_bwd {name}: kernel disagrees with the "
                             "plain version")
    if (n_dead > 0) != expect_dead:
        raise AssertionError(f"flash_bwd {name}: {n_dead} dead rows, expected"
                             f" {'some' if expect_dead else 'none'}")
    del q, k, v, do, o, lse, got, want
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bytes": nbytes, "flops": flops}


def flash_bwd_phase(torch, fa, cfg, S_train):
    """K7 at the training shape (timed), B = 2 with two right paddings, and
    the edge cases. The family's numbers are per microbatch: one launch
    per LLM layer at the training shape."""
    fam = Family("flash_bwd")
    L = cfg.llm
    # K2 at the same shape, for comparison (the forward runs twice per
    # layer and microbatch: once, and again in the remat recompute)
    check_flash(torch, fa, "train_causal", 1, S_train, L.num_heads,
                L.head_dim, causal=True, pads=(0,), window=L.sliding_window,
                seed=49)
    r = check_flash_bwd(torch, fa, "train_causal", 1, S_train, L.num_heads,
                        L.head_dim, pads=(37,), window=L.sliding_window,
                        seed=50, timed=True)
    check_flash_bwd(torch, fa, "b2_rightpad", 2, 1500, L.num_heads,
                    L.head_dim, pads=(0, 211), window=L.sliding_window,
                    seed=51)
    check_flash_bwd(torch, fa, "b2_rightpad_both", 2, 777, L.num_heads,
                    L.head_dim, pads=(65, 300), seed=52)
    edges = [
        ("gqa_d128", dict(B=2, Sq=300, H=32, Hkv=8, D=128, pads=(0, 50))),
        ("noncausal_d88", dict(B=2, Sq=2049, H=16, D=88, causal=False,
                               pads=(0, 100))),
        ("window", dict(B=1, Sq=700, H=4, D=96, window=64, pads=(13,))),
        ("q_offset", dict(B=1, Sq=100, Sk=333, H=4, D=96, q_offset=150,
                          pads=(0,))),
        ("leftpad_dead_rows", dict(B=2, Sq=300, H=4, D=96, pads=(0, 77),
                                   left=True, expect_dead=True)),
        ("tiny", dict(B=1, Sq=1, Sk=5, H=2, D=64)),
    ]
    for i, (name, kw) in enumerate(edges):
        check_flash_bwd(torch, fa, name, seed=60 + i, **kw)
    fam.add(L.num_layers, r["ms"], r["plain_ms"], r["bytes"], r["flops"],
            "bf16", r["library_ms"])
    fam.max_err = r["max_abs_err"]
    bms, by = fam.bound()
    log(f"[kernel] flash_bwd per microbatch ({L.num_layers} launches at "
        f"[1, {S_train}, {L.num_heads}, {L.head_dim}]): kernel {fam.ms:.3f} "
        f"ms, plain {fam.plain_ms:.3f} ms, sdpa backward "
        f"{fam.library_ms:.3f} ms, bound {bms:.3f} ms ({by})")
    return fam


# ---------------------------------------------------------------------------
# int8_matmul: w8a8 (int8_gemv, K3) and weight-only (int8_matmul, K3/K6)
# ---------------------------------------------------------------------------


def gemv_error(torch, y, y_ref):
    return float((y.float() - y_ref.float()).abs().max()
                 / y_ref.float().abs().max().clamp_min(1e-30))


def check_gemv(torch, mm, name, M, D, O, *, layers=1, w8a8=False,
               timed=False, seed=0):
    """mm.int8_matmul vs its plain version on layer 0 of a stacked random
    int8 weight [layers, D, O], and the branch's kernel counted the launch;
    timed: CUDA-event medians of one pass over all layers (the decode step
    streams them cold from HBM) → per-layer numbers."""
    counter = mm.INT8_GEMV if w8a8 else mm.INT8_MATMUL

    def kernel(x, w, s):
        return mm.int8_matmul(x, w, s, w8a8)

    def plain(x, w, s):
        return mm.int8_matmul_reference(x, w, s, w8a8)

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    w = torch.randint(-127, 128, (layers, D, O), generator=g, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(layers, O, generator=g, device="cuda") * 1e-3 + 1e-4
    x = torch.randn(M, D, generator=g, device="cuda").to(torch.bfloat16)
    before = counter.launches
    y = kernel(x, w[0], s[0])
    y_ref = plain(x, w[0], s[0])
    torch.cuda.synchronize()
    err = gemv_error(torch, y, y_ref)
    ok = (err <= BOUND_GEMV and y.dtype == torch.bfloat16
          and bool(torch.isfinite(y).all())
          and counter.launches == before + 1)
    out = {"err": float((y.float() - y_ref.float()).abs().max())}
    line = (f"[kernel] {name:<19} M={M} D={D} O={O} "
            f"{'w8a8' if w8a8 else 'weight-only'} max|dy|={out['err']:.3e} "
            f"max|dy|/max|y|={err:.3e} "
            f"(<= {BOUND_GEMV:.3e})")
    if timed:
        def run(fn):
            return lambda: [fn(x, w[i], s[i]) for i in range(layers)]

        out["call_ms"] = cuda_ms(torch, run(kernel), 10) / layers
        out["ms"] = graph_ms(torch, run(kernel)) / layers
        out["plain_ms"] = graph_ms(torch, run(plain), 5) / layers
        if w8a8:
            # the int8 x int8 dot alone as one PyTorch call: torch._int_mm
            # takes more than 16 rows
            x8 = torch.zeros(max(M, 17), D, dtype=torch.int8, device="cuda")
            out["library_ms"] = graph_ms(
                torch, lambda: [torch._int_mm(x8, w[i])
                                for i in range(layers)]) / layers
        out["bytes"] = D * O + 4 * O + 2 * M * D + 2 * M * O
        out["ops"] = 2 * M * D * O
        bms, by = bound_ms(out["bytes"], out["ops"],
                           INT8_OPS if w8a8 else BF16_OPS)
        line += (f" kernel_ms={out['ms']:.4f} (with the host's launch: "
                 f"{out['call_ms']:.4f}) plain_ms={out['plain_ms']:.4f}"
                 + (f" int_mm_ms={out['library_ms']:.4f}" if w8a8 else "")
                 + f" bound_ms={bms:.4f} ({by}) over {layers} layers")
    log(line + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} M={M} D={D} O={O}: kernel disagrees "
                             "with the plain version")
    del w, s, x
    torch.cuda.empty_cache()
    return out


def gemv_phase(torch, mm, cfg):
    """int8_matmul, both branches, at M 1 and 6 on the four Phi-3.5
    projections (timed over 32 layers: w8a8 at M 6, mode A's decode step;
    weight-only at M 1, a decode step of modes B and C), and weight-only at
    M 1, 6, 255 on O 9216 and the vocabulary (timed: the lm_head at M 6).
    The int8_matmul family's numbers are mode A's per step (the lm_head)."""
    L = cfg.llm
    D, I, V = L.hidden_size, L.intermediate_size, L.padded_vocab_size
    shapes = {"qkv": (D, L.q_dim + 2 * L.kv_dim), "o": (L.q_dim, D),
              "gate_up": (D, 2 * I), "down": (I, D)}
    k3, k6 = Family("int8_gemv"), Family("int8_matmul")
    wo_step = Family("int8_matmul")      # modes B and C, printed only

    for j, (pname, (d, o)) in enumerate(shapes.items()):
        for w8a8 in (False, True):
            fam = k3 if w8a8 else k6
            for M in (1, 6):
                timed = M == (6 if w8a8 else 1)
                r = check_gemv(torch, mm, f"{fam.name} {pname}", M, d, o,
                               layers=L.num_layers if timed else 1,
                               w8a8=w8a8, timed=timed, seed=10 + j)
                fam.max_err = max(fam.max_err, r["err"])
                if timed:
                    (k3 if w8a8 else wo_step).add(
                        L.num_layers, r["ms"], r["plain_ms"], r["bytes"],
                        r["ops"], "int8" if w8a8 else "bf16",
                        r.get("library_ms"))
    for M in (1, 6, 255):
        for o in (shapes["qkv"][1], V):
            timed = M == 6 and o == V
            r = check_gemv(torch, mm, "int8_matmul", M, D, o, timed=timed,
                           seed=20 + M)
            k6.max_err = max(k6.max_err, r["err"])
            if timed:
                k6.add(1, r["ms"], r["plain_ms"], r["bytes"], r["ops"])
    for fam, what in ((k3, "mode A, 128 launches at M=6"),
                      (k6, "mode A, the lm_head at M=6"),
                      (wo_step, "modes B and C, 128 launches at M=1, "
                       "without the lm_head")):
        bms, by = fam.bound()
        lib = (f"{fam.library_ms:.3f} ms" if fam.library_ms is not None
               else "none")
        log(f"[kernel] {fam.name} per decode step ({what}): kernel "
            f"{fam.ms:.3f} ms, plain {fam.plain_ms:.3f} ms, library {lib}, "
            f"bound {bms:.3f} ms ({by})")
    return k3, k6


# ---------------------------------------------------------------------------
# K4 decode_attention_int8
# ---------------------------------------------------------------------------


def ragged_valid(torch, B, L, seed):
    """[B, L] bool: each row a left-pad hole, its prompt and decoded slots,
    then an unwritten tail; row 0 of a batch > 1 keeps only a few slots."""
    rng = np.random.default_rng(seed)
    valid = np.zeros((B, L), bool)
    for b in range(B):
        pad = int(rng.integers(0, 200))
        end = L - int(rng.integers(1, 120))
        valid[b, pad:end] = True
    if B > 1:
        valid[0] = False
        valid[0, 100:105] = True
    return torch.from_numpy(valid).cuda()


def check_attention(torch, da, name, B, H, Hkv, D, L, *, layers=1,
                    timed=False, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def cache():
        vals = torch.randint(-127, 128, (layers, B, Hkv, L, D), generator=g,
                             device="cuda", dtype=torch.int8)
        return vals, torch.rand(layers, B, Hkv, L, generator=g,
                                device="cuda") * 0.02 + 1e-3

    k8, ks = cache()
    v8, vs = cache()
    q = torch.randn(B, 1, H, D, generator=g, device="cuda").to(torch.bfloat16)
    kn, vn = (torch.randn(B, 1, Hkv, D, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    valid = ragged_valid(torch, B, L, seed)
    scale = D ** -0.5

    def kernel(i=0):
        return da.decode_attention_int8(q, k8[i], ks[i], v8[i], vs[i], valid,
                                        kn, vn, scale=scale)

    def plain(i=0):
        return da.decode_attention_int8_reference(
            q, k8[i], ks[i], v8[i], vs[i], valid, kn, vn, scale=scale)

    o, o_ref = kernel(), plain()
    torch.cuda.synchronize()
    do = o.float() - o_ref.float()
    err = float(do.abs().max())
    rel = float(torch.linalg.vector_norm(do)
                / torch.linalg.vector_norm(o_ref.float()))
    row = float((torch.linalg.vector_norm(do, dim=-1)
                 / torch.linalg.vector_norm(o_ref.float(), dim=-1)).max())
    ok = (rel <= BOUND_ATTN_REL and row <= BOUND_ATTN_ROW
          and bool(torch.isfinite(o).all()))
    line = (f"[kernel] decode_attention_int8 {name:<8} B={B} H={H} Hkv={Hkv} "
            f"D={D} L={L} valid_slots={int(valid.sum())} "
            f"max|do|={err:.3e} rel|do|={rel:.3e} (<= {BOUND_ATTN_REL}) "
            f"max per-row rel|do|={row:.3e} (<= {BOUND_ATTN_ROW:.3e})")
    out = {"err": err}
    if timed:
        out["call_ms"] = cuda_ms(
            torch, lambda: [kernel(i) for i in range(layers)], 10) / layers
        out["ms"] = graph_ms(
            torch, lambda: [kernel(i) for i in range(layers)]) / layers
        out["plain_ms"] = graph_ms(
            torch, lambda: [plain(i) for i in range(layers)], 5) / layers
        # the slots this data needs (valid ones), their scales, the mask,
        # q / k_new / v_new read and the output written
        n_valid = int(valid.sum())
        out["bytes"] = (Hkv * n_valid * (2 * D + 8) + B * L
                        + 2 * (2 * B * H * D + 2 * B * Hkv * D))
        out["ops"] = 4 * H * D * n_valid
        bms, by = bound_ms(out["bytes"], out["ops"], BF16_OPS)
        line += (f" kernel_ms={out['ms']:.4f} (with the host's launch: "
                 f"{out['call_ms']:.4f}) plain_ms={out['plain_ms']:.4f}"
                 f" bound_ms={bms:.4f} ({by}) over {layers} layers")
    log(line + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode_attention_int8 {name}: kernel "
                             "disagrees with the plain version")
    del k8, ks, v8, vs
    torch.cuda.empty_cache()
    return out


def attention_phase(torch, da, cfg, max_len):
    L = cfg.llm
    k4 = Family("decode_attention_int8")
    for B in (1, 6):
        timed = B == 6
        r = check_attention(torch, da, f"b{B}", B, L.num_heads,
                            L.num_kv_heads, L.head_dim, max_len,
                            layers=L.num_layers if timed else 1, timed=timed,
                            seed=30 + B)
        k4.max_err = max(k4.max_err, r["err"])
        if timed:
            k4.add(L.num_layers, r["ms"], r["plain_ms"], r["bytes"], r["ops"])
    r = check_attention(torch, da, "gqa_d128", 2, 32, 8, 128, 1000, seed=39)
    k4.max_err = max(k4.max_err, r["err"])
    bms, by = k4.bound()
    log(f"[kernel] decode_attention_int8 per decode step of mode A (32 "
        f"launches, B=6): kernel {k4.ms:.3f} ms, plain {k4.plain_ms:.3f} ms, "
        f"bound {bms:.3f} ms ({by})")
    return k4


# ---------------------------------------------------------------------------
# K5 scatter_write
# ---------------------------------------------------------------------------


def write_phase(torch, cw, cfg, max_len):
    L = cfg.llm
    k5 = Family("scatter_write")
    B, Hkv, D, n = 6, L.num_kv_heads, L.head_dim, L.num_layers
    g = torch.Generator(device="cuda")
    g.manual_seed(40)

    def values(*shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    caches = [values(n, B, Hkv, max_len, D),
              torch.rand(n, B, Hkv, max_len, generator=g, device="cuda"),
              values(n, B, Hkv, max_len, D),
              torch.rand(n, B, Hkv, max_len, generator=g, device="cuda")]
    news = [values(n, B, Hkv, D), torch.rand(n, B, Hkv, generator=g,
                                             device="cuda"),
            values(n, B, Hkv, D), torch.rand(n, B, Hkv, generator=g,
                                             device="cuda")]
    idx = torch.tensor([0, 127, 128, max_len // 2, max_len - 2, max_len - 1],
                       dtype=torch.int32, device="cuda")
    before = [c.clone() for c in caches]
    ptrs = [c.data_ptr() for c in caches]
    cw.scatter_write(caches, news, idx)
    expect = [c.clone() for c in before]
    cw.scatter_write_reference(expect, news, idx.cpu())
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(caches, expect))
    kept = [c.data_ptr() for c in caches] == ptrs
    # bytes other than the written slots: untouched, bitwise
    keep = torch.ones(B, max_len, dtype=torch.bool, device="cuda")
    keep[torch.arange(B, device="cuda"), idx.long()] = False
    untouched = all(
        torch.equal(c.transpose(1, 2)[:, :, keep].view(torch.uint8),
                    b.transpose(1, 2)[:, :, keep].view(torch.uint8))
        for c, b in zip(caches, before))
    ok = same and kept and untouched
    ar = torch.arange(B, device="cuda")

    def library():
        for c, new in zip(caches, news):
            c[:, ar, :, idx.long()] = new.transpose(0, 1)

    call_ms = cuda_ms(torch, lambda: cw.scatter_write(caches, news, idx), 50)
    ms = graph_ms(torch, lambda: cw.scatter_write(caches, news, idx), 50)
    # the plain version reads the slots on the host: not capturable, so its
    # time includes the host's part
    plain_ms = cuda_ms(torch, lambda: cw.scatter_write_reference(
        caches, news, idx), 10)
    lib_ms = graph_ms(torch, library, 50)
    nbytes = 2 * sum(t.numel() * t.element_size() for t in news)
    k5.add(1, ms, plain_ms, nbytes, 0.0, "bf16", lib_ms)
    bms, by = k5.bound()
    log(f"[kernel] scatter_write 4 buffers [{n},{B},{Hkv},{max_len},{D}] "
        f"slots={idx.tolist()} equal_to_plain={same} same_storage={kept} "
        f"untouched_bytes_equal={untouched} kernel_ms={ms:.4f} (with the "
        f"host's launch: {call_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} index_put_ms={lib_ms:.4f} (4 calls) "
        f"bound_ms={bms:.5f} ({by}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("scatter_write: kernel disagrees with the plain "
                             "version or touched other bytes")
    del caches, news, before, expect
    torch.cuda.empty_cache()
    return k5


# ---------------------------------------------------------------------------
# Small references
# ---------------------------------------------------------------------------


def rel_err(torch, a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def to_host(tree, dtype=None):
    """A parameter tree on the host; dense floats cast to dtype when given,
    int8 weights moved as they are."""
    if isinstance(tree, dict):
        return {k: to_host(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):          # Int8Weight / Int8Embedding
        return type(tree)(*(to_host(v, None) if hasattr(v, "cpu") else v
                            for v in tree))
    t = tree.cpu()
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def small_reference(torch, cfg_full, seed, quantize):
    """Depth-cut full-width model: card (kernels) vs host (plain versions),
    same weights, same frames and prompt. quantize None: bf16 card vs fp32
    host; "int8_full": the same int8 weights and int8 cache on both."""
    from grounded_video_llm_tpu_torch.cli.model_loading import (
        build_params, build_tokenizer)
    from grounded_video_llm_tpu_torch.core.config import replace
    from grounded_video_llm_tpu_torch.models import llm, vlm
    from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine

    n_frames = cfg_full.video.num_frames       # one segment
    cfg = replace(cfg_full, num_frames=n_frames, num_segs=1,
                  clip=replace(cfg_full.clip, num_layers=3),
                  video=replace(cfg_full.video, depth=2, num_blocks_used=2),
                  llm=replace(cfg_full.llm, num_layers=2))
    tok = build_tokenizer(cfg)
    eng = InferenceEngine(build_params(cfg, "cuda", torch.bfloat16, seed),
                          cfg, tok, quantize=quantize)
    p_gpu = eng.params
    p_cpu = to_host(p_gpu, None if quantize else torch.float32)
    quant_cache = quantize is not None
    temporal, spatial = eng.preprocess_frames(synthetic_video(seed + 1,
                                                              n_frames))
    ids = eng.tokenize_prompt(eng.build_prompt(MODES[0][1], "grounding", 30.0))
    outs = {}
    next_tok = None
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        lp = params["llm"]
        with torch.inference_mode():
            sp = torch.from_numpy(spatial[None]).to(dev)
            tp = torch.from_numpy(temporal[None]).to(dev)
            feats = vlm.encode_video(params, cfg, sp, tp)
            input_ids = torch.tensor([ids], device=dev)
            mask = torch.ones_like(input_ids)
            embeds, _, m = vlm.splice_multimodal(
                input_ids, None, mask, feats, lp["embed"])
            S = embeds.shape[1]
            max_len = -(-(S + 8) // 128) * 128
            cache = (llm.QuantKVCache.create(cfg.llm, 1, max_len, device=dev)
                     if quant_cache else
                     llm.KVCache.create(cfg.llm, 1, max_len,
                                        dtype=embeds.dtype, device=dev))
            logits, cache = llm.prefill(lp, cfg.llm, embeds, m, cache)
            if next_tok is None:
                next_tok = int(logits.argmax(-1)[0])
            valid = torch.zeros(1, max_len, dtype=torch.bool, device=dev)
            valid[:, :S] = True
            tok_ids = torch.tensor([next_tok], device=dev)
            step_logits, _, _ = llm.decode_step(
                lp, cfg.llm, llm.embed_lookup(lp["embed"], tok_ids)[:, None]
                .to(embeds.dtype), cache, valid, torch.tensor([S], device=dev))
        if step_logits.dtype != torch.float32:
            raise AssertionError(f"decode logits are {step_logits.dtype}")
        outs[dev] = (feats, logits, step_logits)
    errs = [rel_err(torch, outs["cuda"][i], outs["cpu"][i]) for i in range(3)]
    bound = BOUND_SMALL_W8A8 if quantize == "int8_full" else BOUND_SMALL
    ok = max(errs) <= bound
    what = (f"{quantize} + int8 cache, card kernels vs host plain versions"
            if quantize else "card bf16 vs host fp32")
    log(f"[small-ref] depth-cut full width (CLIP 2 of 3 layers, IV2 2 "
        f"blocks, LLM 2 layers, 1 segment), {what}, rel L2: "
        f"video features {errs[0]:.3e}, prefill logits {errs[1]:.3e}, "
        f"decode-step logits {errs[2]:.3e} (<= {bound}) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("card path disagrees with the host reference")
    del p_gpu, p_cpu, eng, outs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Training: samples, the model-FLOP formula, the small reference
# ---------------------------------------------------------------------------


def grounded_text(seed: int, rounds: int) -> str:
    """A grounded conversation rendered by the Phi-3.5 template: the video
    placeholder in the first question, every answer a time interval in
    quantized <n> tokens, the grounding mark the dataset adds."""
    from grounded_video_llm_tpu_torch.text import codec
    from grounded_video_llm_tpu_torch.text.templates import get_template

    rng = np.random.default_rng(seed)
    events = ["the host turns to the camera", "a car passes the studio window",
              "the weather map appears", "the anchor reads the headline",
              "a reporter walks along the street", "the crowd starts to cheer"]
    conv = []
    for r in range(rounds):
        a, b = sorted(int(x) for x in rng.integers(0, 301, size=2))
        query = (f"Give you a textual query: '{events[r % len(events)]}, "
                 f"then the scene changes and {events[(r + 3) % 6]}'. When "
                 "does the described content occur in the video? Please "
                 "return the start and end timestamps.")
        conv.append({"from": "human",
                     "value": ("<image>\n" if r == 0 else "") + query})
        conv.append({"from": "gpt", "value": f"From <{a}> to <{b}>."})
    return get_template("phi3.5").encode(
        codec.mark_grounding_conversations(conv))


def train_samples(temporal, spatial, n: int, rounds: int, seed: int):
    """n grounded samples over one resized video (uint8 pixels, normalized
    on the card by encode_video)."""
    return [{"video_ids": f"synthetic{i}", "text_inputs":
             grounded_text(seed + i, rounds),
             "temporal_pixel_values": temporal,
             "spatial_pixel_values": spatial} for i in range(n)]


def train_step_flops(params, cfg, B: int, S_text: int) -> float:
    """Model FLOPs of one grounded train microbatch, the formula of
    bench_train.py:102 (train_step_flops) over this package's tree: frozen
    encoders forward only (early exit, penultimate CLIP layer), projectors
    as bench_train.py counts them (its "image_projector" key names no leaf,
    so the mm_projector is not counted, as there), the LLM's GEMMs three
    times (forward, remat recompute, dx), the lm_head forward once more,
    causal attention 4.5 times its forward."""
    from grounded_video_llm_tpu_torch.train.optimizer import tree_items

    def gemm_per_token(tree):
        total = 0
        for path, leaf in tree_items(tree):
            name = path.lower()
            if not any(k in name for k in ("kernel", "lm_head", "lora")):
                continue
            if "bias" in name or leaf.dim() < 2:
                continue
            total += 2 * leaf.numel()
        return total

    S = S_text - 1 + cfg.num_video_tokens
    ev, cl, lm = cfg.video, cfg.clip, cfg.llm
    iv2 = gemm_per_token(params["video_encoder"]) * B * cfg.num_segs \
        * ev.seq_len * ev.num_blocks_used / ev.depth
    iv2 += ev.num_blocks_used * 4 * (B * cfg.num_segs) * ev.seq_len ** 2 \
        * ev.embed_dim
    clip_tok = B * cfg.num_segs * (cl.num_patches + 1)
    clipf = gemm_per_token(params["clip"]) * clip_tok \
        * (cl.num_layers - 1) / cl.num_layers
    clipf += (cl.num_layers - 1) * 4 * (B * cfg.num_segs) \
        * (cl.num_patches + 1) ** 2 * cl.hidden_size
    proj = sum(gemm_per_token(params[k]) * B * cfg.num_video_tokens
               for k in ("video_projector", "image_projector") if k in params)
    llm_gemm = gemm_per_token(params["llm"]) * B * S
    lm_head_fwd = 2 * lm.hidden_size * lm.padded_vocab_size * B * S
    attn_fwd = lm.num_layers * 2 * B * S ** 2 * lm.q_dim
    return float(iv2 + clipf + proj + 3.0 * llm_gemm + lm_head_fwd
                 + 4.5 * attn_fwd)


def small_reference_train(torch, cfg_full, seed):
    """One grounded microbatch through forward_loss and its backward on a
    depth-cut full-width model with LoRA attached (non-zero B): the card
    (bf16, kernels) against the host (fp32, plain versions), same weights,
    same batch, lora_dropout 0. Compares the loss and the gradient of every
    trainable leaf."""
    from grounded_video_llm_tpu_torch.cli.model_loading import (
        build_params, build_tokenizer)
    from grounded_video_llm_tpu_torch.core.config import (STAGE_PRESETS,
                                                          replace)
    from grounded_video_llm_tpu_torch.data.collate import collate
    from grounded_video_llm_tpu_torch.models import vlm
    from grounded_video_llm_tpu_torch.ops.preprocess import \
        dual_stream_resize_host
    from grounded_video_llm_tpu_torch.text.templates import get_template
    from grounded_video_llm_tpu_torch.train import lora as lora_mod
    from grounded_video_llm_tpu_torch.train.optimizer import (make_optimizer,
                                                              tree_items)
    from grounded_video_llm_tpu_torch.train.step import set_trainable

    n_frames = cfg_full.video.num_frames       # one segment
    cfg = replace(cfg_full, num_frames=n_frames, num_segs=1,
                  clip=replace(cfg_full.clip, num_layers=3),
                  video=replace(cfg_full.video, depth=2, num_blocks_used=2),
                  llm=replace(cfg_full.llm, num_layers=2))
    tok = build_tokenizer(cfg)
    params = build_params(cfg, "cuda", torch.bfloat16, seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    lora = lora_mod.init_lora(cfg.llm, generator=g, device="cuda",
                              dtype=torch.bfloat16)
    for la in lora.values():
        la["b"].normal_(0.0, 0.02, generator=g)
    params["llm"] = lora_mod.attach_lora(params["llm"], lora)
    temporal, spatial = dual_stream_resize_host(
        synthetic_video(seed + 2, n_frames), 1)
    sample = train_samples(temporal, spatial, 1, 6, seed)[0]
    out = {}
    for dev, p in (("cpu", to_host(params, torch.float32)),
                   ("cuda", params)):
        opt, _ = make_optimizer(STAGE_PRESETS["grounded"], 10, p)
        set_trainable(p, opt)
        batch = collate([sample], tok, get_template("phi3.5"),
                        max_txt_len=cfg.max_txt_len, device=dev)
        names = [n for n, _ in tree_items(p) if opt.trainable(n)]
        flat = dict(tree_items(p))
        t0 = time.perf_counter()
        loss = vlm.forward_loss(p, cfg, batch, remat=True)
        grads = torch.autograd.grad(loss, [flat[n] for n in names])
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (loss.detach().float().cpu(),
                    {n: gr.float().cpu() for n, gr in zip(names, grads)},
                    time.perf_counter() - t0, batch.input_ids.shape[1])
    loss_err = rel_err(torch, out["cuda"][0], out["cpu"][0])
    errs = {n: rel_err(torch, out["cuda"][1][n], out["cpu"][1][n])
            for n in out["cpu"][1]}
    worst = max(errs, key=errs.get)
    ok = loss_err <= BOUND_TRAIN_LOSS and errs[worst] <= BOUND_TRAIN_GRAD
    spliced = out["cpu"][3] - 1 + cfg.num_video_tokens
    log(f"[small-ref] train: depth-cut full width (CLIP 2 of 3 layers, IV2 2 "
        f"blocks, LLM 2 layers, LoRA r=128 with B != 0, 1 segment, spliced "
        f"length {spliced}), card bf16 kernels vs host fp32 plain versions: "
        f"loss {float(out['cuda'][0]):.5f} vs {float(out['cpu'][0]):.5f} "
        f"rel {loss_err:.3e} (<= {BOUND_TRAIN_LOSS}); gradient rel L2 over "
        f"{len(errs)} trainable leaves: max {errs[worst]:.3e} ({worst}), "
        f"median {float(np.median(list(errs.values()))):.3e} (<= "
        f"{BOUND_TRAIN_GRAD}); host {out['cpu'][2]:.1f} s, card "
        f"{out['cuda'][2]:.2f} s {'OK' if ok else 'FAIL'}")
    log("[small-ref] train gradients: " + ", ".join(
        f"{n} {e:.2e}" for n, e in sorted(errs.items())))
    if not ok:
        raise AssertionError("training on the card disagrees with the host "
                             "reference")
    del params, out
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def run_path(torch, kernels, name, fn, expect_fn):
    """Counts to 0, run fn() → timings, read the counts, hold them against
    expect_fn(timings)."""
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = fn()
    got = {n: k.launches for n, k in kernels.items()}
    want = expect_fn(t)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = max(t["decode_steps"], 1)
    log(f"[path] {name}: prompt_tokens={t['prompt_len']} "
        f"new_tokens={t['new_tokens']} decode_steps={t['decode_steps']} "
        f"encode_ms={t['encode'] * 1e3:.1f} prefill_ms={t['prefill'] * 1e3:.1f}"
        f" decode_ms={t['decode'] * 1e3:.1f} decode_ms_per_step="
        f"{t['decode'] * 1e3 / steps:.2f} peak_device_memory={peak:.2f} GiB")
    log(f"[path] {name}: launches {got} expected {want}")
    if got != want:
        raise AssertionError(f"{name}: launch counts {got}, expected {want}")
    return got


def train_path(torch, kernels, params, tok, temporal, spatial):
    """The training path: vlm_config("phi3.5", stage="grounded") at full
    width on the given bf16 weights with LoRA r=128 attached (B != 0), the
    grounded preset with a global batch
    of 2 in microbatches of 1 (grad_accum 2), LoRA dropout 0.05, remat on,
    four samples truncated by collate at max_txt_len 4096, two optimizer
    steps through TrainingStrategy.run_training. Counts to 0 just before,
    read just after. Raises unless loss and grad_norm are finite, the first
    step changed nothing (lr 0), the second moved every trainable leaf,
    every frozen leaf is bit-equal to its value before, and the launch
    counts are the config's. → (launches, per-step records)."""
    import dataclasses
    import tempfile

    from grounded_video_llm_tpu_torch.core.config import (STAGE_PRESETS,
                                                          vlm_config)
    from grounded_video_llm_tpu_torch.data.collate import collate
    from grounded_video_llm_tpu_torch.models import vlm
    from grounded_video_llm_tpu_torch.text.templates import get_template
    from grounded_video_llm_tpu_torch.train import lora as lora_mod
    from grounded_video_llm_tpu_torch.train.optimizer import tree_items
    from grounded_video_llm_tpu_torch.train.strategy import TrainingStrategy

    cfg = vlm_config("phi3.5", stage="grounded")
    # adapters as a run mid-stage has them: B != 0. At B = 0 (a fresh
    # attach) dL/dA is 0 until B has moved, so A could not move in step 2.
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 7)
    lora = lora_mod.init_lora(cfg.llm, generator=g, device="cuda",
                              dtype=torch.bfloat16)
    for la in lora.values():
        la["b"].normal_(0.0, 0.02, generator=g)
    params["llm"] = lora_mod.attach_lora(params["llm"], lora)
    orig = STAGE_PRESETS["grounded"]
    STAGE_PRESETS["grounded"] = dataclasses.replace(
        orig, global_batch_size=2, per_device_batch_size=1, epochs=1)
    samples = train_samples(temporal, spatial, 4, 40, SEED)
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        strat = TrainingStrategy(cfg, "grounded", params, tok,
                                 run_dir=run_dir, n_train_examples=4,
                                 seed=SEED)
        if strat.grad_accum != 2:
            raise AssertionError(f"grad_accum {strat.grad_accum}, expected 2")
        tp = strat.state.params
        before = {n: t.detach().to("cpu", copy=True)
                  for n, t in tree_items(tp)}
        trainable = {n for n in before if strat.optimizer.trainable(n)}
        steps = []
        clock = {}

        def on_step(step, m):
            torch.cuda.synchronize()
            now = time.perf_counter()
            rec = dict(m, step=step, seconds=now - clock["t"],
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            steps.append(rec)
            log(f"[path] train step {step}: loss={m['loss']:.5f} grad_norm="
                f"{m['grad_norm']:.4f} step_s={rec['seconds']:.3f} "
                f"s_per_sample={rec['seconds'] / 2:.3f} "
                f"peak_device_memory={rec['peak_gib']:.2f} GiB")
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
                raise AssertionError(f"step {step}: non-finite loss or "
                                     "grad_norm")
            changed = {n for n, t in tree_items(tp)
                       if not torch.equal(t.detach().cpu(), before[n])}
            if step == 1 and changed:
                raise AssertionError(f"step 1 (lr 0) changed {sorted(changed)}")
            if step == 2:
                frozen_moved = sorted(changed - trainable)
                still = sorted(trainable - changed)
                log(f"[path] train after step 2: {len(changed)} of "
                    f"{len(trainable)} trainable leaves moved, "
                    f"{len(before) - len(trainable)} frozen leaves "
                    f"bit-equal: {not frozen_moved}")
                if frozen_moved or still:
                    raise AssertionError(f"frozen leaves moved {frozen_moved}"
                                         f", trainable leaves still {still}")
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            clock["t"] = time.perf_counter()

        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        clock["t"] = time.perf_counter()
        strat.run_training(samples, resume_interval=0, on_step=on_step)
        got = {n: k.launches for n, k in kernels.items()}
        nl = cfg.llm.num_layers
        per_mb = {"flash_fwd": (cfg.clip.num_layers + cfg.clip.feature_layer
                                + 1) + cfg.video.num_blocks_used + 2 * nl,
                  "flash_bwd": nl}
        microbatches = 2 * strat.grad_accum
        want = {n: microbatches * per_mb.get(n, 0) for n in kernels}
        log(f"[path] train grounded B=1 accum=2: launches {got} expected "
            f"{want} (per microbatch flash_fwd = CLIP "
            f"{cfg.clip.num_layers + cfg.clip.feature_layer + 1} + IV2 "
            f"{cfg.video.num_blocks_used} + LLM {nl} + remat recompute {nl},"
            f" flash_bwd = {nl}; {microbatches} microbatches)")
        if len(steps) != 2 or got != want:
            raise AssertionError(f"train path: {len(steps)} steps, launches "
                                 f"{got}, expected 2 steps and {want}")

        # phase split of one more microbatch (outside the counted run)
        mb = collate(samples[:1], tok, get_template("phi3.5"),
                     max_txt_len=cfg.max_txt_len, device="cuda")
        S_text = mb.input_ids.shape[1]
        names = [n for n, _ in tree_items(tp) if strat.optimizer.trainable(n)]
        flat = dict(tree_items(tp))

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        with torch.no_grad():
            _, enc_s = timed(lambda: vlm.encode_video(
                tp, cfg, mb.spatial_pixels, mb.temporal_pixels))
        loss, fwd_s = timed(lambda: vlm.forward_loss(
            tp, cfg, mb, remat=True, lora_dropout=0.05, dropout_seed=1))
        _, bwd_s = timed(lambda: torch.autograd.grad(
            loss, [flat[n] for n in names]))
        del loss
        flops = train_step_flops(tp, cfg, 1, S_text)
        # the last step is the steady one: step 1 also waits for the
        # loader's first batch and the first allocations
        step_s = steps[-1]["seconds"]
        per_sample = step_s / 2
        log(f"[path] train phases of one microbatch (S_text={S_text}, spliced"
            f" {S_text - 1 + cfg.num_video_tokens}): encode_s={enc_s:.3f} "
            f"forward_loss_s={fwd_s:.3f} (encode included) backward_s="
            f"{bwd_s:.3f}; step 2 {step_s:.3f} s = 2 microbatches "
            f"{2 * (fwd_s + bwd_s):.3f} s + optimizer and the rest "
            f"{step_s - 2 * (fwd_s + bwd_s):.3f} s; model TFLOP per sample "
            f"{flops / 1e12:.1f} (bench_train.py formula), step 2 "
            f"{per_sample:.3f} s per sample = {flops / per_sample / 1e12:.1f}"
            f" TFLOP/s = {flops / per_sample / BF16_OPS:.3f} of 989 TFLOP/s")
        return got, steps
    finally:
        STAGE_PRESETS["grounded"] = orig
        import shutil

        shutil.rmtree(run_dir, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from grounded_video_llm_tpu_torch.cli.model_loading import (
        build_params, build_tokenizer)
    from grounded_video_llm_tpu_torch.core.config import (GenerateConfig,
                                                          vlm_config)
    from grounded_video_llm_tpu_torch.models import llm, vlm
    from grounded_video_llm_tpu_torch.ops import cache_write as cw
    from grounded_video_llm_tpu_torch.ops import cuda_build
    from grounded_video_llm_tpu_torch.ops import decode_attention_int8 as da
    from grounded_video_llm_tpu_torch.ops import flash_attention as fa
    from grounded_video_llm_tpu_torch.ops import int8_matmul as mm
    from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine

    # fp32 references below must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")

    # ---- 2. the build: one nvcc per source, all at once
    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_bwd": fa.FLASH_BWD,
               "int8_gemv": mm.INT8_GEMV,
               "int8_matmul": mm.INT8_MATMUL,
               "decode_attention_int8": da.DECODE_ATTENTION_INT8,
               "scatter_write": cw.SCATTER_WRITE}
    t0 = time.perf_counter()
    seconds = cuda_build.build_all(list(kernels.values()))
    for k in kernels.values():
        k.function()
    log(f"[build] {len(seconds)} sources built in parallel in "
        f"{time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{n} {s:.1f} s" for n, s in seconds.items()))
    logs = {k.source.name: k.build_log for k in kernels.values()}
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {src}: {line.strip()}")

    cfg = vlm_config("phi3.5", stage="inference")
    tok = build_tokenizer(cfg)
    gen_cfg = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False)
    gen_int8 = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False,
                              quantize_cache=True)
    duration = 96.0
    t0 = time.perf_counter()
    params = build_params(cfg, "cuda", torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    log(f"[params] full-width phi3.5 bf16 built on the card in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    bf16 = InferenceEngine(params, cfg, tok, gen_cfg, seed=SEED)
    # the engine's own prefill length for the first request
    S_pre = (len(bf16.tokenize_prompt(bf16.build_prompt(
        MODES[0][1], MODES[0][0], duration))) - 1 + cfg.num_video_tokens)
    max_len = -(-(S_pre + MAX_NEW_TOKENS) // 128) * 128

    # ---- 3. kernels vs plain versions at the path's shapes
    flash, per_req = flash_phase(torch, fa, cfg, S_pre)
    # the grounded train microbatch: max_txt_len text tokens, one of them
    # the video slot
    S_train = vlm_config("phi3.5", stage="grounded").max_txt_len - 1 \
        + cfg.num_video_tokens
    k7 = flash_bwd_phase(torch, fa, cfg, S_train)
    k3, k6 = gemv_phase(torch, mm, cfg)
    k4 = attention_phase(torch, da, cfg, max_len)
    k5 = write_phase(torch, cw, cfg, max_len)
    families = {f.name: f for f in (flash, k7, k3, k6, k4, k5)}

    # ---- 4. small references
    for quantize in (None, "int8", "int8_full"):
        small_reference(torch, cfg, SEED, quantize)
    small_reference_train(torch, cfg, SEED)

    # ---- 5. main path
    frames = synthetic_video(SEED, cfg.num_frames)
    t0 = time.perf_counter()
    temporal, spatial = bf16.preprocess_frames(frames)
    log(f"[path] host resize of the 96 frames, once: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    nl = cfg.llm.num_layers
    zero = {n: 0 for n in kernels}
    launches = dict(zero)

    def prompts(pairs, engine):
        return [engine.build_prompt(p, m, duration) for m, p in pairs]

    def generate(engine, batch, g):
        def fn():
            texts = engine.generate(prompts(batch, engine), temporal, spatial,
                                    g)
            for (m, _), text in zip(batch, texts):
                r = engine._result(text, duration)
                log(f"[path]   {m}: text={r.text!r} parsed={r.parsed!r} "
                    f"intervals={r.intervals}")
            return engine.last_timings
        return fn

    def expect(flash_n, w8a8_per_step, quant_cache, k6_per_step):
        def fn(t):
            s = t["decode_steps"]
            return dict(zero, flash_fwd=flash_n,
                        int8_gemv=w8a8_per_step * s,
                        decode_attention_int8=nl * s if quant_cache else 0,
                        scatter_write=s if quant_cache else 0,
                        int8_matmul=(1 + k6_per_step * s) if k6_per_step
                        else 0)
        return fn

    got = run_path(torch, kernels, "bf16 B=1", generate(bf16, [MODES[0]],
                                                         gen_cfg),
                   expect(per_req, 0, False, 0))
    launches = {k: launches[k] + got[k] for k in launches}

    full = InferenceEngine(params, cfg, tok, gen_int8, seed=SEED,
                           quantize="int8_full")
    batch6 = [x for pair in zip(MODES, MODES_2) for x in pair]
    got = run_path(torch, kernels, "A int8_full int8-cache B=6", generate(
        full, batch6, gen_int8), expect(per_req, 4 * nl, True, 1))
    launches = {k: launches[k] + got[k] for k in launches}
    # outputs of mode A's model: right shapes, finite
    with torch.inference_mode():
        feats = vlm.encode_video(
            full.params, cfg, torch.from_numpy(spatial[None]).cuda(),
            torch.from_numpy(temporal[None]).cuda())
        ids = full.tokenize_prompt(prompts([MODES[0]], full)[0])
        input_ids = torch.tensor([ids], device="cuda")
        embeds, _, m = vlm.splice_multimodal(
            input_ids, None, torch.ones_like(input_ids), feats,
            full.params["llm"]["embed"])
        cache = llm.QuantKVCache.create(cfg.llm, 1, embeds.shape[1] + 128,
                                        device="cuda")
        logits, cache = llm.prefill(full.params["llm"], cfg.llm, embeds, m,
                                    cache)
    want_f = (1, cfg.num_video_tokens, cfg.llm.hidden_size)
    want_l = (1, cfg.llm.padded_vocab_size)
    good = (tuple(feats.shape) == want_f and tuple(logits.shape) == want_l
            and bool(torch.isfinite(feats).all())
            and bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(cache.k_scale).all()))
    log(f"[main] int8_full video features {tuple(feats.shape)} (want "
        f"{want_f}), prefill logits {tuple(logits.shape)} (want {want_l}), "
        f"finite: {good}")
    if not good:
        raise AssertionError("main path outputs are malformed")
    del full, feats, logits, cache, embeds
    torch.cuda.empty_cache()

    weight_only = InferenceEngine(params, cfg, tok, gen_cfg, seed=SEED,
                                  quantize="int8")
    for name, g, x in (
            ("B int8 int8-cache B=1", gen_int8,
             expect(per_req, 0, True, 4 * nl + 1)),
            ("C int8 bf16-cache B=1", gen_cfg,
             expect(per_req, 0, False, 4 * nl + 1))):
        got = run_path(torch, kernels, name, generate(weight_only, [MODES[0]],
                                                      g), x)
        launches = {k: launches[k] + got[k] for k in launches}
    del weight_only, bf16
    torch.cuda.empty_cache()

    # ---- 6. the training path, on the same bf16 weights
    got, _ = train_path(torch, kernels, params, tok, temporal, spatial)
    launches = {k: launches[k] + got[k] for k in launches}
    log(f"[main] launches over every path: {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    rows = []
    for name, fam in families.items():
        bms, by = fam.bound()
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": fam.max_err, "ms": fam.ms,
            "plain_ms": fam.plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": fam.library_ms})
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
