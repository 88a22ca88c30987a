#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (grounded_video_llm_tpu_torch) on one
NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py            # full run, one card, exits 0 on success

Phases, each printed on its own lines; any failure raises (exit code != 0):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the build: every kernel source in csrc/, one nvcc each, all at once;
   ptxas registers and spills per kernel instantiation (mangled name);
   [sass] lines from cuobjdump: each library's wgmma (HGMMA bf16, IGMMA
   int8), TMA load (UTMALDG), bulk copy (UBLKCP) and mma.sync (HMMA, IMMA)
   counts, and one line for each instantiation of the 20 flash_fwd_kernels,
   the 16 flash backward kernels (dq and dk/dv), the 12 fused-block GEMM
   kernels and the 6 of the same GEMM behind M3 and M3d, each of which must
   run wgmma and TMA loads and no mma.sync, of the 8 int8-cache attention
   kernels (K4, K8: 4 head dims each), which must run bulk (or TMA)
   copies, and K8's tensor-core products, and of the 6 int8 decode product
   kernels (K3/K6, and M1 on K3's w8a8 ones: w8a8 and weight-only at 8,
   16 and 32 rows), which must run TMA loads and mma.sync (IMMA, HMMA);
3. each kernel against its plain PyTorch version at the serving path's
   shapes, with its error against a bound and CUDA-event medians of the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call, next to the least time the card could take (the
   flash forward's, M2's, the int8 kernels' and the cache write's device
   times, and SDPA's beside them, come from CUDA-graph replays, so the
   Python wrappers' launch cost is left out; where it matters it is
   printed beside them):
   flash_fwd (K1/K2: CLIP, InternVideo2 bounded, prefill causal, B=2
   left-padded, edge cases including a tile-aligned causal square with a
   q_offset off the tile grid; with M2's cases every instantiation runs); flash_bwd (K7: the grounded training shape
   [1, 7515, 32, 96] causal with a right-padded mask, its plain version run
   kv head by kv head, SDPA's causal backward (no mask: where the padded
   rows carry no gradient, as the training loss leaves them, it gives the
   same dq, dk, dv) and its masked backward beside it, all graph-replayed;
   B=2 with right paddings; GQA with 8 kv heads of 128, non-causal D=88, a
   window, an explicit q_offset, left padding with dead rows whose dq must
   be exactly 0, and the other (head dim, causal) instantiations; every
   case launched twice, bit-equal); the one int8_matmul wrapper over the
   two C entries of its kernel, w8a8 (int8_gemv, K3's w8a8 branch,
   bit-equal to its plain version) and weight-only (int8_matmul, K6 and
   K3's weight-only branch): both at M 1, 6, 30 and 255 on the four
   Phi-3.5 projections, weight-only also at the same M on O 9216 and the
   lm_head's 32,366, and both off the kernel's tile grids; every case
   launched twice, bit-equal; one call of each branch captured in a CUDA
   graph must be one device kernel; timed per decode step (M 6
   w8a8, M 1 weight-only) and per verify pass (M 30, lm_head included)
   beside torch._int_mm and torch._weight_int8pack_mm; the int8 -> bf16
   conversion of K4 and K8 on all
   256 byte values; decode_attention_int8 (K4: B 1 and 6, 32 heads of 96,
   3,840 slots, ragged masks, each timed on its mask and with every slot
   visible; ATTENTION_CASES: every G and D the C entry takes, L off the
   cluster's slot grid, whole chunks no query sees, L past the one-block
   design's cap) and scatter_write (K5: ragged slots, untouched bytes, same
   storage); verify_attention_int8 (K8: path D's [6, 5, 32, 96] queries
   over 3,840 slots, timed the same two ways, then VERIFY_CASES: S = 1,
   S = 8, GQA 4 with D = 128, an empty cache mask, a per-query window,
   every G and D, masked chunks, 40 queries, L past the old cap); every K4
   and K8 case launched twice, bit-equal; scatter_write_multi (K9: 5 slots per row from ragged
   bases, one at the array edge and one running past it, untouched bytes,
   same storage; then 128 and 1 slots at the same buffers); the fused W8A8 InternVideo2 GEMMs (K10:
   fused_norm_quant_gemm for qkv with qk_norm and fc1 with GELU,
   fused_quant_gemm_ls_residual for proj and fc2, at path D's 147,528
   rows (six videos in one encode) and at 300, each beside the unfused
   W8A8 chain, both graph-replayed); the microbenchmarks' kernels:
   int8_gemm and int8_gemm_dynamic (M3, M3d, on K10's GEMM:
   8192x1408x6144 and its transpose graph-replayed, each device kernel's
   share, beside torch._int_mm plus the rescale, bf16 torch.matmul and
   _int_mm alone; then ragged M, one row, K = 64, N = 384, K past 6,144, so
   every tile width runs; M3 bit-equal, every case launched twice
   bit-equal, the plan's device kernels a call), i8i8_gemv (M1 on K3's
   w8a8 kernel: M 1, 6, 16 on the three Phi-3.5 projections, bit-equal,
   launched twice bit-equal, one device kernel a call, beside K3's w8a8
   int8_gemv and _int_mm) and flash_variant (M2: full,
   offset, noexp, sumdot at [12, 16, 2049, 88], dh128, and every mode on a
   ragged case at each head dim, on unit normal q/k/v, beside SDPA; two
   wrong softmaxes held to the same bars must fail them);
4. small references, a depth-cut full-width model on the card (kernels)
   against the same weights on the host (plain versions): bf16 (card) vs
   fp32 (host), then int8 and int8_full with the int8 cache (same int8
   weights on both sides): video features, prefill logits, one decode
   step's logits; speculative verify (LLM 2 layers, int8_full, int8 cache):
   verify_step + commit_verify on the card with K8 and K9 held to their
   plain versions on the inputs verify_step gave them in every layer (K8
   within its bar, the written caches and committed slots bit-equal),
   logits against the host and against 5 sequential decode steps (their
   committed caches printed); a two-block
   fused W8A8 InternVideo2 trunk card vs host; a two-block W8A8 trunk with
   static activation scales calibrated on the card, card vs host;
   serve/quant_ab (bf16 vs int8_full with static scales) on the depth-cut
   model, its metrics as readings; then one grounded training
   microbatch with LoRA attached (B != 0): the loss and every trainable
   leaf's gradient;
5. the main path, full-width Phi-3.5 (vlm_config("phi3.5",
   stage="inference"), seeded random weights) on one seeded synthetic
   96-frame video resized once: a bf16 request, then the int8 modes through
   InferenceEngine.generate, greedy, 32 new tokens:
     A  quantize="int8_full", int8 KV cache, B = 6 prompts (each of the three
        modes twice, different text, ragged left padding);
     B  quantize="int8", int8 KV cache, B = 1;
     C  quantize="int8", bf16 KV cache, B = 1;
     D  path A's batch with GVLLM_FUSED_IV2=1 (set only around it) and
        spec_draft_len=4, greedy: the fused W8A8 IV2 blocks (K10), then
        verify passes (K8, K9, K3, K6); then an oracle-table leg and a
        sampled leg through generate_tokens_spec_from_features on its
        features;
     E  path A's batch with static_scales=True: one calibration on the
        first request's pixels (39 more K1 launches), x_scale on fc2 and
        proj of every block, otherwise path A's launch counts, no K10.
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
   of one more microbatch and the model-FLOP share;
7. the microbenchmarks, the path of M1, M2, M3 and M3d: each module of
   grounded_video_llm_tpu_torch/microbench (int8_gemm, decode,
   encoder_attn, static_scales with one round, flash_bwd, iv2_block) once
   at its TPU script's shapes, counted like a path (the counts must equal
   those the modules' shapes, variants and repetitions give); their lines
   are printed;
8. llama3 and vicuna, every Phi-3.5 tree and engine freed first: the
   depth-cut references of phase 4 (bf16 and int8_full) for both; then
   full-width llama3 (vlm_config("llama3", stage="inference"):
   Meta-Llama-3-8B, 32 layers, 32 heads and 8 kv heads of 128; the same
   encoders), seeded random bf16 weights, on the frames phase 5 resized:
   one bf16 B=1 encode whole and with encoder_chunk_clips=4 (features
   within relative L2 1e-6, each run's peak memory); K2, K3's w8a8 branch,
   K4 (G = 4) and K6 (128,558 rows) at llama3's own shapes, timed beside
   their plain versions, library calls and bounds; a bf16 B=1 request
   (94 flash launches) and a mode A request (int8_full, int8 cache, B=6:
   per step 128 w8a8 int8_gemv, 32 K4, 1 K5, 1 lm_head; 1 K6 a request),
   their launch counts held to the config's, their phase split, prefill
   length and peak memory printed, their tokens in the vocabulary. Before
   them: the depth-cut training reference of phase 4 for llama3; K2 and K7
   at llama3's grounded training shape [1, 6411, 32, 128] with 8 kv heads
   (the spliced length printed), held to their plain versions, K7 launched
   twice bit-equal, graph-timed beside SDPA's fastest causal forward and
   backward (enable_gqa or K/V expanded, named) and the bound; and the
   reference-format round trip: a full-width llama3 tree (LLM 2 of 32
   layers, CLIP 2 of 24, InternVideo2 2 of 40 blocks; width, vocabulary
   and the q/k/v split kept) written in the weights-day layout by
   models/export.write_weight_dumps and read back by build_params
   (weight_root, video_encoder_path, stage_ckpt) onto the card, every leaf
   bit-equal to the bf16 source, bytes and seconds printed;
9. llama3 grounded training on phase 8's full-width bf16 weights (the
   training path of phase 6 for vlm_config("llama3", stage="grounded"):
   LoRA r=128 with B != 0, two steps of two microbatches, the same checks
   and launch counts, s/sample, the model-FLOP share, peak memory); then
   the trained strategy's export_reference_checkpoint read by
   build_params(stage_ckpt=) over the seeded frozen tree: projectors,
   embed and lm_head bit-equal to the trained ones, every other leaf to
   the run's; one bf16 B=1 request on that tree (94 flash launches, tokens
   in the vocabulary). The checkpoint files are written under
   build/chip_smoke_checkpoints/ and removed after each check.

The last three lines are the card, one JSON object describing the kernels,
and {"ok": true, "device": {...}}. Without a CUDA device the script exits
with code 2 and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np

SEED = 0
MAX_NEW_TOKENS = 32
SPEC_DRAFT_LEN = 4      # path D: drafts per verify pass
GRAPH_CALLS = 20        # launches per timed CUDA graph (flash, K7, M2, K5/K9)
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
    "verify_attention_int8": f"{PKG}/csrc/verify_attention_int8.cu",
    "scatter_write_multi": f"{PKG}/csrc/cache_write.cu",
    "fused_norm_quant_gemm": f"{PKG}/csrc/fused_block.cu",
    "fused_quant_gemm_ls_residual": f"{PKG}/csrc/fused_block.cu",
    "i8i8_gemv": f"{PKG}/csrc/int8_matmul.cu",
    "flash_variant": f"{PKG}/csrc/flash_fwd.cu",
    "int8_gemm": f"{PKG}/csrc/int8_gemm.cu",
    "int8_gemm_dynamic": f"{PKG}/csrc/int8_gemm.cu",
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
    "verify_attention_int8": "grounded_video_llm_tpu/ops/"
                             "decode_attention_int8.py:357 "
                             "(verify_attention_int8) + :418 "
                             "(verify_attention_int8_layer); _kernel_multi "
                             "at :230",
    "scatter_write_multi": "grounded_video_llm_tpu/ops/cache_write.py:122 "
                           "(scatter_write_kv_multi) + :159 "
                           "(scatter_write_scale_multi); _write_multi_kernel"
                           " at :81",
    "fused_norm_quant_gemm": "grounded_video_llm_tpu/ops/fused_block.py:159 "
                             "(fused_norm_quant_gemm, pallas_call; "
                             "_nqg_kernel at :91)",
    "fused_quant_gemm_ls_residual": "grounded_video_llm_tpu/ops/"
                                    "fused_block.py:225 "
                                    "(fused_quant_gemm_ls_residual, "
                                    "pallas_call; _qglr_kernel at :182)",
    "i8i8_gemv": "scripts/microbench_decode.py:85 (i8i8_matmul, pallas_call;"
                 " _i8i8_kernel at :64)",
    "flash_variant": "scripts/microbench_encoder_attn.py:174 (flash_variant,"
                     " pallas_call; _kernel at :47)",
    "int8_gemm": "scripts/microbench_int8_gemm.py:128 (pallas_call in "
                 "pallas_i8; _pl_kernel at :120)",
    "int8_gemm_dynamic": "scripts/microbench_int8_gemm.py:165 (pallas_call "
                         "in pallas_dyn; _pl_dyn_kernel at :154)",
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


def graph_ms(torch, fn, reps: int = 20, calls: int = 1) -> float:
    """Device milliseconds of fn(): fn is captured `calls` times in a CUDA
    graph and the replays are timed by CUDA events, so the host's launch
    overhead (the Python wrappers) is not counted; with calls > 1 a
    replay's own overhead (~8 us on an H100) is spread over the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(torch, graph.replay, reps) / calls
    del graph
    torch.cuda.empty_cache()
    return ms


def short_entry(mangled: str) -> str:
    """A kernel's mangled name without its anonymous namespace and its
    parameter list: "16flash_fwd_kernelILi88ELb0ELi1EEE" (D 88, not causal,
    mode 1)."""
    ns = re.match(r"_ZN(\d+)_GLOBAL__N", mangled)
    if ns:
        mangled = mangled[len("_ZN") + len(ns.group(1)) + int(ns.group(1)):]
    return re.sub(r"(E+)v?[PN0-9].*$", r"\1", mangled)


SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "UBLKCP", "HMMA", "IMMA")


def sass_counts(text: str) -> dict:
    """{short entry name: {opcode: count}} for the SASS opcodes in SASS_OPS,
    from `cuobjdump -sass` output: wgmma is HGMMA (bf16) or IGMMA (int8),
    a TMA tensor load UTMALDG, a bulk copy (cp.async.bulk) UBLKCP, mma.sync
    HMMA (bf16) or IMMA (int8)."""
    counts, cur = {}, None
    for line in text.splitlines():
        found = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if found:
            cur = counts.setdefault(short_entry(found.group(1)),
                                    dict.fromkeys(SASS_OPS, 0))
            continue
        op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                      line)
        if cur is not None and op and op.group(1) in cur:
            cur[op.group(1)] += 1
    return counts


# the kernels whose SASS is held to a rule: (library, entry-name fragment,
# groups of opcodes each of which must count one, opcodes that must not
# appear). The flash kernels and the int8 GEMM for large M (K10 in
# libfused_block, M3 / M3d in libint8_gemm): wgmma and TMA loads, no
# mma.sync; the int8-cache attention (K8, K4): bulk copies, and K8's
# products on tensor cores; the int8 decode products (K3, K6, and M1 on
# K3's w8a8 kernel): TMA loads and mma.sync, int8 (IMMA) for w8a8, bf16
# (HMMA) for weight-only
_WGMMA_RULE = (("UTMALDG",),)
SASS_REQUIRED = (
    ("libflash_fwd.so", "flash_fwd_kernel", (("HGMMA",),) + _WGMMA_RULE,
     ("HMMA", "IMMA")),
    ("libflash_bwd.so", "flash_bwd_dq_kernel", (("HGMMA",),) + _WGMMA_RULE,
     ("HMMA", "IMMA")),
    ("libflash_bwd.so", "flash_bwd_dkv_kernel", (("HGMMA",),) + _WGMMA_RULE,
     ("HMMA", "IMMA")),
    ("libfused_block.so", "gemm_kernel", (("IGMMA",),) + _WGMMA_RULE,
     ("HMMA", "IMMA")),
    ("libint8_gemm.so", "gemm_kernel", (("IGMMA",),) + _WGMMA_RULE,
     ("HMMA", "IMMA")),
    ("libverify_attention_int8.so", "attention_kernel",
     (("HMMA", "HGMMA"), ("UBLKCP", "UTMALDG")), ()),
    ("libdecode_attention_int8.so", "attention_kernel",
     (("UBLKCP", "UTMALDG"),), ()),
    ("libint8_matmul.so", "int8_mm_kernelILb1", (("IMMA",), ("UTMALDG",)),
     ("HMMA", "HGMMA", "IGMMA")),
    ("libint8_matmul.so", "int8_mm_kernelILb0", (("HMMA",), ("UTMALDG",)),
     ("IMMA", "HGMMA", "IGMMA")))


def sass_ok(lib: str, name: str, c: dict):
    """None where no rule names the kernel, else whether its opcode counts
    pass its rule."""
    for rule_lib, frag, needs, forbid in SASS_REQUIRED:
        if lib == rule_lib and frag in name:
            return (all(any(c[op] > 0 for op in group) for group in needs)
                    and not any(c[op] for op in forbid))
    return None


def sass_phase(kernels) -> None:
    """One [sass] line per kernel library (its opcode totals), one per
    instantiation of the flash forward (K1/K2/M2), the flash backward's two
    kernels (K7), the int8 GEMM for large M (K10, M3, M3d), the
    int8-cache attention (K4, K8) and the int8 decode products (K3, K6 and
    M1); fails unless each of those passes its rule in SASS_REQUIRED (wgmma
    of its type and TMA loads and no mma.sync; K8 mma.sync
    or wgmma and bulk or TMA copies, K4 bulk or TMA copies; K3/K6 TMA loads
    and mma.sync of the branch's type) and each rule finds a kernel."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = sorted({k.library_path() for k in kernels.values()})
    bad, seen = [], set()
    for lib in libs:
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        counts = sass_counts(text)
        total = {op: sum(c[op] for c in counts.values()) for op in SASS_OPS}
        log(f"[sass] {lib.name}: {len(counts)} kernels, "
            + " ".join(f"{op}={n}" for op, n in total.items()))
        for name, c in counts.items():
            ok = sass_ok(lib.name, name, c)
            if ok is None:
                continue
            seen |= {(r, f) for r, f, *_ in SASS_REQUIRED
                     if r == lib.name and f in name}
            log(f"[sass] {lib.name} {name}: "
                + " ".join(f"{op}={n}" for op, n in c.items())
                + f" {'OK' if ok else 'FAIL'}")
            if not ok:
                bad.append(name)
    missing = {(r, f) for r, f, *_ in SASS_REQUIRED} - seen
    if bad or missing:
        raise AssertionError(f"kernels failing their [sass] rule: {bad}; "
                             f"no kernel for {missing}")


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
                q_offset=None, expect_dead=False, seed=0, timed=True):
    """Kernel vs plain version at one shape → dict of measured numbers.
    pads: per batch row, how many leading keys the keep-mask removes;
    expect_dead: whether that leaves query rows with no valid key;
    q_offset: the first query's position (None: Sk - Sq)."""
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
                            has_bias, q_offset)

    def plain():
        return fa.flash_fwd_reference(q, k, v, bias, scale, causal, bounded,
                                      window, has_bias, q_offset)

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
        has_bias, q_offset)
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
    # kernel and SDPA alike: device time from graph replays
    ms = graph_ms(torch, kernel, 10, GRAPH_CALLS) if timed else nan
    plain_ms = cuda_ms(torch, plain, 5) if timed else nan
    lib_ms = (graph_ms(torch, library, 10, GRAPH_CALLS)
              if timed and not causal else nan)
    if timed and causal and bias is not None and B == 1 and not pads[0]:
        # an all-keep mask: SDPA's own causal path is the same function
        bias = None
        lib_ms = graph_ms(torch, library, 10, GRAPH_CALLS)
    # least time: q, k, v, bias read once, o and lse written once; the
    # products' flops (causal: the half the mask keeps)
    nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Sk * Hkv * D) + 4 * B * H * Sq
    flops = 4 * B * H * Sq * Sk * D * (0.5 if causal else 1.0)
    bms, by = bound_ms(nbytes, flops, BF16_OPS)
    log(f"[kernel] flash_fwd {name:<20} q={[B, Sq, H, D]} kv={[B, Sk, Hkv, D]} "
        f"causal={causal} bounded={bounded} window={window} "
        f"q_offset={Sk - Sq if q_offset is None else q_offset} "
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


# Cases the wrapper accepts beyond the slice's shapes: the llama head dim
# with GQA and a window that bites, a rectangular causal block, a fully
# masked batch row without causality, bounded mode with a bias, a sequence
# shorter than one tile, a causal D = 88 block whose first three rows see
# no key (the mask removes three keys), and a tile-aligned causal
# square whose q_offset (37) puts the diagonal inside every key tile.
FLASH_EDGE_CASES = (
    ("gqa_d128_window", dict(B=2, Sq=300, H=32, Hkv=8, D=128, causal=True,
                             window=64, pads=(0, 50), expect_dead=True)),
    ("causal_rect", dict(B=1, Sq=100, Sk=333, H=4, D=96, causal=True,
                         pads=(7,))),
    ("noncausal_dead_row", dict(B=2, Sq=130, H=4, D=64, pads=(0, 130),
                                expect_dead=True)),
    ("bounded_bias", dict(B=2, Sq=200, H=4, D=88, bounded=True,
                          pads=(0, 33))),
    ("tiny", dict(B=1, Sq=1, Sk=5, H=2, D=64, causal=True)),
    ("causal_d88", dict(B=1, Sq=300, H=4, D=88, causal=True, pads=(3,),
                        expect_dead=True)),
    ("aligned_q_offset", dict(B=1, Sq=1024, H=8, D=96, causal=True,
                              q_offset=37)),
)


def flash_cases(cfg, S_pre):
    """Every check_flash case: {name: keyword arguments}. The first three
    are the serving request's shapes (timed, in the kernels line)."""
    cases = {
        "clip": dict(B=12, Sq=cfg.clip.num_patches + 1, H=cfg.clip.num_heads,
                     D=cfg.clip.head_dim, seed=1),
        "internvideo2_bounded": dict(B=12, Sq=cfg.video.seq_len,
                                     H=cfg.video.num_heads,
                                     D=cfg.video.head_dim, bounded=True,
                                     seed=2),
        "prefill_causal": dict(B=1, Sq=S_pre, H=cfg.llm.num_heads,
                               D=cfg.llm.head_dim, causal=True, pads=(0,),
                               seed=3),
        "leftpad_causal_b2": dict(B=2, Sq=1000, H=cfg.llm.num_heads,
                                  D=cfg.llm.head_dim, causal=True,
                                  pads=(0, 237), expect_dead=True, seed=4,
                                  timed=False),
    }
    for i, (name, kw) in enumerate(FLASH_EDGE_CASES):
        cases[name] = dict(kw, seed=100 + i, timed=False)
    return cases


def flash_phase(torch, fa, cfg, S_pre):
    fam = Family("flash_fwd")
    per_req = {"clip": cfg.clip.num_layers + cfg.clip.feature_layer + 1,
               "iv2": cfg.video.num_blocks_used, "prefill": cfg.llm.num_layers}
    cases = flash_cases(cfg, S_pre)
    got = {name: check_flash(torch, fa, name, **kw)
           for name, kw in cases.items()}
    res = {"clip": got["clip"], "iv2": got["internvideo2_bounded"],
           "prefill": got["prefill_causal"]}
    for key, n in per_req.items():
        r = res[key]
        fam.add(n, r["ms"], r["plain_ms"], r["bytes"], r["flops"], "bf16",
                r["library_ms"])
    fam.max_err = max(r["max_abs_err"] for r in got.values())
    bms, by = fam.bound()
    log(f"[kernel] flash_fwd per request ({per_req}): kernel {fam.ms:.3f} ms, "
        f"plain {fam.plain_ms:.3f} ms, sdpa {fam.library_ms:.3f} ms, bound "
        f"{bms:.3f} ms ({by})")
    return fam, sum(per_req.values())


def flash_instantiations(cfg, S_pre):
    """The (D, causal, softmax mode) instantiations of flash_fwd_kernel that
    flash_cases and variant_cases launch (modes as in csrc/flash_fwd.cu: 0
    online, 1 fixed offset, 2 p = s, 3 fixed offset with bf16 sums)."""
    from grounded_video_llm_tpu_torch.ops.flash_attention import VARIANT_MODES
    got = set()
    for kw in flash_cases(cfg, S_pre).values():
        causal = kw.get("causal", False)
        got.add((kw["D"], causal, int(kw.get("bounded", False)
                                      and not causal)))
    for mode, shape, _ in variant_cases(cfg):
        got.add((shape[3], False, VARIANT_MODES[mode]))
    return got


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
    """Library yardstick for K7: scaled_dot_product_attention forward +
    backward minus its forward (sdpa_ms). → (ms, label)."""
    return sdpa_ms(torch, q, k, v, keep, do, scale, reps, forward=False)


def sdpa_forward_ms(torch, q, k, v, scale, reps):
    """Library yardstick for K2: the causal scaled_dot_product_attention
    forward alone (sdpa_ms). → (ms, label)."""
    return sdpa_ms(torch, q, k, v, None, None, scale, reps, forward=True)


def sdpa_ms(torch, q, k, v, keep, do, scale, reps, forward):
    """scaled_dot_product_attention timed in either direction as K2 and K7
    are, by replays of a CUDA graph of GRAPH_CALLS calls: the forward alone
    (forward=True), or forward + backward (torch.autograd.grad) minus the
    forward. keep: the mask as the boolean [B, 1, Sq, Sk] attn_mask SDPA
    takes, or None for is_causal=True with no mask, timed on each backend
    that takes it, the fastest kept. With fewer kv heads than query heads
    each backend is tried with enable_gqa and with K/V expanded to every
    query head inside the timed call (their gradients summed back by the
    expansion's backward), and the label says which ran. → (ms, label)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = None if forward else do.transpose(1, 2)
    G = q.shape[2] // k.shape[2]
    routes = (("enable_gqa", True), ("expanded K/V", False)) if G > 1 else (
        ("", False),)
    backends = ((SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                 SDPBackend.MATH) if keep is not None else
                (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                 SDPBackend.CUDNN_ATTENTION))
    times = []
    for backend in backends:
        for how, gqa in routes:
            try:
                with sdpa_kernel([backend]):
                    def fwd(gqa=gqa):
                        kx, vx = kt, vt
                        if G > 1 and not gqa:
                            kx = kt.repeat_interleave(G, dim=1)
                            vx = vt.repeat_interleave(G, dim=1)
                        return F.scaled_dot_product_attention(
                            qt, kx, vx, attn_mask=keep, scale=scale,
                            is_causal=keep is None, enable_gqa=gqa)

                    def fwd_bwd():
                        out = fwd()
                        return torch.autograd.grad(out, (qt, kt, vt), dot)

                    if forward:
                        with torch.no_grad():
                            fwd()
                            ms = graph_ms(torch, fwd, reps, GRAPH_CALLS)
                    else:
                        fwd_bwd()
                        ms = (graph_ms(torch, fwd_bwd, reps, GRAPH_CALLS)
                              - graph_ms(torch, fwd, reps, GRAPH_CALLS))
            except RuntimeError:
                continue
            times.append((ms, backend.name + (f" {how}" if how else "")))
        if keep is not None and times:
            break
    if not times:
        return float("nan"), "none"
    ms, name = min(times)
    others = ", ".join(f"{n} {t:.4f}" for t, n in times if n != name)
    return ms, name + (f"; {others}" if others else "")


def check_flash_bwd(torch, fa, name, B, Sq, H, D, *, Sk=None, Hkv=None,
                    causal=True, pads=None, left=False, window=None,
                    q_offset=None, expect_dead=False, seed=0, timed=False,
                    reps=10):
    """K7 vs its plain version at one shape → dict of measured numbers.
    o and lse come from the forward kernel, do is random. pads: per batch
    row, how many keys the mask removes (at the end, or at the start with
    left=True); expect_dead: whether that leaves rows with no valid key,
    whose dq must be exactly 0. Two launches on the same inputs must give
    bit-identical dq, dk and dv (K7 is deterministic). Timed, the kernel
    and the SDPA backward are both CUDA-graph replays: SDPA with the same
    mask, and where the mask is causal over a square with right pads only,
    SDPA's causal backward with no mask too, which is then the library
    time: padded keys are seen by padded rows only, so where do is zero on
    the padded rows, as the training loss leaves it, it gives the same dq,
    dk and dv (on this check's random do, the same dq on every other row);
    the masked backends are several times slower."""
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
    again = kernel()
    want = plain()
    torch.cuda.synchronize()
    launched = fa.FLASH_BWD.launches == before + 2
    same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    del again
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
    ok = (finite and launched and dead_zero and same
          and all(r <= b for r, b in zip(rels, BOUND_BWD_REL)))
    pairs = visible_pairs(mask.cpu().numpy(), Sq, Sk, causal, window, q_off)
    flops = 10.0 * D * pairs * H          # five products per visible pair
    nbytes = (2 * (3 * B * Sq * H * D + 2 * B * Sk * Hkv * D)   # q do o k v
              + 4 * B * H * Sq + (4 * B * Sk if bias is not None else 0)
              + 2 * (B * Sq * H * D + 2 * B * Sk * Hkv * D))    # dq dk dv
    bms, by = bound_ms(nbytes, flops, BF16_OPS)
    nan = float("nan")
    ms = plain_ms = lib_ms = masked_ms = nan
    backend = masked_backend = "-"
    if timed:
        ms = graph_ms(torch, kernel, reps, GRAPH_CALLS)
        plain_ms = cuda_ms(torch, plain, 2)
        qpos = torch.arange(Sq, device="cuda")[:, None] + q_off
        kpos = torch.arange(Sk, device="cuda")[None, :]
        keep = mask[:, None, None, :].expand(B, 1, Sq, Sk)
        if causal:
            vis = kpos <= qpos
            if window is not None:
                vis = vis & (qpos - kpos < window)
            keep = keep & vis
        masked_ms, masked_backend = sdpa_backward_ms(
            torch, q, k, v, keep, do, scale, reps)
        del keep
        lib_ms, backend = masked_ms, masked_backend
        if (causal and Sq == Sk and q_off == 0 and not left
                and (window is None or window >= Sk)):
            lib_ms, backend = sdpa_backward_ms(torch, q, k, v, None, do,
                                               scale, reps)
            backend = f"{backend}, is_causal, no mask"
    log(f"[kernel] flash_bwd {name:<22} q={[B, Sq, H, D]} kv={[B, Sk, Hkv, D]}"
        f" causal={causal} window={window} q_offset={q_offset} "
        f"dead_rows={n_dead} dq_dead_rows_zero={dead_zero} "
        f"two_launches_bit_equal={same} "
        f"rel|ddq|={rels[0]:.3e} rel|ddk|={rels[1]:.3e} rel|ddv|={rels[2]:.3e}"
        f" (<= {BOUND_BWD_REL}) max|d|={worst:.3e} visible_pairs={pairs}"
        + (f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
           f"sdpa_bwd_ms={lib_ms:.4f} ({backend}) sdpa_masked_bwd_ms="
           f"{masked_ms:.4f} ({masked_backend}) bound_ms={bms:.4f} ({by}) "
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


# K7's edge cases: with the training shape's (D 96, causal) every (head
# dim, causal) instantiation gvllm_flash_bwd dispatches runs
FLASH_BWD_EDGE_CASES = (
    ("gqa_d128", dict(B=2, Sq=300, H=32, Hkv=8, D=128, pads=(0, 50))),
    ("noncausal_d88", dict(B=2, Sq=2049, H=16, D=88, causal=False,
                           pads=(0, 100))),
    ("window", dict(B=1, Sq=700, H=4, D=96, window=64, pads=(13,))),
    ("q_offset", dict(B=1, Sq=100, Sk=333, H=4, D=96, q_offset=150,
                      pads=(0,))),
    ("leftpad_dead_rows", dict(B=2, Sq=300, H=4, D=96, pads=(0, 77),
                               left=True, expect_dead=True)),
    ("tiny", dict(B=1, Sq=1, Sk=5, H=2, D=64)),
    ("noncausal_d64", dict(B=1, Sq=257, H=4, D=64, causal=False)),
    ("causal_d88", dict(B=1, Sq=333, H=4, D=88, pads=(5,))),
    ("noncausal_d96_rect", dict(B=1, Sq=200, Sk=300, H=4, D=96,
                                causal=False, pads=(7,))),
    ("noncausal_d128", dict(B=1, Sq=130, H=4, Hkv=2, D=128, causal=False)),
)


def flash_bwd_instantiations():
    """The (D, causal) instantiations of K7's two kernels that the training
    shape and FLASH_BWD_EDGE_CASES launch."""
    got = {(96, True)}
    for _, kw in FLASH_BWD_EDGE_CASES:
        got.add((kw["D"], kw.get("causal", True)))
    return got


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
    for i, (name, kw) in enumerate(FLASH_BWD_EDGE_CASES):
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


GEMV_ROWS = (1, 6, 30, 255)   # decode (B = 1, 6), verify (6 x 5), the cap
LM_HEAD_COPIES = 4            # 98 MB each at Phi-3.5's width: past the L2
# shapes off the kernel's grids: O off the 128-column tiles (1,000 is
# ragged for the weight-only branch, 1,008 the w8a8 branch's multiple of
# 16) and D off the 64-row stages
GEMV_EDGE_CASES = ((False, 1000, 3072), (True, 1008, 3072),
                   (False, 1000, 1000), (True, 1008, 1000))
# their rows: 12 takes the kernel's 16-row tiles, 40 two passes, one partial
GEMV_EDGE_ROWS = (6, 12, 30, 40)


def int8_weight(torch, mm, shape, g):
    """Random int8 weights [..., D, O] on the card, stored as the quantizer
    stores them (rows padded to 16 bytes where O is ragged)."""
    w = torch.randint(-127, 128, shape, generator=g, device="cuda",
                      dtype=torch.int8)
    return mm.empty_int8_weight(shape, "cuda").copy_(w) if shape[-1] % 16 \
        else w


def gemv_library_ms(torch, x, w, s, layers, w8a8):
    """(ms, what) of the one PyTorch call per layer that computes the
    branch's product: torch._int_mm on the quantized rows (w8a8; it takes
    more than 16 rows), torch._weight_int8pack_mm (weight-only; its weight
    K-major, transposed once outside the timing, its scales bf16), or
    (None, the error) where the card's build has no such call."""
    M, D = x.shape
    if w8a8:
        x8 = torch.zeros(max(M, 17), D, dtype=torch.int8, device="cuda")
        return graph_ms(torch, lambda: [torch._int_mm(x8, w[i])
                                        for i in range(layers)]) / layers, \
            "_int_mm"
    try:
        w_t = [w[i].t().contiguous() for i in range(layers)]
        s_bf = s.bfloat16()
        torch._weight_int8pack_mm(x, w_t[0], s_bf[0])
        torch.cuda.synchronize()
        return graph_ms(torch, lambda: [
            torch._weight_int8pack_mm(x, w_t[i], s_bf[i])
            for i in range(layers)]) / layers, "_weight_int8pack_mm"
    except RuntimeError as e:
        return None, f"_weight_int8pack_mm: {str(e).splitlines()[0][:100]}"


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h (CUDA 12)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("smem", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernels(torch, fn) -> list:
    """The device operations of one call of fn: the nodes of a CUDA graph
    captured from the call, kernels by their mangled names
    (cuFuncGetName), other nodes as "<node type N>". Exact however the
    kernels overlap."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:                     # CU_GRAPH_NODE_TYPE_KERNEL
            names.append(f"<node type {kind.value}>")
            continue
        p = _KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                               ctypes.byref(p)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.func:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(p.func)), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(p.kern)),
                  "cuKernelGetName")
        names.append(name.value.decode())
    del graph
    torch.cuda.empty_cache()
    return names


def device_kernels(torch, fn):
    """Names of the device kernels one call of fn runs: graph_kernels, the
    nodes of a CUDA graph captured from one call. One torch.profiler
    window around one more call is printed beside them where it lists
    another number: on an H100 such windows have come back short (every
    one of three in a row, on M3's transpose + GEMM chain), so they are no
    count. Returns the names and the number of calls of fn made (one
    captured, one profiled), for the callers' launch counts."""
    from torch.profiler import ProfilerActivity, profile

    names = graph_kernels(torch, fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(seen) != len(names):
        log(f"[profiler] one call: the captured graph holds {len(names)} "
            f"kernels {[short_entry(n) for n in names]}, a torch.profiler "
            f"window listed {len(seen)} {seen}")
    return names, 2


def check_gemv(torch, mm, name, M, D, O, *, layers=1, w8a8=False,
               timed=False, seed=0):
    """mm.int8_matmul vs its plain version on layer 0 of a stacked random
    int8 weight [layers, D, O]: w8a8 bit-equal, weight-only within
    BOUND_GEMV; launched twice, bit-equal, each launch counted by the
    branch's kernel. timed: CUDA-graph replays of one pass over all layers
    (the decode step streams them cold from HBM) → per-call numbers."""
    counter = mm.INT8_GEMV if w8a8 else mm.INT8_MATMUL

    def kernel(x, w, s):
        return mm.int8_matmul(x, w, s, w8a8)

    def plain(x, w, s):
        return mm.int8_matmul_reference(x, w, s, w8a8)

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    w = int8_weight(torch, mm, (layers, D, O), g)
    s = torch.rand(layers, O, generator=g, device="cuda") * 1e-3 + 1e-4
    x = torch.randn(M, D, generator=g, device="cuda").to(torch.bfloat16)
    before = counter.launches
    y = kernel(x, w[0], s[0])
    y2 = kernel(x, w[0], s[0])
    y_ref = plain(x, w[0], s[0])
    torch.cuda.synchronize()
    err = gemv_error(torch, y, y_ref)
    exact = bool(torch.equal(y, y_ref))
    twice = bool(torch.equal(y, y2))
    ok = ((exact if w8a8 else err <= BOUND_GEMV) and twice
          and y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
          and counter.launches == before + 2)
    out = {"err": float((y.float() - y_ref.float()).abs().max())}
    plan = mm.int8_matmul_plan(M, D, O, w8a8)
    line = (f"[kernel] {name:<19} M={M} D={D} O={O} "
            f"{'w8a8' if w8a8 else 'weight-only'} plan C={plan.cluster} "
            f"stages={plan.stages}/{plan.stages_per_block} passes="
            f"{plan.passes} smem={plan.smem} bit-equal={exact} "
            f"max|dy|={out['err']:.3e} max|dy|/max|y|={err:.3e} "
            f"({'bit-equal' if w8a8 else f'<= {BOUND_GEMV:.3e}'}) "
            f"two-launches-bit-equal={twice}")
    if timed:
        def run(fn):
            return lambda: [fn(x, w[i], s[i]) for i in range(layers)]

        out["call_ms"] = cuda_ms(torch, run(kernel), 10) / layers
        out["ms"] = graph_ms(torch, run(kernel)) / layers
        out["plain_ms"] = graph_ms(torch, run(plain), 5) / layers
        out["library_ms"], lib = gemv_library_ms(torch, x, w, s, layers,
                                                 w8a8)
        out["bytes"] = D * O + 4 * O + 2 * M * D + 2 * M * O
        out["ops"] = 2 * M * D * O
        bms, by = bound_ms(out["bytes"], out["ops"],
                           INT8_OPS if w8a8 else BF16_OPS)
        line += (f" kernel_ms={out['ms']:.4f} (with the host's launch: "
                 f"{out['call_ms']:.4f}) plain_ms={out['plain_ms']:.4f} "
                 + (f"library_ms={out['library_ms']:.4f} ({lib})"
                    if out["library_ms"] is not None else f"library none "
                    f"({lib})")
                 + f" bound_ms={bms:.4f} ({by}) over {layers} weight "
                 "copies")
    log(line + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} M={M} D={D} O={O}: kernel disagrees "
                             "with the plain version or with itself")
    del w, s, x
    torch.cuda.empty_cache()
    return out


def gemv_phase(torch, mm, cfg):
    """int8_matmul, both branches, at M 1, 6, 30 and 255 on the four
    Phi-3.5 projections, timed over 32 layers: w8a8 at M 6 (mode A's decode
    step) and 30 (path D's verify pass), weight-only at M 1 (a decode step
    of modes B and C); weight-only at the same M on O 9216 and the
    vocabulary (timed: the lm_head at M 6 and 30); GEMV_EDGE_CASES; one
    call of each branch captured in a CUDA graph, which must hold exactly
    one device kernel. The families' numbers are mode A's per step
    (the 128 w8a8 projections; the lm_head)."""
    L = cfg.llm
    D, V = L.hidden_size, L.padded_vocab_size
    shapes = {"qkv": (D, L.q_dim + 2 * L.kv_dim), "o": (L.q_dim, D),
              "gate_up": (D, 2 * L.intermediate_size),
              "down": (L.intermediate_size, D)}
    k3, k6 = Family("int8_gemv"), Family("int8_matmul")
    # printed only: modes B and C's step, path D's pass, the lm_head at 30
    wo_step, verify, k6_30 = (Family("int8_matmul"), Family("int8_gemv"),
                              Family("int8_matmul"))
    timed_fam = {(True, 6): k3, (True, 30): verify, (False, 1): wo_step}

    for j, (pname, (d, o)) in enumerate(shapes.items()):
        for w8a8 in (False, True):
            fam = k3 if w8a8 else k6
            for M in GEMV_ROWS:
                tf = timed_fam.get((w8a8, M))
                r = check_gemv(torch, mm, f"{fam.name} {pname}", M, d, o,
                               layers=L.num_layers if tf else 1,
                               w8a8=w8a8, timed=tf is not None, seed=10 + j)
                fam.max_err = max(fam.max_err, r["err"])
                if tf:
                    tf.add(L.num_layers, r["ms"], r["plain_ms"], r["bytes"],
                           r["ops"], "int8" if w8a8 else "bf16",
                           r["library_ms"])
    for M in GEMV_ROWS:
        for o in (shapes["qkv"][1], V):
            tf = {6: k6, 30: k6_30}.get(M) if o == V else None
            # timed over LM_HEAD_COPIES copies of the weight, so that a
            # graph replay's own cost is spread over as many calls
            r = check_gemv(torch, mm, "int8_matmul lm_head" if o == V
                           else "int8_matmul", M, D, o, timed=tf is not None,
                           layers=LM_HEAD_COPIES if tf else 1, seed=20 + M)
            k6.max_err = max(k6.max_err, r["err"])
            if tf:
                tf.add(1, r["ms"], r["plain_ms"], r["bytes"], r["ops"],
                       library_ms=r["library_ms"])
    for w8a8, o, d in GEMV_EDGE_CASES:
        fam = k3 if w8a8 else k6
        for M in GEMV_EDGE_ROWS:
            r = check_gemv(torch, mm, f"{fam.name} edge", M, d, o, w8a8=w8a8,
                           seed=30 + M)
            fam.max_err = max(fam.max_err, r["err"])
    verify.add(1, k6_30.ms, k6_30.plain_ms, k6_30.bytes, k6_30.ops["bf16"],
               library_ms=k6_30.library_ms)
    if k6_30.library_ms is None:      # no library call for the whole pass
        verify.library_ms = None
    g = torch.Generator(device="cuda")
    g.manual_seed(40)
    x = torch.randn(6, D, generator=g, device="cuda").bfloat16()
    for w8a8, (d, o) in ((True, shapes["qkv"]), (False, (D, V))):
        w = int8_weight(torch, mm, (d, o), g)
        s = torch.rand(o, generator=g, device="cuda") + 1e-4
        names, _ = device_kernels(torch,
                                  lambda: mm.int8_matmul(x, w, s, w8a8))
        ok = len(names) == 1 and "int8_mm_kernel" in names[0]
        log(f"[kernel] {'int8_gemv' if w8a8 else 'int8_matmul'} one call "
            f"captured in a CUDA graph: {len(names)} device kernel(s) "
            f"{[short_entry(n) for n in names]} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("int8_matmul must run as one device kernel "
                                 f"a call, saw {names}")
    del x, w, s
    for fam, what in ((k3, "mode A's step, 128 launches at M=6"),
                      (k6, "mode A's step, the lm_head at M=6"),
                      (wo_step, "modes B and C's step, 128 launches at M=1, "
                       "without the lm_head"),
                      (verify, "path D's verify pass, 128 launches at M=30 "
                       "and the lm_head at M=30"),
                      (k6_30, "the lm_head at M=30")):
        bms, by = fam.bound()
        lib = (f"{fam.library_ms:.4f} ms" if fam.library_ms is not None
               else "none")
        log(f"[kernel] {fam.name} per {what}: kernel {fam.ms:.4f} ms, "
            f"plain {fam.plain_ms:.4f} ms, library {lib}, bound {bms:.4f} "
            f"ms ({by}), {100 * bms / fam.ms:.1f}% of the bound reached")
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


def check_attention(torch, da, name, B, H, Hkv, D, L, *, S=None, layers=1,
                    timed=False, seed=0, empty=False, window=False,
                    holes=False):
    """K4 (S None: one query per row, a [B, L] mask) or K8 (S queries per
    row, per-query masks, verify_mask) against its plain version, launched
    twice (the two outputs must be bit-equal). holes: the last row also
    loses slots 512..1,023 and 1,280..1,407, whole chunks of 128 that no
    query sees. Timed: graph replays over `layers` buffers on this mask and
    on one where every slot is visible."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def cache():
        vals = torch.randint(-127, 128, (layers, B, Hkv, L, D), generator=g,
                             device="cuda", dtype=torch.int8)
        return vals, torch.rand(layers, B, Hkv, L, generator=g,
                                device="cuda") * 0.02 + 1e-3

    k8, ks = cache()
    v8, vs = cache()
    n_q = 1 if S is None else S
    q = torch.randn(B, n_q, H, D, generator=g, device="cuda").to(
        torch.bfloat16)
    kn, vn = (torch.randn(B, n_q, Hkv, D, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    if S is None:
        mask = ragged_valid(torch, B, L, seed)
        kernel_fn, plain_fn = (da.decode_attention_int8,
                               da.decode_attention_int8_reference)
        counter, what = da.DECODE_ATTENTION_INT8, "decode_attention_int8"
    else:
        mask = verify_mask(torch, B, S, L, seed, empty=empty, window=window)
        kernel_fn, plain_fn = (da.verify_attention_int8,
                               da.verify_attention_int8_reference)
        counter, what = da.VERIFY_ATTENTION_INT8, "verify_attention_int8"
    if holes:
        mask[-1, ..., 512:1024] = False
        mask[-1, ..., 1280:1408] = False
    scale = D ** -0.5
    masks = {"": mask}

    def kernel(i=0, m=""):
        return kernel_fn(q, k8[i], ks[i], v8[i], vs[i], masks[m], kn, vn,
                         scale=scale)

    def plain(i=0, m=""):
        return plain_fn(q, k8[i], ks[i], v8[i], vs[i], masks[m], kn, vn,
                        scale=scale)

    before = counter.launches
    o, o_ref, o2 = kernel(), plain(), kernel()
    torch.cuda.synchronize()
    same = torch.equal(o, o2)
    do = o.float() - o_ref.float()
    err = float(do.abs().max())
    rel = float(torch.linalg.vector_norm(do)
                / torch.linalg.vector_norm(o_ref.float()))
    row = float((torch.linalg.vector_norm(do, dim=-1)
                 / torch.linalg.vector_norm(o_ref.float(), dim=-1)).max())
    ok = (rel <= BOUND_ATTN_REL and row <= BOUND_ATTN_ROW and same
          and bool(torch.isfinite(o).all())
          and counter.launches == before + 2)
    plan = da.attention_plan(B, Hkv, H // Hkv, n_q, L, D)
    line = (f"[kernel] {what} {name:<10} B={B} S={n_q} H={H} Hkv={Hkv} "
            f"D={D} L={L} cluster={plan.cluster} "
            f"slots/block={plan.slots_per_block} stages={plan.stages} "
            f"smem={plan.smem} slots_read={needed_slots(mask, B, n_q, L)} "
            f"max|do|={err:.3e} rel|do|={rel:.3e} (<= {BOUND_ATTN_REL}) max "
            f"per (row, head, query) rel|do|={row:.3e} (<= "
            f"{BOUND_ATTN_ROW:.3e}) two_launches_bit_equal={same}")
    out = {"err": err}
    if timed:
        masks["all"] = torch.ones_like(mask)
        for m, key in (("", ""), ("all", "all_")):
            n_need = needed_slots(masks[m], B, n_q, L)
            pairs = int(masks[m].sum()) + B * n_q * (n_q + 1) // 2
            out[key + "ms"] = graph_ms(
                torch, lambda: [kernel(i, m) for i in range(layers)]) / layers
            # the needed slots and their scales, the mask, q / k_new / v_new
            # read and the output written
            out[key + "bytes"] = (Hkv * n_need * (2 * D + 8) + B * n_q * L
                                  + 2 * (2 * B * n_q * H * D
                                         + 2 * B * n_q * Hkv * D))
            out[key + "ops"] = 4 * D * H * pairs
        out["call_ms"] = cuda_ms(
            torch, lambda: [kernel(i) for i in range(layers)], 10) / layers
        out["plain_ms"] = graph_ms(
            torch, lambda: [plain(i) for i in range(layers)], 5) / layers
        bms, by = bound_ms(out["bytes"], out["ops"], BF16_OPS)
        ams, _ = bound_ms(out["all_bytes"], out["all_ops"], BF16_OPS)
        line += (f" kernel_ms={out['ms']:.4f} (with the host's launch: "
                 f"{out['call_ms']:.4f}) plain_ms={out['plain_ms']:.4f}"
                 f" bound_ms={bms:.4f} ({by}, {bms / out['ms']:.1%} reached)"
                 f" every_slot_visible: kernel_ms={out['all_ms']:.4f} "
                 f"bound_ms={ams:.4f} ({ams / out['all_ms']:.1%}) over "
                 f"{layers} layers")
    log(line + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} {name}: kernel disagrees with the "
                             "plain version or two launches differ")
    del k8, ks, v8, vs
    torch.cuda.empty_cache()
    return out


def needed_slots(mask, B, n_q, L) -> int:
    """The slots this data needs: those some query of the row can see."""
    return int(mask.view(B, n_q, L).any(dim=1).sum())


def check_conversion(torch, cuda_build) -> None:
    """The int8 -> bf16 conversion K4 and K8 run (i8x4_to_bf16, through its
    own C entry) on every byte value at each of the four positions of a
    word: equal to torch's conversion."""
    conv = cuda_build.CudaKernel(
        "decode_attention_int8.cu", "gvllm_int8_to_bf16",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    cuda_build.REGISTRY.remove(conv)
    x = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    x = torch.cat([x.roll(r) for r in range(4)]).cuda()
    y = torch.empty(x.numel(), dtype=torch.bfloat16, device="cuda")
    conv(x.data_ptr(), y.data_ptr(), x.numel(),
         torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    same = torch.equal(y, x.to(torch.bfloat16))
    log(f"[kernel] int8 -> bf16 conversion of K4/K8: 256 byte values at 4 "
        f"positions equal to torch's: {same} {'OK' if same else 'FAIL'}")
    if not same:
        raise AssertionError("the int8 -> bf16 conversion is not exact")


# K4 beyond the path's B = 1 and B = 6 (G 1, D 96): the other G and D the C
# entry launches, L off the cluster's slot grid, whole chunks no query sees,
# and an L past the one-block design's cap (G * L * 4 <= 187 KB: 47,872 at
# G 1, 5,984 at G 8)
ATTENTION_CASES = (
    ("gqa_d128", dict(B=2, H=32, Hkv=8, D=128, L=1000)),
    ("g2_d32", dict(B=2, H=16, Hkv=8, D=32, L=1037)),
    ("g8_d64", dict(B=2, H=32, Hkv=4, D=64, L=3001, holes=True)),
    ("long", dict(B=1, H=8, Hkv=8, D=96, L=60000)),
    ("g8_long", dict(B=1, H=16, Hkv=2, D=128, L=8000)))


def attention_phase(torch, da, cfg, max_len, cuda_build):
    L = cfg.llm
    check_conversion(torch, cuda_build)
    k4 = Family("decode_attention_int8")
    for B in (1, 6):
        r = check_attention(torch, da, f"b{B}", B, L.num_heads,
                            L.num_kv_heads, L.head_dim, max_len,
                            layers=L.num_layers, timed=True, seed=30 + B)
        k4.max_err = max(k4.max_err, r["err"])
        if B == 6:
            k4.add(L.num_layers, r["ms"], r["plain_ms"], r["bytes"], r["ops"])
    for i, (name, kw) in enumerate(ATTENTION_CASES):
        r = check_attention(torch, da, name, seed=39 + i, **kw)
        k4.max_err = max(k4.max_err, r["err"])
    bms, by = k4.bound()
    log(f"[kernel] decode_attention_int8 per decode step of mode A (32 "
        f"launches, B=6): kernel {k4.ms:.3f} ms, plain {k4.plain_ms:.3f} ms, "
        f"bound {bms:.3f} ms ({by})")
    return k4


# ---------------------------------------------------------------------------
# K5 scatter_write and K9 scatter_write_multi
# ---------------------------------------------------------------------------


def write_phase(torch, cw, cfg, max_len, S=None):
    """K5 (S None: one slot per row at ragged slots, the last at the array
    edge) or K9 (S slots per row from ragged bases, two rows across a
    128-slot boundary, one at the array edge and one whose last slots fall
    past max_len and write nothing) on path A's / D's four buffers: bit-equal
    to the plain version, the same storage, every other byte untouched."""
    L = cfg.llm
    multi = S is not None
    n_s = S if multi else 1
    fam = Family("scatter_write_multi" if multi else "scatter_write")
    counter = cw.SCATTER_WRITE_MULTI if multi else cw.SCATTER_WRITE
    B, Hkv, D, n = 6, L.num_kv_heads, L.head_dim, L.num_layers
    g = torch.Generator(device="cuda")
    g.manual_seed(80 if multi else 40)

    def values(*shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(*shape, generator=g, device="cuda")

    caches = [values(n, B, Hkv, max_len, D), scales(n, B, Hkv, max_len),
              values(n, B, Hkv, max_len, D), scales(n, B, Hkv, max_len)]
    news = [values(n, B, n_s, Hkv, D), scales(n, B, n_s, Hkv),
            values(n, B, n_s, Hkv, D), scales(n, B, n_s, Hkv)]
    if multi:
        bases = [0, 126, 127, max_len // 2, max_len - S, max_len - 2]
        call, plain = cw.scatter_write_multi, cw.scatter_write_multi_reference
        args = news
    else:
        bases = [0, 127, 128, max_len // 2, max_len - 2, max_len - 1]
        call, plain = cw.scatter_write, cw.scatter_write_reference
        args = [t[:, :, 0] for t in news]
    base = torch.tensor(bases, dtype=torch.int32, device="cuda")
    before = [c.clone() for c in caches]
    ptrs = [c.data_ptr() for c in caches]
    launched = counter.launches
    call(caches, args, base)
    expect = [c.clone() for c in before]
    plain(expect, args, base.cpu())
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(caches, expect))
    kept = [c.data_ptr() for c in caches] == ptrs
    keep = torch.ones(B, max_len, dtype=torch.bool, device="cuda")
    for b, b0 in enumerate(bases):
        keep[b, b0:min(b0 + n_s, max_len)] = False
    untouched = all(
        torch.equal(c.transpose(1, 2)[:, :, keep].view(torch.uint8),
                    o.transpose(1, 2)[:, :, keep].view(torch.uint8))
        for c, o in zip(caches, before))
    ok = same and kept and untouched and counter.launches == launched + 1
    # timing on the path's kind of slots: every one in range
    base_t = base.clamp_max(max_len - n_s)
    rows = torch.arange(B, device="cuda")[:, None].expand(B, n_s)
    cols = base_t.long()[:, None] + torch.arange(n_s, device="cuda")[None, :]

    def library():
        for c, new in zip(caches, news):
            c[:, rows, :, cols] = new.movedim(0, 2)

    call_ms = cuda_ms(torch, lambda: call(caches, args, base_t), 50)
    ms = graph_ms(torch, lambda: call(caches, args, base_t), 20, GRAPH_CALLS)
    # the plain version reads the slots on the host: not capturable, so its
    # time includes the host's part
    plain_ms = cuda_ms(torch, lambda: plain(caches, args, base_t), 5)
    lib_ms = graph_ms(torch, library, 20, GRAPH_CALLS)
    nbytes = 2 * sum(t.numel() * t.element_size() for t in news)
    fam.add(1, ms, plain_ms, nbytes, 0.0, "bf16", lib_ms)
    bms, by = fam.bound()
    log(f"[kernel] {fam.name} 4 buffers [{n},{B},{Hkv},{max_len},{D}] "
        f"S={n_s} slots={bases} equal_to_plain={same} same_storage={kept} "
        f"untouched_bytes_equal={untouched} kernel_ms={ms:.4f} (with the "
        f"host's launch: {call_ms:.4f}) plain_ms={plain_ms:.4f} "
        f"index_put_ms={lib_ms:.4f} (4 calls) bound_ms={bms:.5f} ({by}) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{fam.name}: kernel disagrees with the plain "
                             "version or touched other bytes")
    del caches, news, before, expect
    torch.cuda.empty_cache()
    return fam


# ---------------------------------------------------------------------------
# K8 verify_attention_int8
# ---------------------------------------------------------------------------


def verify_mask(torch, B, S, L, seed, *, empty=False, window=False):
    """[B, S, L] bool per-query masks: every query of a row sees the row's
    ragged committed slots (ragged_valid); empty: row 0 sees no cache slot
    (only its new tokens); window: query i loses the first 200 + 13 i
    slots, as a sliding window moving with the candidate's position."""
    mask = ragged_valid(torch, B, L, seed)[:, None, :].repeat(1, S, 1)
    if empty:
        mask[0] = False
    if window:
        for i in range(S):
            mask[:, i, :200 + 13 * i] = False
    return mask.contiguous()


# K8 beyond path D's shape (G 1, D 96, S 5): S = 1 and 8, the other G and D
# the C entry launches, an empty cache mask, a window, L off the cluster's
# slot grid, whole chunks no query sees, more than 32 queries (two value
# passes), and L past the one-block design's cap (Q * L fp32 scores in 227
# KB: 9,985 at Q 5, D 96; 2,363 at Q 20, D 128)
VERIFY_CASES = (
    ("s1", dict(B=6, S=1, H=32, Hkv=32, D=96)),
    ("s8", dict(B=2, S=8, H=32, Hkv=32, D=96, L=1000)),
    ("gqa4_d128", dict(B=2, S=8, H=32, Hkv=8, D=128, L=1000)),
    ("empty", dict(B=2, S=SPEC_DRAFT_LEN + 1, H=32, Hkv=32, D=96, L=640,
                   empty=True)),
    ("window", dict(B=2, S=SPEC_DRAFT_LEN + 1, H=32, Hkv=32, D=96, L=640,
                    window=True)),
    ("g2_d32", dict(B=2, S=3, H=16, Hkv=8, D=32, L=777)),
    ("g8_d64", dict(B=2, S=5, H=32, Hkv=4, D=64, L=3001, holes=True)),
    ("q40", dict(B=1, S=5, H=64, Hkv=8, D=64, L=1000)),
    ("q5_long", dict(B=1, S=5, H=8, Hkv=8, D=96, L=12000)),
    ("q20_long", dict(B=1, S=5, H=32, Hkv=8, D=128, L=6000)))


def verify_phase(torch, da, cfg, max_len, S_v):
    """K8 at path D's shape (timed over 32 layers' buffers) and
    VERIFY_CASES (L: max_len where a case names none). The family's
    numbers are per verify pass (32 launches)."""
    L = cfg.llm
    k8 = Family("verify_attention_int8")
    r = check_attention(torch, da, "path_D", 6, L.num_heads, L.num_kv_heads,
                        L.head_dim, max_len, S=S_v, layers=L.num_layers,
                        timed=True, seed=70)
    k8.add(L.num_layers, r["ms"], r["plain_ms"], r["bytes"], r["ops"])
    k8.max_err = r["err"]
    for i, (name, kw) in enumerate(VERIFY_CASES):
        r = check_attention(torch, da, name, seed=71 + i,
                            **dict({"L": max_len}, **kw))
        k8.max_err = max(k8.max_err, r["err"])
    bms, by = k8.bound()
    log(f"[kernel] verify_attention_int8 per verify pass of path D "
        f"({L.num_layers} launches, B=6, S={S_v}): kernel {k8.ms:.3f} ms, "
        f"plain {k8.plain_ms:.3f} ms, bound {bms:.3f} ms ({by})")
    return k8


def attention_instantiations(cfg):
    """(C entry, D) of every attention_kernel the K4 and K8 cases launch,
    and the q heads per kv head (G) each entry's cases reach."""
    L = cfg.llm
    path = dict(H=L.num_heads, Hkv=L.num_kv_heads, D=L.head_dim)
    cases = {"decode_attention_int8": [path] + [kw for _, kw in
                                                ATTENTION_CASES],
             "verify_attention_int8": [path] + [kw for _, kw in
                                                VERIFY_CASES]}
    dims = {(entry, kw["D"]) for entry, kws in cases.items() for kw in kws}
    groups = {entry: {kw["H"] // kw["Hkv"] for kw in kws}
              for entry, kws in cases.items()}
    return dims, groups


# ---------------------------------------------------------------------------
# K10 fused W8A8 InternVideo2-block GEMMs
# ---------------------------------------------------------------------------


WIDE_K = 6208   # K10's rows past the register-held 6,144; K % 128 != 0


def fused_phase(torch, fb, cfg, videos):
    """The four GEMMs of a W8A8 InternVideo2 block at path D's rows (its
    videos encoded in one call: videos x 12 segments x 2,049 tokens)
    against their plain versions, and at 300 rows (a ragged row tile) with
    the "none" epilogue and a K = WIDE_K ls_residual GEMM too. Beside
    each: the unfused W8A8 chain the port runs with the switch off
    (rms_norm → dynamic_int8_matmul on torch._int_mm → epilogue). The
    kernel and the chain are both timed by replays of a CUDA graph of two
    calls (an output of the widest GEMM is 1.8 GB). TOP/s counts 2·M·K·N
    once per GEMM: qk_norm no longer runs the q and k columns' GEMM twice.
    Family numbers are per encode of path D: 39 blocks."""
    import torch.nn.functional as F

    from grounded_video_llm_tpu_torch.ops.int8_matmul import (
        Int8Weight, dynamic_int8_matmul, quantize_weights_int8)
    from grounded_video_llm_tpu_torch.ops.normalization import (layer_scale,
                                                                rms_norm)

    v = cfg.video
    D, I, eps = v.embed_dim, v.mlp_hidden, v.rms_eps
    nb = v.num_blocks_used
    g = torch.Generator(device="cuda")
    g.manual_seed(90)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale
                + shift).to(torch.bfloat16)

    def weight(d_in, d_out):
        return Int8Weight(*quantize_weights_int8(
            torch.randn(d_in, d_out, generator=g, device="cuda") * 0.02))

    w = {"qkv": weight(D, 3 * D), "fc1": weight(D, I), "proj": weight(D, D),
         "fc2": weight(I, D)}
    nw, qn = randn(D, scale=0.1, shift=1.0), randn(2, D, scale=0.1, shift=1.0)
    b_fc1, b_d = randn(I, scale=0.1), randn(D, scale=0.1)
    ls = randn(D, scale=0.1)
    nqg, qglr = Family("fused_norm_quant_gemm"), \
        Family("fused_quant_gemm_ls_residual")
    unfused_total = {nqg.name: 0.0, qglr.name: 0.0}
    rows = videos * cfg.num_segs * v.seq_len
    for M in (300, rows):
        timed = M > 300
        x, h = randn(M, D), randn(M, I, scale=0.5)

        def unfused_qkv():
            q, k, vv = dynamic_int8_matmul(rms_norm(x, nw, eps), w["qkv"].q,
                                           w["qkv"].scale).split(D, dim=-1)
            return rms_norm(q, qn[0], eps), rms_norm(k, qn[1], eps), vv

        cases = [
            ("qkv qk_norm", nqg, D, 3 * D,
             lambda: fb.fused_norm_quant_gemm(x, nw, w["qkv"], eps=eps,
                                              epilogue="qk_norm",
                                              qk_norm_w=qn),
             lambda: fb.fused_norm_quant_gemm_reference(
                 x, nw, w["qkv"], eps=eps, epilogue="qk_norm", qk_norm_w=qn),
             unfused_qkv),
            ("fc1 gelu+bias", nqg, D, I,
             lambda: fb.fused_norm_quant_gemm(x, nw, w["fc1"], eps=eps,
                                              epilogue="gelu", bias=b_fc1),
             lambda: fb.fused_norm_quant_gemm_reference(
                 x, nw, w["fc1"], eps=eps, epilogue="gelu", bias=b_fc1),
             lambda: F.gelu(dynamic_int8_matmul(
                 rms_norm(x, nw, eps), w["fc1"].q, w["fc1"].scale) + b_fc1,
                 approximate="none")),
            ("proj ls+residual", qglr, D, D,
             lambda: fb.fused_quant_gemm_ls_residual(x, w["proj"], b_d, ls,
                                                     x),
             lambda: fb.fused_quant_gemm_ls_residual_reference(
                 x, w["proj"], b_d, ls, x),
             lambda: x + layer_scale(dynamic_int8_matmul(
                 x, w["proj"].q, w["proj"].scale) + b_d, ls)),
            ("fc2 ls+residual", qglr, I, D,
             lambda: fb.fused_quant_gemm_ls_residual(h, w["fc2"], b_d, ls, x),
             lambda: fb.fused_quant_gemm_ls_residual_reference(
                 h, w["fc2"], b_d, ls, x),
             lambda: x + layer_scale(dynamic_int8_matmul(
                 h, w["fc2"].q, w["fc2"].scale) + b_d, ls)),
        ]
        if not timed:
            cases.append((
                "proj none", nqg, D, D,
                lambda: fb.fused_norm_quant_gemm(x, nw, w["proj"], eps=eps),
                lambda: fb.fused_norm_quant_gemm_reference(x, nw, w["proj"],
                                                           eps=eps), None))
            # a row longer than the register-held rows' 6,144 and a K that
            # is no multiple of the GEMM's 128-byte step (TMA zero-fills the
            # last one)
            hw, ww = randn(M, WIDE_K, scale=0.5), weight(WIDE_K, D)
            cases.append((
                "wide-K ls+res", qglr, WIDE_K, D,
                lambda: fb.fused_quant_gemm_ls_residual(hw, ww, b_d, ls, x),
                lambda: fb.fused_quant_gemm_ls_residual_reference(
                    hw, ww, b_d, ls, x), None))
        for name, fam, d_in, d_out, kernel, plain, unfused in cases:
            counter = (fb.FUSED_NORM_QUANT_GEMM if fam is nqg
                       else fb.FUSED_QUANT_GEMM_LS_RESIDUAL)
            before = counter.launches
            y, y_ref = kernel(), plain()
            torch.cuda.synchronize()
            err = gemv_error(torch, y, y_ref)
            ok = (err <= BOUND_GEMV and y.dtype == torch.bfloat16
                  and bool(torch.isfinite(y).all())
                  and counter.launches == before + 1)
            d_abs = float((y.float() - y_ref.float()).abs().max())
            fam.max_err = max(fam.max_err, d_abs)
            line = (f"[kernel] {fam.name} {name:<16} M={M} D={d_in} "
                    f"O={d_out} max|dy|={d_abs:.3e} max|dy|/max|y|={err:.3e}"
                    f" (<= {BOUND_GEMV:.3e})")
            if timed:
                ms = graph_ms(torch, kernel, 5, 2)
                plain_ms = cuda_ms(torch, plain, 2)
                unfused_ms = graph_ms(torch, unfused, 5, 2)
                nbytes = (2 * M * d_in + d_in * d_out + 8 * d_out
                          + 2 * M * d_out * (2 if fam is qglr else 1))
                ops = 2.0 * M * d_in * d_out
                bms, by = bound_ms(nbytes, ops, INT8_OPS)
                fam.add(nb, ms, plain_ms, nbytes, ops, "int8")
                unfused_total[fam.name] += nb * unfused_ms
                line += (f" kernel_ms={ms:.4f} ({ops / ms / 1e9:.0f} TOP/s)"
                         f" plain_ms={plain_ms:.4f} unfused_chain_ms="
                         f"{unfused_ms:.4f} bound_ms={bms:.4f} ({by})")
            log(line + f" {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{fam.name} {name} M={M}: kernel "
                                     "disagrees with the plain version")
        del x, h
        torch.cuda.empty_cache()
    for fam in (nqg, qglr):
        bms, by = fam.bound()
        log(f"[kernel] {fam.name} per encode of path D ({videos} videos, "
            f"{nb} blocks x 2 GEMMs at M={rows}): kernel {fam.ms:.1f} ms, "
            f"plain {fam.plain_ms:.1f} ms, unfused W8A8 chain "
            f"{unfused_total[fam.name]:.1f} "
            f"ms, bound {bms:.1f} ms ({by})")
    del w
    torch.cuda.empty_cache()
    return nqg, qglr



# ---------------------------------------------------------------------------
# M3, M3d: the microbenchmarks' int8 GEMMs; M1: their int8 GEMV on K3
# ---------------------------------------------------------------------------


# M3 / M3d cases (M, K, N): microbench/int8_gemm's fc1 and the fc2
# transpose (timed), then a ragged M, the old resident-rows K, one row, one
# K step of 64 bytes, N = 384 (the tile falls back to 128 columns) and a K
# past the rows kernel's register-held 6,144: each of the GEMM's tile widths
# 256, 176 and 128 runs for both entries
INT8_GEMM_CASES = ((8192, 1408, 6144), (8192, 6144, 1408), (300, 1408, 6144),
                   (300, 1792, 1408), (1, 1408, 6144), (300, 64, 6144),
                   (300, 1408, 384), (300, 6208, 1408))


def kernel_split(torch, fn, calls: int = 10) -> dict:
    """{device kernel name: ms per call} over `calls` calls of fn, from a
    torch.profiler window: each kernel is charged from the end of the
    kernel before it (or its own start, if later) to its own end, so the
    shares add up to the calls' device time even where a kernel launched
    with programmatic stream serialization starts, and waits, while the
    one before drains."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    split, prev_end = {}, None
    for start, end, name in events:
        found = re.search(r"(\w+(?:<[^()]*>)?)\(", name)
        name = found.group(1) if found else name
        begin = start if prev_end is None else max(start, prev_end)
        split[name] = split.get(name, 0.0) + (end - begin) / 1e3 / calls
        prev_end = end if prev_end is None else max(prev_end, end)
    return split


def int8_gemm_phase(torch, ig):
    """M3 (int8_gemm) and M3d (int8_gemm_dynamic) against their plain
    versions at INT8_GEMM_CASES: M3 must be bit-equal, M3d within max |dy| /
    max |y| <= 2**-7 (its row scales and products are the plain version's,
    so it is expected bit-equal); each launched twice, bit-equal; one call
    captured in a CUDA graph must hold int8_gemm_plan's device kernels (M3:
    the transpose and the GEMM; M3d: the rows too). At the two timed shapes,
    CUDA-graph replays of the wrapper, each device kernel's share (from the
    profiler), and beside them the library route (torch._int_mm plus the
    rescale, for M3d after quantize_rows), the yardsticks bf16 torch.matmul
    and torch._int_mm alone at the same shape, and the bound. Family numbers
    are one pass of microbench/int8_gemm: the two big shapes."""
    from grounded_video_llm_tpu_torch.ops.int8_matmul import quantize_rows

    m3, m3d = Family("int8_gemm"), Family("int8_gemm_dynamic")
    g = torch.Generator(device="cuda")
    g.manual_seed(60)
    for M, K, N in INT8_GEMM_CASES:
        timed = M > 300
        x = (torch.randn(M, K, generator=g, device="cuda") * 0.1).bfloat16()
        x8 = torch.randint(-127, 128, (M, K), generator=g, device="cuda",
                           dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                          dtype=torch.int8)
        s = torch.rand(N, generator=g, device="cuda") * 1e-3 + 1e-4

        def lib_static():
            return (torch._int_mm(x8, w).float() * s).to(torch.bfloat16)

        def lib_dynamic():
            q, xs = quantize_rows(x)
            return (torch._int_mm(q, w).float() * xs * s).to(torch.bfloat16)

        yardsticks = ""
        if timed:
            wb = (torch.randn(K, N, generator=g, device="cuda")
                  * 0.02).bfloat16()
            ops = 2.0 * M * K * N
            bf16_ms = graph_ms(torch, lambda: torch.matmul(x, wb), 20, 10)
            int_mm_ms = graph_ms(torch, lambda: torch._int_mm(x8, w), 20, 10)
            yardsticks = (f" yardsticks: bf16 torch.matmul {bf16_ms:.4f} ms "
                          f"({ops / bf16_ms / 1e9:.0f} TF/s), torch._int_mm "
                          f"alone {int_mm_ms:.4f} ms")
            del wb
        for fam, counter, kernel, plain, lib, nbytes in (
                (m3, ig.INT8_GEMM, lambda: ig.int8_gemm(x8, w, s),
                 lambda: ig.int8_gemm_reference(x8, w, s), lib_static,
                 M * K + K * N + 4 * N + 2 * M * N),
                (m3d, ig.INT8_GEMM_DYNAMIC,
                 lambda: ig.int8_gemm_dynamic(x, w, s),
                 lambda: ig.int8_gemm_dynamic_reference(x, w, s),
                 lib_dynamic, 2 * M * K + K * N + 4 * N + 2 * M * N)):
            plan = ig.int8_gemm_plan(M, K, N, fam is m3d)
            before = counter.launches
            y, y2, y_ref = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            err = gemv_error(torch, y, y_ref)
            equal = bool(torch.equal(y, y_ref))
            twice = bool(torch.equal(y, y2))
            launched, calls = device_kernels(torch, kernel)
            ok = ((equal if fam is m3 else err <= BOUND_GEMV) and twice
                  and len(launched) == plan.kernels
                  and y.dtype == torch.bfloat16
                  and bool(torch.isfinite(y).all())
                  and counter.launches == before + 2 + calls)
            d_abs = float((y.float() - y_ref.float()).abs().max())
            fam.max_err = max(fam.max_err, d_abs)
            line = (f"[kernel] {fam.name:<17} M={M} K={K} N={N} plan "
                    f"BN={plan.tile_n} grid={plan.grid} smem={plan.smem} "
                    f"kernels={len(launched)}/{plan.kernels} bit-equal="
                    f"{equal} max|dy|={d_abs:.3e} max|dy|/max|y|={err:.3e} "
                    f"(<= {'0' if fam is m3 else f'{BOUND_GEMV:.3e}'}) "
                    f"two-launches-bit-equal={twice}")
            if timed:
                ms = graph_ms(torch, kernel, 20, 10)
                plain_ms = cuda_ms(torch, plain, 3)
                lib_ms = graph_ms(torch, lib, 20, 10)
                split = kernel_split(torch, kernel)
                bms, by = bound_ms(nbytes, ops, INT8_OPS)
                fam.add(1, ms, plain_ms, nbytes, ops, "int8", lib_ms)
                line += (f" kernel_ms={ms:.4f} ({ops / ms / 1e9:.0f} TOP/s, "
                         f"{bms / ms:.1%} of the bound) device kernels: "
                         + ", ".join(f"{n} {t:.4f}" for n, t in split.items())
                         + f" plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}"
                         f" (_int_mm + rescale"
                         f"{' after quantize_rows' if fam is m3d else ''}) "
                         f"bound_ms={bms:.4f} ({by}){yardsticks}")
            log(line + f" {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{fam.name} M={M} K={K} N={N}: kernel "
                                     "disagrees with the plain version or "
                                     "with itself, or runs other kernels "
                                     "than its plan")
        del x, x8, w, s
        torch.cuda.empty_cache()
    for fam in (m3, m3d):
        bms, by = fam.bound()
        log(f"[kernel] {fam.name} per microbench/int8_gemm pass (fc1 and its "
            f"transpose): kernel {fam.ms:.3f} ms, plain {fam.plain_ms:.3f} "
            f"ms, library {fam.library_ms:.3f} ms, bound {bms:.3f} ms ({by})")
    return m3, m3d


def i8i8_phase(torch, ig, mm, cfg):
    """M1 (i8i8_matmul, served on K3's w8a8 kernel) against its plain
    version at M = 1, 6 and 16 on the three Phi-3.5 projections of
    microbench/decode (qkv, gate_up, down): bit-equal (K3's w8a8 branch is
    bit-equal to the same function), launched twice bit-equal, each launch
    counted by M1's own binding, one device kernel a call (captured in a
    CUDA graph). At M = 6 it is timed by CUDA-graph replay over enough
    weight copies to pass the L2 (streamed from device memory, as in a
    decode step), beside K3's w8a8 int8_gemv and torch._int_mm on the same
    copies (17 rows: _int_mm takes more than 16). Family numbers are one
    pass of microbench/decode's M1 lines: the three projections at M = 6."""
    L = cfg.llm
    D, I = L.hidden_size, L.intermediate_size
    fam = Family("i8i8_gemv")
    g = torch.Generator(device="cuda")
    g.manual_seed(70)
    for pname, (d, o) in (("qkv", (D, L.q_dim + 2 * L.kv_dim)),
                          ("gate_up", (D, 2 * I)), ("down", (I, D))):
        C = max(2, -(-150 * 2 ** 20 // (d * o)))
        w = torch.randint(-127, 128, (C, d, o), generator=g, device="cuda",
                          dtype=torch.int8)
        s = torch.rand(C, o, generator=g, device="cuda") * 1e-3 + 1e-4
        for M in (1, 6, 16):
            x = torch.randn(M, d, generator=g, device="cuda").bfloat16()
            before = ig.I8I8_GEMV.launches
            k3_before = mm.INT8_GEMV.launches
            y = ig.i8i8_matmul(x, w[0], s[0])
            y2 = ig.i8i8_matmul(x, w[0], s[0])
            y_ref = ig.i8i8_matmul_reference(x, w[0], s[0])
            torch.cuda.synchronize()
            err = gemv_error(torch, y, y_ref)
            d_abs = float((y.float() - y_ref.float()).abs().max())
            exact = bool(torch.equal(y, y_ref))
            twice = bool(torch.equal(y, y2))
            names, calls = device_kernels(
                torch, lambda: ig.i8i8_matmul(x, w[0], s[0]))
            one = len(names) == 1 and "int8_mm_kernel" in names[0]
            ok = (exact and twice and one and y.dtype == torch.bfloat16
                  and bool(torch.isfinite(y).all())
                  and ig.I8I8_GEMV.launches == before + 2 + calls
                  and mm.INT8_GEMV.launches == k3_before)
            fam.max_err = max(fam.max_err, d_abs)
            plan = mm.int8_matmul_plan(M, d, o, True)
            line = (f"[kernel] i8i8_gemv {pname:<7} M={M} D={d} O={o} on K3's "
                    f"w8a8 kernel, plan C={plan.cluster} stages="
                    f"{plan.stages}/{plan.stages_per_block} smem={plan.smem} "
                    f"bit-equal={exact} max|dy|={d_abs:.3e} "
                    f"max|dy|/max|y|={err:.3e} (bit-equal required) "
                    f"two-launches-bit-equal={twice} device kernels a call "
                    f"{len(names)} {[short_entry(n) for n in names]}")
            if M == 6:
                def run(fn):
                    return lambda: [fn(i) for i in range(C)]

                x17 = torch.zeros(17, d, dtype=torch.int8, device="cuda")
                ms = graph_ms(torch, run(lambda i: ig.i8i8_matmul(
                    x, w[i], s[i]))) / C
                plain_ms = graph_ms(torch, run(
                    lambda i: ig.i8i8_matmul_reference(x, w[i], s[i])),
                    5) / C
                k3_ms = graph_ms(torch, run(lambda i: mm.int8_matmul(
                    x, w[i], s[i], w8a8=True))) / C
                lib_ms = graph_ms(torch, run(
                    lambda i: torch._int_mm(x17, w[i]))) / C
                nbytes = d * o + 4 * o + 2 * M * d + 2 * M * o
                ops = 2.0 * M * d * o
                bms, by = bound_ms(nbytes, ops, INT8_OPS)
                fam.add(1, ms, plain_ms, nbytes, ops, "int8", lib_ms)
                line += (f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                         f"k3_w8a8_int8_gemv_ms={k3_ms:.4f} int_mm_ms="
                         f"{lib_ms:.4f} bound_ms={bms:.4f} ({by}) over {C} "
                         "weight copies")
            log(line + f" {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"i8i8_gemv {pname} M={M}: kernel "
                                     "disagrees with the plain version or "
                                     "with itself, or is not one launch of "
                                     "K3's w8a8 kernel")
        del w, s
        torch.cuda.empty_cache()
    bms, by = fam.bound()
    log(f"[kernel] i8i8_gemv per microbench/decode pass (3 projections at "
        f"M=6): kernel {fam.ms:.4f} ms, plain {fam.plain_ms:.4f} ms, _int_mm "
        f"{fam.library_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{100 * bms / fam.ms:.1f}% of the bound reached")
    return fam


# ---------------------------------------------------------------------------
# M2: the encoder-attention variants
# ---------------------------------------------------------------------------


def variant_inputs(torch, B, H, S, D, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return tuple(torch.randn(B, H, S, D, generator=g, device="cuda")
                 .bfloat16() for _ in range(3))


def wrong_softmaxes(torch, q, k, v):
    """Two wrong kernels' outputs, as plain versions, for showing that the
    bars separate them from a right one: exp2 where exp belongs (the scores
    scaled by ln 2; the same as dropping log2e in the offset modes), and
    the online softmax over 64-key tiles without the rescale of earlier
    tiles by exp(m_old - m_new)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    yield "exp2 for exp", ((p.to(v.dtype).float() @ v.float())
                           / p.sum(dim=-1, keepdim=True))
    del p
    m_run = torch.full_like(m, -float("inf"))
    acc = torch.zeros(*q.shape[:3], v.shape[-1], device=q.device)
    den = torch.zeros_like(m)
    for j in range(0, s.shape[-1], 64):
        sj = s[..., j:j + 64]
        m_run = torch.maximum(m_run, sj.amax(dim=-1, keepdim=True))
        pj = torch.exp(sj - m_run)
        den += pj.sum(dim=-1, keepdim=True)
        acc += pj.to(v.dtype).float() @ v[:, :, j:j + 64].float()
    yield "no online rescale", acc / den


def check_variant(torch, fa, mode, B, H, S, D, *, seed, timed,
                  wrong=False):
    """flash_variant vs its plain version → dict of numbers. The inputs
    are unit normal (bf16), as K1's check_flash draws them: the scores then
    spread over a few units, so the softmax weights differ across keys and
    an error in them shows in o. Timing runs on the microbenchmark's
    inputs (normal × 0.1); the time does not depend on the values. For
    "noexp" (p = s) the output is a ratio of sums that can cancel: rows
    are held to the bars only where |sum(s)| >= 1e-2 * sum(|s|), and since
    such a ratio reaches several units, where one bf16 ulp exceeds 2e-2,
    its max |do| is taken relative to max(1, |o_plain|) per element.
    wrong=True also holds two wrong kernels (wrong_softmaxes) to the same
    bars, which must reject them."""
    q, k, v = variant_inputs(torch, B, H, S, D, seed)
    before = fa.FLASH_VARIANT.launches
    o = fa.flash_variant(q, k, v, mode)
    ref = fa.flash_variant_reference(q, k, v, mode).float()
    torch.cuda.synchronize()
    launched = fa.FLASH_VARIANT.launches - before
    keep_share = 1.0
    got = o.float()
    if mode == "noexp":
        sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        keep = sc.sum(-1).abs() >= 1e-2 * sc.abs().sum(-1)
        del sc
        keep_share = float(keep.float().mean())
        got, ref = got[keep], ref[keep]
        d_o = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
    else:
        d_o = float((got - ref).abs().max())
    r_o = float(torch.linalg.vector_norm(got - ref)
                / torch.linalg.vector_norm(ref))
    ok = (d_o <= BOUND_O and r_o <= BOUND_O_REL and launched == 1
          and bool(torch.isfinite(got).all()) and keep_share > 0.5)
    out = {"max_abs_err": d_o, "rel": r_o, "ok": ok, "keep": keep_share}
    line = (f"[kernel] flash_variant {mode:<6} q=k=v={[B, H, S, D]} "
            f"max|do|{'/max(1,|o|)' if mode == 'noexp' else ''}={d_o:.3e} "
            f"(<= {BOUND_O}) rel|do|={r_o:.3e} (<= {BOUND_O_REL})"
            + (f" rows held {keep_share:.3f}" if mode == "noexp" else ""))
    if wrong:
        for name, y in wrong_softmaxes(torch, q, k, v):
            y = y.to(q.dtype).float()
            w_abs = float((y - ref).abs().max())
            w_rel = float(torch.linalg.vector_norm(y - ref)
                          / torch.linalg.vector_norm(ref))
            caught = w_abs > BOUND_O or w_rel > BOUND_O_REL
            line += (f"; wrong kernel ({name}): max|do|={w_abs:.3e} "
                     f"rel|do|={w_rel:.3e} {'rejected' if caught else 'PASSES'}")
            ok = ok and caught
            del y
    if timed:
        q, k, v = (t * 0.1 for t in (q, k, v))
        out["ms"] = graph_ms(torch, lambda: fa.flash_variant(q, k, v, mode),
                             10, GRAPH_CALLS)
        out["plain_ms"] = cuda_ms(
            torch, lambda: fa.flash_variant_reference(q, k, v, mode), 3)
        out["library_ms"] = None
        if mode in ("full", "nomax", "dh128"):
            out["library_ms"] = graph_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v), 10, GRAPH_CALLS)
        out["bytes"] = 4 * 2 * B * H * S * D
        out["flops"] = 4.0 * B * H * S * S * D
        bms, by = bound_ms(out["bytes"], out["flops"], BF16_OPS)
        lib = (f"{out['library_ms']:.4f}" if out["library_ms"] is not None
               else "none")
        line += (f" kernel_ms={out['ms']:.4f} "
                 f"({out['flops'] / out['ms'] / 1e9:.1f} TFLOP/s) plain_ms="
                 f"{out['plain_ms']:.4f} sdpa_ms={lib} bound_ms={bms:.4f} "
                 f"({by})")
    log(line + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_variant {mode} {[B, H, S, D]}: kernel "
                             "disagrees with the plain version, or the bars "
                             "let a wrong kernel pass")
    del q, k, v, o, ref, got
    torch.cuda.empty_cache()
    return out


def variant_cases(cfg):
    """Every check_variant case: (mode, [B, H, S, D], keyword arguments).
    M2's four kernel modes at microbench/encoder_attn's shape [12, 16, 2049,
    88] (offset as "nomax"; the script's exp2, unroll2, pipe compute the
    same function with the same kernel) with the wrong kernels in "full"
    mode, dh128 at D = 128, every mode name on a small ragged case [2, 3,
    130, 88] (dh128 at 128), and the four kernel modes on the ragged case at
    the other head dims, so every instantiation runs."""
    from grounded_video_llm_tpu_torch.ops.flash_attention import VARIANT_MODES
    v = cfg.video
    main = (12, v.num_heads, v.seq_len, v.head_dim)
    kernel_modes = ("full", "nomax", "noexp", "sumdot")
    cases = [(mode, main, dict(seed=80 + i, timed=True, wrong=mode == "full"))
             for i, mode in enumerate(kernel_modes)]
    cases.append(("dh128", (12, v.num_heads, v.seq_len, 128),
                  dict(seed=85, timed=True)))
    names = sorted(VARIANT_MODES)
    cases += [(mode, (2, 3, 130, 128 if mode == "dh128" else 88),
               dict(seed=90 + i, timed=False)) for i, mode in enumerate(names)]
    cases += [(mode, (2, 3, 130, D), dict(seed=110 + 4 * j + i, timed=False))
              for j, D in enumerate((64, 96, 128))
              for i, mode in enumerate(kernel_modes)]
    return cases


def flash_variant_phase(torch, fa, cfg):
    """M2 over variant_cases. The kernels line's M2 numbers are the offset
    mode's at the main shape: the softmax the InternVideo2 trunk runs, with
    SDPA computing the same function."""
    fam = Family("flash_variant")
    for mode, shape, kw in variant_cases(cfg):
        r = check_variant(torch, fa, mode, *shape, **kw)
        fam.max_err = max(fam.max_err, r["max_abs_err"])
        if mode == "nomax" and kw["timed"]:
            fam.add(1, r["ms"], r["plain_ms"], r["bytes"], r["flops"],
                    "bf16", r["library_ms"])
    return fam


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
    log(f"[small-ref] {cfg_full.llm_name} depth-cut full width (CLIP 2 of "
        f"3 layers, IV2 2 "
        f"blocks, LLM 2 layers, 1 segment), {what}, rel L2: "
        f"video features {errs[0]:.3e}, prefill logits {errs[1]:.3e}, "
        f"decode-step logits {errs[2]:.3e} (<= {bound}) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("card path disagrees with the host reference")
    del p_gpu, p_cpu, eng, outs
    torch.cuda.empty_cache()


def small_reference_verify(torch, cfg_full, seed, S_v):
    """Speculative verify on a depth-cut full-width LLM (2 layers) with
    int8_full weights and the int8 cache: verify_step then a full
    commit_verify from one prefilled cache.

    On the card, K8 and K9 are held to their plain versions on the inputs
    verify_step gave them: each layer's K8 output within K8's bar, the
    caches after the K9 write bit-equal to the plain write on copies of the
    caches before it, and every layer's committed slots bit-equal to the
    int8 quantization of that layer's in-pass k/v. Card against host (plain
    versions, bf16 on the CPU) and against S_v sequential decode_steps on
    the card: logits within the int8_full bar, valid masks and lengths
    equal. Printed as readings: those two routes' committed k/v, and the
    card's with K8's and K9's plain versions swapped in. Past layer 0 they
    differ by several int8 steps: W8A8 activations turn a one-ulp change of
    a layer's attention into other int8 activations and so into other k/v
    in the next layer, and the sequential steps read the candidates back as
    int8 where the verify pass attends to their bf16 k/v."""
    from grounded_video_llm_tpu_torch.core.config import replace
    from grounded_video_llm_tpu_torch.models import llm
    from grounded_video_llm_tpu_torch.ops import cache_write as cw
    from grounded_video_llm_tpu_torch.ops import decode_attention_int8 as da
    from grounded_video_llm_tpu_torch.serve.quantize import \
        quantize_llm_for_serving

    cfg = replace(cfg_full.llm, num_layers=2)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    lp = quantize_llm_for_serving(
        llm.init_params(cfg, generator=g, device="cuda", dtype=torch.bfloat16),
        w8a8=True)
    B, S, max_len = 2, 600, 768
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, S)))
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, S_v)))
    mask = torch.ones(B, S, dtype=torch.long)
    mask[1, :37] = 0                                   # left padding
    new = slice(S, S + S_v)

    def clone(c):
        return c._replace(k=c.k.clone(), k_scale=c.k_scale.clone(),
                          v=c.v.clone(), v_scale=c.v_scale.clone(),
                          length=c.length.clone())

    def verify(p, cache, valid, pos0):
        """verify_step + full commit → (logits, cache, valid)."""
        dev = valid.device
        positions = pos0[:, None] + torch.arange(S_v, device=dev)[None]
        logits, cache = llm.verify_step(
            p, cfg, llm.embed_lookup(p["embed"], toks.to(dev)), cache,
            valid, positions)
        cache, valid = llm.commit_verify(
            cache, valid, torch.full((B,), S_v, device=dev), S_v)
        return logits, cache, valid

    # the kernels' inputs as verify_step gives them, cloned at the call
    attn_calls, write_calls = [], []

    def attn(*a, **kw):
        a = [t.clone() for t in a]
        o = da.verify_attention_int8(*a, **kw)
        attn_calls.append((a, kw, o))
        return o

    def write(caches, news, base):
        write_calls.append(([c.clone() for c in caches], news, base))
        cw.scatter_write_multi(caches, news, base)

    out = {}
    for dev, p in (("cpu", to_host(lp)), ("cuda", lp)):
        with torch.inference_mode():
            m = mask.to(dev)
            cache = llm.QuantKVCache.create(cfg, B, max_len, device=dev)
            _, cache = llm.prefill(p, cfg, llm.embed_lookup(
                p["embed"], ids.to(dev)), m, cache)
            valid = torch.zeros(B, max_len, dtype=torch.bool, device=dev)
            valid[:, :S] = m.bool()
            pos0 = m.sum(dim=-1).to(torch.int32)
            snap = clone(cache)
            if dev == "cpu":
                out[dev] = verify(p, cache, valid, pos0)
                continue
            counts = (da.VERIFY_ATTENTION_INT8.launches,
                      cw.SCATTER_WRITE_MULTI.launches)
            with mock.patch.multiple(llm, verify_attention_int8=attn,
                                     scatter_write_multi=write):
                out[dev] = verify(p, cache, valid, pos0)
            launched = [da.VERIFY_ATTENTION_INT8.launches - counts[0],
                        cw.SCATTER_WRITE_MULTI.launches - counts[1]]
            with mock.patch.multiple(
                    llm,
                    verify_attention_int8=da.verify_attention_int8_reference,
                    scatter_write_multi=cw.scatter_write_multi_reference):
                out["plain"] = verify(p, clone(snap), valid, pos0)
    card = out["cuda"][1]

    with torch.inference_mode():
        # K8, layer by layer, on its own inputs
        k8 = []
        for a, kw, o in attn_calls:
            o_ref = da.verify_attention_int8_reference(*a, **kw).float()
            norm = torch.linalg.vector_norm
            do = o.float() - o_ref
            k8.append((float(norm(do) / norm(o_ref)),
                       float((norm(do, dim=-1) / norm(o_ref, dim=-1)).max())))
        # K9 on its own inputs; the committed slots are each layer's
        # in-pass k/v
        before, news, base = write_calls[0]
        cw.scatter_write_multi_reference(before, news, base)
        k9_equal = all(bool(torch.equal(x, y)) for x, y in zip(
            before, (card.k, card.k_scale, card.v, card.v_scale)))
        quant_equal = True
        for l, (a, _, _) in enumerate(attn_calls):
            for buf, sc, x in ((card.k, card.k_scale, a[6]),
                               (card.v, card.v_scale, a[7])):
                xq, xs = da.quantize_kv(x)           # [B, S_v, Hkv, *]
                quant_equal &= (bool(torch.equal(buf[l, :, :, new],
                                                 xq.transpose(1, 2)))
                                and bool(torch.equal(sc[l, :, :, new],
                                                     xs.transpose(1, 2))))

    def compare(a, b):
        """Committed caches: (masks and lengths equal, int8 max |d| of the
        new slots per layer)."""
        (_, ca, va), (_, cb, vb) = a, b
        same = (bool(torch.equal(va.cpu(), vb.cpu()))
                and bool(torch.equal(ca.length.cpu(), cb.length.cpu())))
        steps = [max(int((x[l, :, :, new].cpu().int()
                          - y[l, :, :, new].cpu().int()).abs().max())
                     for x, y in ((ca.k, cb.k), (ca.v, cb.v)))
                 for l in range(cfg.num_layers)]
        return same, steps

    seq, cache2, valid2 = [], snap, valid
    with torch.inference_mode():
        for i in range(S_v):
            lg, cache2, valid2 = llm.decode_step(
                lp, cfg, llm.embed_lookup(lp["embed"], toks[:, i].cuda())
                [:, None], cache2, valid2, pos0 + i)
            seq.append(lg)
    logits = out["cuda"][0]
    err_host = rel_err(torch, logits, out["cpu"][0])
    same_host, steps_host = compare(out["cuda"], out["cpu"])
    err_seq = rel_err(torch, logits, torch.stack(seq, dim=1))
    same_seq, steps_seq = compare(out["cuda"], (None, cache2, valid2))
    err_plain = rel_err(torch, logits, out["plain"][0])
    _, steps_plain = compare(out["cuda"], out["plain"])
    k8_ok = all(r <= BOUND_ATTN_REL and w <= BOUND_ATTN_ROW for r, w in k8)
    ok = (k8_ok and len(k8) == cfg.num_layers and k9_equal and quant_equal
          and launched == [cfg.num_layers, 1]
          and err_host <= BOUND_SMALL_W8A8 and same_host
          and err_seq <= BOUND_SMALL_W8A8 and same_seq)
    log(f"[small-ref] verify: depth-cut full width (LLM 2 layers, int8_full,"
        f" int8 cache, B={B}, prompt {S} with a left-padded row, S={S_v} "
        f"candidates, full commit; K8, K9 launches {launched}): K8 on each "
        f"layer's inputs vs its plain version rel L2 / max per (row, query, "
        f"head) " + ", ".join(f"{r:.2e} / {w:.2e}" for r, w in k8)
        + f" (<= {BOUND_ATTN_REL} / {BOUND_ATTN_ROW:.3e}); caches after K9 "
        f"bit-equal to the plain write {k9_equal}; committed slots bit-equal"
        f" to each layer's quantized in-pass k/v {quant_equal}; card vs "
        f"host: logits rel L2 {err_host:.3e} (<= {BOUND_SMALL_W8A8}), valid "
        f"mask and lengths equal {same_host}; card vs {S_v} sequential "
        f"decode_steps: logits rel L2 {err_seq:.3e} (<= {BOUND_SMALL_W8A8}),"
        f" valid mask and lengths equal {same_seq}; readings, new slots' int8"
        f" max |d| per layer: vs host {steps_host}, vs sequential "
        f"{steps_seq}, vs the card with K8/K9's plain versions {steps_plain}"
        f" (logits rel L2 {err_plain:.3e}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("verify_step disagrees with its kernels' plain "
                             "versions, the host or sequential decode steps")
    del lp, out, card, cache2, snap, attn_calls, write_calls
    torch.cuda.empty_cache()


def fused_iv2():
    """GVLLM_FUSED_IV2=1 inside the block, restored after it."""
    return mock.patch.dict(os.environ, {"GVLLM_FUSED_IV2": "1"})


def small_reference_fused_iv2(torch, cfg_full, seed, temporal):
    """A two-block full-width InternVideo2 trunk with W8A8 weights through
    the fused blocks (K10) on the card against the same int8 weights on the
    host (plain versions), one segment of the path's frames. LayerScale is
    set to 1: at its init of 1e-5 the blocks' outputs would vanish beside
    the residual and the comparison would see little but the patch
    embedding."""
    from grounded_video_llm_tpu_torch.core.config import replace
    from grounded_video_llm_tpu_torch.models import internvideo2 as iv2
    from grounded_video_llm_tpu_torch.models.vlm import _maybe_normalize
    from grounded_video_llm_tpu_torch.ops import fused_block as fb
    from grounded_video_llm_tpu_torch.ops.preprocess import (INTERNVIDEO_MEAN,
                                                             INTERNVIDEO_STD)
    from grounded_video_llm_tpu_torch.serve.quantize import \
        quantize_video_encoder_for_serving

    cfg = replace(cfg_full.video, depth=2, num_blocks_used=2)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    p = quantize_video_encoder_for_serving(iv2.init_params(
        cfg, generator=g, device="cuda", dtype=torch.bfloat16))
    for name in ("ls1", "ls2"):
        p["blocks"][name].fill_(1.0)
    frames = torch.from_numpy(temporal[None, :cfg.num_frames]).cuda()
    pixels = _maybe_normalize(frames, INTERNVIDEO_MEAN, INTERNVIDEO_STD,
                              torch.bfloat16)
    counters = (fb.FUSED_NORM_QUANT_GEMM, fb.FUSED_QUANT_GEMM_LS_RESIDUAL)
    with torch.inference_mode():
        unfused = iv2.features(p, cfg, pixels)
        before = [k.launches for k in counters]
        with fused_iv2():
            card = iv2.features(p, cfg, pixels)
            launched = [k.launches - b for k, b in zip(counters, before)]
            host = iv2.features(to_host(p), cfg, pixels.cpu())
    err = rel_err(torch, card, host)
    vs_unfused = rel_err(torch, card, unfused)
    ok = (err <= BOUND_SMALL_W8A8 and launched == [4, 4]
          and bool(torch.isfinite(card).all()))
    log(f"[small-ref] fused IV2: 2 full-width W8A8 blocks, 1 segment "
        f"{tuple(card.shape)}, card K10 vs host plain versions rel L2 "
        f"{err:.3e} (<= {BOUND_SMALL_W8A8}), K10 launches {launched} (want "
        f"[4, 4]); card fused vs card unfused W8A8 rel L2 {vs_unfused:.3e} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the fused InternVideo2 trunk disagrees with "
                             "the host reference")
    del p, card, host, unfused
    torch.cuda.empty_cache()


def small_reference_static_iv2(torch, cfg_full, seed, temporal):
    """A two-block full-width InternVideo2 trunk with W8A8 weights and
    static activation scales on all four legs, calibrated on the card
    (features_absmax on one segment of the path's frames): card against
    the same int8 weights and scales on the host (plain versions).
    LayerScale is set to 1, as in the fused check."""
    from grounded_video_llm_tpu_torch.core.config import replace
    from grounded_video_llm_tpu_torch.models import internvideo2 as iv2
    from grounded_video_llm_tpu_torch.models.vlm import _maybe_normalize
    from grounded_video_llm_tpu_torch.ops.preprocess import (INTERNVIDEO_MEAN,
                                                             INTERNVIDEO_STD)
    from grounded_video_llm_tpu_torch.serve import calibrate
    from grounded_video_llm_tpu_torch.serve.quantize import \
        quantize_video_encoder_for_serving

    cfg = replace(cfg_full.video, depth=2, num_blocks_used=2)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    p = quantize_video_encoder_for_serving(iv2.init_params(
        cfg, generator=g, device="cuda", dtype=torch.bfloat16))
    for name in ("ls1", "ls2"):
        p["blocks"][name].fill_(1.0)
    frames = torch.from_numpy(temporal[None, :cfg.num_frames]).cuda()
    pixels = _maybe_normalize(frames, INTERNVIDEO_MEAN, INTERNVIDEO_STD,
                              torch.bfloat16)
    with torch.inference_mode():
        dynamic, stats = iv2.features_absmax(p, cfg, pixels)
        static = calibrate.apply_static_scales(
            p, {k: t.cpu().numpy() for k, t in stats.items()},
            legs=calibrate.LEGS)
        card = iv2.features(static, cfg, pixels)
        host = iv2.features(to_host(static), cfg, pixels.cpu())
    err = rel_err(torch, card, host)
    vs_dynamic = rel_err(torch, card, dynamic)
    scales = [float(static["blocks"]["fc2"]["kernel"].x_scale[i])
              for i in range(cfg.depth)]
    ok = err <= BOUND_SMALL_W8A8 and bool(torch.isfinite(card).all())
    log(f"[small-ref] static IV2: 2 full-width W8A8 blocks with static "
        f"scales on qkv, proj, fc1, fc2 (calibrated on the card; fc2 "
        f"x_scale {scales}), 1 segment {tuple(card.shape)}, card vs host "
        f"plain versions rel L2 {err:.3e} (<= {BOUND_SMALL_W8A8}); card "
        f"static vs card dynamic W8A8 rel L2 {vs_dynamic:.3e} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the static-scale InternVideo2 trunk disagrees "
                             "with the host reference")
    del p, static, card, host, dynamic
    torch.cuda.empty_cache()


def small_reference_quant_ab(torch, cfg_full, seed):
    """serve/quant_ab on the depth-cut full-width model of small_reference
    (CLIP 2 of 3 layers, IV2 2 blocks, LLM 2 layers, 1 segment): bf16
    against int8_full with static scales calibrated on the same frames,
    two prompts, 8 greedy tokens, on the card. With random weights the
    metrics are readings; no verdict is asserted."""
    from grounded_video_llm_tpu_torch.cli.model_loading import (
        build_params, build_tokenizer)
    from grounded_video_llm_tpu_torch.core.config import replace
    from grounded_video_llm_tpu_torch.serve import calibrate, quant_ab
    from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine
    from grounded_video_llm_tpu_torch.text.tokenizer import \
        pad_batch_generate

    n_frames = cfg_full.video.num_frames
    cfg = replace(cfg_full, num_frames=n_frames, num_segs=1,
                  clip=replace(cfg_full.clip, num_layers=3),
                  video=replace(cfg_full.video, depth=2, num_blocks_used=2),
                  llm=replace(cfg_full.llm, num_layers=2))
    tok = build_tokenizer(cfg)
    bf16 = build_params(cfg, "cuda", torch.bfloat16, seed)
    eng = InferenceEngine(bf16, cfg, tok, quantize="int8_full")
    temporal, spatial = eng.preprocess_frames(synthetic_video(seed + 2,
                                                              n_frames))
    quant = calibrate.calibrate_and_apply(eng.params, cfg, [temporal[None]])
    seqs = [eng.tokenize_prompt(eng.build_prompt(p, m, 30.0))
            for m, p in MODES[:2]]
    ids, mask = pad_batch_generate(seqs, tok.pad_token_id, cfg.max_txt_len)
    B = len(seqs)
    sp = np.broadcast_to(spatial[None], (B, *spatial.shape))
    tp = np.broadcast_to(temporal[None], (B, *temporal.shape))
    m = quant_ab.run_quant_ab(bf16, quant, cfg, ids, mask, sp, tp,
                              max_new_tokens=8,
                              eos_token_id=tok.eos_token_id,
                              pad_token_id=tok.pad_token_id)
    log(f"[small-ref] quant_ab (bf16 vs int8_full + static scales on fc2 "
        f"and proj, depth-cut, B={B}, 8 greedy tokens), readings: "
        f"mean KL {m['mean_kl_nats']:.3e} nats, top-1 agreement "
        f"{m['top1_agreement']:.3f}, greedy exact {m['greedy_exact_rate']:.3f}"
        f", greedy prefix agreement {m['greedy_prefix_agreement']:.3f}; the "
        f"committed bar {m['thresholds']} says pass={m['pass']} (random "
        "weights: no verdict)")
    if not np.isfinite(m["mean_kl_nats"]):
        raise AssertionError("quant_ab: non-finite KL")
    del bf16, eng, quant
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Training: samples, the model-FLOP formula, the small reference
# ---------------------------------------------------------------------------


def grounded_text(seed: int, rounds: int, llm_name: str = "phi3.5") -> str:
    """A grounded conversation rendered by the LLM's template: the video
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
    return get_template(llm_name).encode(
        codec.mark_grounding_conversations(conv))


def train_samples(temporal, spatial, n: int, rounds: int, seed: int,
                  llm_name: str = "phi3.5"):
    """n grounded samples over one resized video (uint8 pixels, normalized
    on the card by encode_video)."""
    return [{"video_ids": f"synthetic{i}", "text_inputs":
             grounded_text(seed + i, rounds, llm_name),
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
    sample = train_samples(temporal, spatial, 1, 6, seed, cfg.llm_name)[0]
    out = {}
    for dev, p in (("cpu", to_host(params, torch.float32)),
                   ("cuda", params)):
        opt, _ = make_optimizer(STAGE_PRESETS["grounded"], 10, p)
        set_trainable(p, opt)
        batch = collate([sample], tok, get_template(cfg.llm_name),
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
    log(f"[small-ref] train {cfg.llm_name}: depth-cut full width (CLIP 2 of "
        f"3 layers, IV2 2 blocks, LLM 2 layers, LoRA r=128 with B != 0, 1 "
        f"segment, spliced "
        f"length {spliced}), card bf16 kernels vs host fp32 plain versions: "
        f"loss {float(out['cuda'][0]):.5f} vs {float(out['cpu'][0]):.5f} "
        f"rel {loss_err:.3e} (<= {BOUND_TRAIN_LOSS}); gradient rel L2 over "
        f"{len(errs)} trainable leaves: max {errs[worst]:.3e} ({worst}), "
        f"median {float(np.median(list(errs.values()))):.3e} (<= "
        f"{BOUND_TRAIN_GRAD}); host {out['cpu'][2]:.1f} s, card "
        f"{out['cuda'][2]:.2f} s {'OK' if ok else 'FAIL'}")
    log(f"[small-ref] train {cfg.llm_name} gradients: " + ", ".join(
        f"{n} {e:.2e}" for n, e in sorted(errs.items())))
    if not ok:
        raise AssertionError("training on the card disagrees with the host "
                             "reference")
    del params, out
    torch.cuda.empty_cache()


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
    key = "decode_steps" if "decode_steps" in t else "verify_passes"
    steps = max(t[key], 1)
    log(f"[path] {name}: prompt_tokens={t['prompt_len']} "
        f"new_tokens={t['new_tokens']} {key}={t[key]} "
        f"encode_ms={t['encode'] * 1e3:.1f} prefill_ms={t['prefill'] * 1e3:.1f}"
        f" decode_ms={t['decode'] * 1e3:.1f} decode_ms_per_"
        f"{'step' if key == 'decode_steps' else 'pass'}="
        f"{t['decode'] * 1e3 / steps:.2f} peak_device_memory={peak:.2f} GiB")
    log(f"[path] {name}: launches {got} expected {want}")
    if got != want:
        raise AssertionError(f"{name}: launch counts {got}, expected {want}")
    return got


def spec_path(torch, cfg, engine, batch, prompts, t_a, tokens_a, temporal,
              spatial):
    """After path D: its encode next to path A's, its passes and accepted
    drafts per pass; then two legs through
    generate_tokens_spec_from_features on the path's features, outside the
    counted run: an oracle table (prompt + path A's greedy tokens) and a
    sampled leg at temperature 0.7 whose tokens must lie in the
    vocabulary. Greedy
    streams depend on where the passes fall under the int8 cache (and path
    D's fused encoder gives other features than path A's), so agreement and
    acceptance are reported, not asserted."""
    from grounded_video_llm_tpu_torch.models import vlm
    from grounded_video_llm_tpu_torch.serve.speculative import \
        generate_tokens_spec_from_features
    from grounded_video_llm_tpu_torch.text.tokenizer import \
        pad_batch_generate

    t = engine.last_timings
    B, P = len(batch), t["verify_passes"]
    tokens_d, lengths_d = engine.last_tokens
    log(f"[path] D vs A: encode {t['encode']:.3f} s (fused W8A8 IV2) vs "
        f"{t_a['encode']:.3f} s (unfused W8A8) for the same {B} videos; "
        f"prefill {t['prefill']:.3f} s; {P} verify passes, "
        f"{t['decode'] * 1e3 / max(P, 1):.2f} ms per pass; accepted drafts "
        f"per pass {float(lengths_d.float().mean()) / max(P, 1) - 1:.3f}; "
        f"tokens equal to path A's "
        f"{float((tokens_d == tokens_a).float().mean()):.3f}")
    tok = engine.tokenizer
    seqs = [engine.tokenize_prompt(p) for p in prompts(batch, engine)]
    ids, am = (torch.from_numpy(np.asarray(a)).long().cuda() for a in
               pad_batch_generate(seqs, tok.pad_token_id, cfg.max_txt_len))

    def dev(a):
        return torch.from_numpy(np.broadcast_to(a[None], (B, *a.shape))
                                .copy()).cuda()

    with fused_iv2(), torch.inference_mode():
        feats = vlm.encode_video(engine.params, cfg, dev(spatial),
                                 dev(temporal))
    want = (B, cfg.num_video_tokens, cfg.llm.hidden_size)
    if tuple(feats.shape) != want or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"path D's fused features {tuple(feats.shape)} "
                             f"(want {want}) are malformed or not finite")
    kw = dict(max_new_tokens=MAX_NEW_TOKENS, draft_len=SPEC_DRAFT_LEN,
              eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
              with_stats=True)
    table = torch.cat([ids, tokens_a.cuda()], dim=1)
    out, lens, p_o = generate_tokens_spec_from_features(
        engine.params, cfg, ids, am, feats, None, draft_table=table,
        do_sample=False, **kw)
    agree = float((out.cpu() == tokens_a).float().mean())
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    out_s, lens_s, p_s = generate_tokens_spec_from_features(
        engine.params, cfg, ids, am, feats, g, do_sample=True,
        temperature=0.7, **kw)
    V = cfg.llm.padded_vocab_size
    in_range = bool(((out_s >= 0) & (out_s < V)).all())
    log(f"[path] D features {tuple(feats.shape)} finite; oracle leg (draft "
        f"table = prompt + path A's greedy tokens): {p_o} passes, accepted drafts per pass "
        f"{float(lens.float().mean()) / p_o - 1:.3f}, tokens equal to path "
        f"A's {agree:.3f}; sampled leg (temperature 0.7): {p_s} passes, "
        f"accepted drafts per pass {float(lens_s.float().mean()) / p_s - 1:.3f}"
        f", tokens in [0, {V}): {in_range}")
    if not in_range or tuple(out_s.shape) != (B, MAX_NEW_TOKENS):
        raise AssertionError("the sampled speculative leg emitted tokens "
                             "outside the vocabulary")
    del feats
    torch.cuda.empty_cache()


def static_path(torch, kernels, params, cfg, tok, gen, batch, prompts,
                temporal, spatial, t_a, expect_fn):
    """Path E: path A's batch (int8_full, int8 cache, B = 6) through an
    engine with static_scales=True. Counted like the other paths; its
    counts must be path A's formula plus the one calibration pass's IV2
    blocks (K1). Then: one calibration, x_scale on fc2 and proj of every
    stacked block (the blocks run calibrated, the early-exit tail padded
    with 1.0), none on qkv and fc1, and finite features of the right
    shape."""
    from grounded_video_llm_tpu_torch.models import vlm
    from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine

    eng = InferenceEngine(params, cfg, tok, gen, seed=SEED,
                          quantize="int8_full", static_scales=True)

    def fn():
        texts = eng.generate(prompts(batch, eng), temporal, spatial, gen)
        for (m, _), text in zip(batch, texts):
            r = eng._result(text, 96.0)
            log(f"[path]   {m}: text={r.text!r} parsed={r.parsed!r} "
                f"intervals={r.intervals}")
        return eng.last_timings

    got = run_path(torch, kernels, "E int8_full int8-cache static-scales B=6",
                   fn, expect_fn)
    t = eng.last_timings
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    v = cfg.video
    blocks = eng.params["video_encoder"]["blocks"]
    checks = []
    for leg in ("fc2", "proj"):
        xs = blocks[leg]["kernel"].x_scale
        run = xs[:v.num_blocks_used]
        checks.append(xs is not None and tuple(xs.shape) == (v.depth,)
                      and bool(torch.isfinite(run).all())
                      and bool((run > 0).all())
                      and bool((xs[v.num_blocks_used:] == 1.0).all()))
        log(f"[path] E {leg} x_scale: {v.num_blocks_used} calibrated "
            f"[{float(run.min()):.4g}, {float(run.max()):.4g}], "
            f"{v.depth - v.num_blocks_used} padded with 1.0")
    none_elsewhere = (blocks["qkv_kernel"].x_scale is None
                      and blocks["fc1"]["kernel"].x_scale is None)
    with torch.inference_mode():
        feats = vlm.encode_video(eng.params, cfg,
                                 torch.from_numpy(spatial[None]).cuda(),
                                 torch.from_numpy(temporal[None]).cuda())
    want = (1, cfg.num_video_tokens, cfg.llm.hidden_size)
    good = tuple(feats.shape) == want and bool(torch.isfinite(feats).all())
    ok = eng.calibrations == 1 and all(checks) and none_elsewhere and good
    log(f"[path] E vs A: encode {t['encode']:.3f} s (static scales on fc2 "
        f"and proj) vs {t_a['encode']:.3f} s (dynamic) for the same 6 "
        f"videos, after one calibration pass of {t['calibrate']:.3f} s over "
        f"their {len(batch) * cfg.num_segs} clips; prefill {t['prefill']:.3f} s, "
        f"decode {t['decode'] * 1e3 / max(t['decode_steps'], 1):.2f} ms per "
        f"step; peak_device_memory={peak:.2f} GiB; calibrations "
        f"{eng.calibrations}; x_scale on fc2 and proj only {none_elsewhere};"
        f" features {tuple(feats.shape)} finite {good} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path E: static scales not calibrated once on "
                             "the legs expected, or features malformed")
    del eng, feats
    torch.cuda.empty_cache()
    return got


STATIC_REPS = 1     # rounds of microbench/static_scales in the path


def microbench_expect(cfg, zero):
    """The launch counts of microbench_path, from the modules' shapes,
    variants and repetitions: timing.device_ms calls fn once to warm up and
    R times between its events, and with graph=True once more on a side
    stream before capturing the R calls (a replay launches through no
    wrapper). encoder_attn times its seven modes, dh128 and S2048 through
    M2 and mha (K1) once; static_scales runs the IV2 trunk (K1 in each of
    the blocks it runs) for the calibration, a warm-up and one round over
    its trees; flash_bwd runs K2 once for its lse, then K2 alone, K7 alone
    and both through autograd; iv2_block runs three blocks with attention
    (K1 each) and three without, two of them fused (two K10 launches of
    each entry a block), then one fused GEMM per leg."""
    from grounded_video_llm_tpu_torch.microbench import (decode, encoder_attn,
                                                         flash_bwd, int8_gemm,
                                                         iv2_block,
                                                         static_scales)

    def calls(reps, graph=False):
        return reps + (2 if graph else 1)

    gemm = len(int8_gemm.SHAPES) * calls(int8_gemm.R)
    gemv = len(decode.PROJECTIONS) * calls(decode.R, graph=True)
    iv2 = 2 + STATIC_REPS * len(static_scales.VARIANTS)
    blocks = calls(iv2_block.R)
    # per fused block 2 launches of each K10 entry; qkv/fc1 and proj/fc2
    # legs one each
    k10 = (2 * 2 + 2) * blocks
    return dict(zero, int8_gemm=gemm, int8_gemm_dynamic=gemm,
                i8i8_gemv=gemv, int8_gemv=gemv, int8_matmul=gemv,
                decode_attention_int8=calls(decode.R, graph=True),
                flash_variant=(len(encoder_attn.MODES) + 2)
                * calls(encoder_attn.R),
                flash_fwd=calls(encoder_attn.R)
                + cfg.video.num_blocks_used * iv2
                + 1 + 2 * calls(flash_bwd.R)
                + len(iv2_block.BLOCKS) * blocks,
                flash_bwd=2 * calls(flash_bwd.R),
                fused_norm_quant_gemm=k10,
                fused_quant_gemm_ls_residual=k10)


def microbench_path(torch, kernels, cfg, zero):
    """The port's six microbenchmarks, each module's main once at its
    script's shapes (static_scales with STATIC_REPS rounds), counted as one
    path: the launch counts must equal microbench_expect's (K5, K8 and K9
    at zero)."""
    from grounded_video_llm_tpu_torch.microbench import (decode, encoder_attn,
                                                         flash_bwd, int8_gemm,
                                                         iv2_block,
                                                         static_scales)

    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, mod, argv in (("int8_gemm", int8_gemm, []),
                            ("decode", decode, []),
                            ("encoder_attn", encoder_attn, []),
                            ("static_scales", static_scales,
                             ["72", str(STATIC_REPS)]),
                            ("flash_bwd", flash_bwd, []),
                            ("iv2_block", iv2_block, [])):
        t1 = time.perf_counter()
        log(f"[microbench] {name}:")
        mod.main(argv)
        torch.cuda.empty_cache()
        log(f"[microbench] {name} took {time.perf_counter() - t1:.1f} s")
    got = {n: k.launches for n, k in kernels.items()}
    want = microbench_expect(cfg, zero)
    log(f"[microbench] launches {got} expected {want} in "
        f"{time.perf_counter() - t0:.1f} s")
    if got != want:
        raise AssertionError(f"microbench path: launch counts {got}, "
                             f"expected {want}")
    return got


def expect_counts(zero, nl, flash_n, w8a8_per_step, quant_cache,
                  k6_per_step):
    """A serving path's launch counts as a function of its timings (decode
    steps s): flash_n flash_fwd a request; per step w8a8_per_step w8a8
    int8_gemv, nl decode_attention_int8 and one scatter_write with the int8
    cache, k6_per_step weight-only int8_matmul (plus one a request, the
    prefill's lm_head) where it runs."""
    def fn(t):
        s = t["decode_steps"]
        return dict(zero, flash_fwd=flash_n, int8_gemv=w8a8_per_step * s,
                    decode_attention_int8=nl * s if quant_cache else 0,
                    scatter_write=s if quant_cache else 0,
                    int8_matmul=(1 + k6_per_step * s) if k6_per_step else 0)
    return fn


def encode_chunk_check(torch, vlm, params, cfg, temporal, spatial,
                       chunk=4):
    """One bf16 B=1 encode at full width twice, whole and with
    encoder_chunk_clips=chunk (InternVideo2 over the 12 clips chunk at a
    time): the same kernels on the same clips, so the features must agree
    within relative L2 1e-6; each run's time and the peak device memory it
    added are printed."""
    from grounded_video_llm_tpu_torch.core.config import replace

    sp = torch.from_numpy(spatial[None]).cuda()
    tp = torch.from_numpy(temporal[None]).cuda()
    out = {}
    for name, c in (("whole", cfg),
                    (f"encoder_chunk_clips={chunk}",
                     replace(cfg, encoder_chunk_clips=chunk))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out[name] = vlm.encode_video(params, c, sp, tp)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        log(f"[encode-chunk] {cfg.llm_name} bf16 B=1 encode, {name}: "
            f"{ms:.1f} ms, peak device memory above the weights "
            f"{peak:.3f} GiB")
    a, b = out.values()
    err = rel_err(torch, b, a)
    ok = (err <= 1e-6 and a.shape == b.shape
          and bool(torch.isfinite(b).all()))
    log(f"[encode-chunk] features {tuple(b.shape)} chunked vs whole: rel L2 "
        f"{err:.3e} (<= 1e-06) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the clip-chunked encode disagrees with the "
                             "whole one")


def llama3_kernel_phase(torch, fa, mm, da, cw, cfg, S_pre, max_len):
    """The serving kernels at full-width llama3's own shapes (readings;
    each case is still held to its kernel's bar): K2 at its prefill [1,
    S_pre, 32, 128] with 8 kv heads beside SDPA; K3's w8a8 branch at M = 6
    on the four projections over 32 layers (a mode A step) beside
    torch._int_mm; K4 at B = 6, G = 4 over max_len slots and 32 layers; K5
    on mode A's four cache buffers [32, 6, 8, max_len, 128] (write_phase:
    bit-equal, same storage, every other byte untouched); K6 on the
    128,558-row vocabulary beside torch._weight_int8pack_mm."""
    L = cfg.llm
    nl, D = L.num_layers, L.hidden_size
    fams = []
    r = check_flash(torch, fa, "llama3_prefill", B=1, Sq=S_pre,
                    H=L.num_heads, D=L.head_dim, Hkv=L.num_kv_heads,
                    causal=True, pads=(0,), seed=200)
    k2 = Family("flash_fwd")
    k2.add(nl, r["ms"], r["plain_ms"], r["bytes"], r["flops"], "bf16",
           r["library_ms"])
    fams.append((k2, f"llama3 prefill (32 launches at S={S_pre})"))
    shapes = {"qkv": (D, L.q_dim + 2 * L.kv_dim), "o": (L.q_dim, D),
              "gate_up": (D, 2 * L.intermediate_size),
              "down": (L.intermediate_size, D)}
    k3 = Family("int8_gemv")
    for j, (pname, (d, o)) in enumerate(shapes.items()):
        r = check_gemv(torch, mm, f"int8_gemv llama3 {pname}", 6, d, o,
                       layers=nl, w8a8=True, timed=True, seed=210 + j)
        k3.add(nl, r["ms"], r["plain_ms"], r["bytes"], r["ops"], "int8",
               r["library_ms"])
    fams.append((k3, "llama3 mode A step (128 launches at M=6)"))
    r = check_attention(torch, da, "llama3_b6", 6, L.num_heads,
                        L.num_kv_heads, L.head_dim, max_len, layers=nl,
                        timed=True, seed=220)
    k4 = Family("decode_attention_int8")
    k4.add(nl, r["ms"], r["plain_ms"], r["bytes"], r["ops"])
    fams.append((k4, f"llama3 mode A step (32 launches, B=6, G=4, "
                 f"{max_len} slots)"))
    fams.append((write_phase(torch, cw, cfg, max_len),
                 f"llama3 mode A step (1 launch, B=6, {max_len} slots)"))
    r = check_gemv(torch, mm, "int8_matmul llama3 lm_head", 6, D,
                   L.padded_vocab_size, layers=LM_HEAD_COPIES, timed=True,
                   seed=230)
    k6 = Family("int8_matmul")
    k6.add(1, r["ms"], r["plain_ms"], r["bytes"], r["ops"],
           library_ms=r["library_ms"])
    fams.append((k6, f"llama3 lm_head at M=6 ({L.padded_vocab_size} rows)"))
    for fam, what in fams:
        bms, by = fam.bound()
        lib = (f"{fam.library_ms:.4f} ms" if fam.library_ms is not None
               else "none")
        log(f"[kernel] {fam.name} per {what}: kernel {fam.ms:.4f} ms, plain "
            f"{fam.plain_ms:.4f} ms, library {lib}, bound {bms:.4f} ms "
            f"({by}), {100 * bms / fam.ms:.1f}% of the bound reached")


def llama3_path(torch, kernels, zero, generate, temporal, spatial,
                resize_ms):
    """Full-width llama3 (vlm_config("llama3", stage="inference"):
    Meta-Llama-3-8B, 32 layers, 32 heads, 8 kv heads of 128; CLIP ViT-L/14
    and InternVideo2-1B as in the Phi-3.5 paths), seeded random bf16
    weights, on the frames the Phi-3.5 paths resized: the chunked encode
    check, the kernels at llama3's shapes, then a bf16 B=1 request and a
    mode A request (int8_full, int8 cache, B=6), their launch counts held
    to the config's, their tokens in the vocabulary and their texts
    parsed. → (the summed launch counts, the bf16 params)."""
    from grounded_video_llm_tpu_torch.cli.model_loading import (
        build_params, build_tokenizer)
    from grounded_video_llm_tpu_torch.core.config import (GenerateConfig,
                                                          vlm_config)
    from grounded_video_llm_tpu_torch.models import vlm
    from grounded_video_llm_tpu_torch.ops import cache_write as cw
    from grounded_video_llm_tpu_torch.ops import decode_attention_int8 as da
    from grounded_video_llm_tpu_torch.ops import flash_attention as fa
    from grounded_video_llm_tpu_torch.ops import int8_matmul as mm
    from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine

    cfg = vlm_config("llama3", stage="inference")
    L = cfg.llm
    tok = build_tokenizer(cfg)
    t0 = time.perf_counter()
    params = build_params(cfg, "cuda", torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    log(f"[params] full-width llama3 bf16 built on the card in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    encode_chunk_check(torch, vlm, params, cfg, temporal, spatial)

    gen_cfg = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False)
    gen_int8 = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False,
                              quantize_cache=True)
    bf16 = InferenceEngine(params, cfg, tok, gen_cfg, seed=SEED)
    S_pre = (len(bf16.tokenize_prompt(bf16.build_prompt(
        MODES[0][1], MODES[0][0], 96.0))) - 1 + cfg.num_video_tokens)
    batch6 = [x for pair in zip(MODES, MODES_2) for x in pair]
    S_pre6 = (max(len(bf16.tokenize_prompt(bf16.build_prompt(p, m, 96.0)))
                  for m, p in batch6) - 1 + cfg.num_video_tokens)
    llama3_kernel_phase(torch, fa, mm, da, cw, cfg, S_pre,
                        -(-(S_pre6 + MAX_NEW_TOKENS) // 128) * 128)

    per_req = (cfg.clip.num_layers + cfg.clip.feature_layer + 1
               + cfg.video.num_blocks_used + L.num_layers)
    n_vocab = L.vocab_size + L.num_extra_tokens
    launches = dict(zero)
    full = InferenceEngine(params, cfg, tok, gen_int8, seed=SEED,
                           quantize="int8_full")
    for name, engine, batch, g, want in (
            ("llama3 bf16 B=1", bf16, [MODES[0]], gen_cfg,
             expect_counts(zero, L.num_layers, per_req, 0, False, 0)),
            ("llama3 A int8_full int8-cache B=6", full, batch6, gen_int8,
             expect_counts(zero, L.num_layers, per_req, 4 * L.num_layers,
                           True, 1))):
        got = run_path(torch, kernels, name, generate(engine, batch, g), want)
        launches = {k: launches[k] + got[k] for k in launches}
        t = engine.last_timings
        tokens = engine.last_tokens[0]
        in_range = bool(((tokens >= 0) & (tokens < n_vocab)).all())
        steps = max(t["decode_steps"], 1)
        S = t["prompt_len"] - 1 + cfg.num_video_tokens
        log(f"[path] {name}: prefill length {S} tokens; latency preprocess "
            f"{resize_ms:.1f} ms (the shared resize, run once for every "
            f"path) + encode {t['encode'] * 1e3:.1f} + prefill "
            f"{t['prefill'] * 1e3:.1f} + decode {t['decode'] * 1e3:.1f} ms "
            f"({t['decode'] * 1e3 / steps:.2f} ms/step over "
            f"{t['decode_steps']} steps); tokens {tuple(tokens.shape)} in "
            f"[0, {n_vocab}): {in_range} {'OK' if in_range else 'FAIL'}")
        if not in_range:
            raise AssertionError(f"{name}: tokens outside the vocabulary")
    del full, bf16
    torch.cuda.empty_cache()
    return launches, params


def llama3_train_kernel_phase(torch, fa, cfg):
    """K2 and K7 at full-width llama3's grounded training shape: [1, S, 32,
    128] with 8 kv heads (G = 4), causal, S the spliced length of a sample
    at max_txt_len (4,096 text tokens, the video slot one of them, plus
    2,316 video tokens). K2 with every key kept, K7 right-padded as collate
    pads; each held to its plain version at the existing bars (K7: two
    launches bit-equal), graph-replay timed beside SDPA's fastest causal
    forward and backward at the same shape (enable_gqa or K/V expanded,
    whichever is faster, named) and the bound: 2 products over the visible
    pairs for K2, 5 for K7."""
    L = cfg.llm
    S = cfg.max_txt_len - 1 + cfg.num_video_tokens
    log(f"[kernel] llama3 grounded training shape: S = {cfg.max_txt_len} "
        f"text - 1 + {cfg.num_video_tokens} video = {S} tokens, "
        f"{L.num_heads} heads and {L.num_kv_heads} kv heads of {L.head_dim}")
    r2 = check_flash(torch, fa, "llama3_train_causal", 1, S, L.num_heads,
                     L.head_dim, Hkv=L.num_kv_heads, causal=True, pads=(0,),
                     seed=240)
    r7 = check_flash_bwd(torch, fa, "llama3_train_causal", 1, S, L.num_heads,
                         L.head_dim, Hkv=L.num_kv_heads, pads=(37,),
                         seed=241, timed=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(242)
    q = torch.randn(1, S, L.num_heads, L.head_dim, generator=g,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(1, S, L.num_kv_heads, L.head_dim, generator=g,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    fwd_ms, fwd_how = sdpa_forward_ms(torch, q, k, v, L.head_dim ** -0.5,
                                      10)
    del q, k, v
    torch.cuda.empty_cache()
    for name, r, lib, how, per_mb in (
            ("flash_fwd (K2)", r2, fwd_ms, fwd_how, 2 * L.num_layers),
            ("flash_bwd (K7)", r7, r7["library_ms"], "the check's fastest",
             L.num_layers)):
        bms, by = bound_ms(r["bytes"], r["flops"], BF16_OPS)
        log(f"[kernel] llama3 train {name} [1, {S}, {L.num_heads}, "
            f"{L.head_dim}] Hkv {L.num_kv_heads}: kernel {r['ms']:.4f} ms "
            f"({r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s), plain "
            f"{r['plain_ms']:.4f} ms, SDPA {lib:.4f} ms ({how}), bound "
            f"{bms:.4f} ms ({by}), {100 * bms / r['ms']:.1f}% of the bound "
            f"reached; x{per_mb} a microbatch: {per_mb * r['ms']:.2f} ms")


def roundtrip_phase(torch, workdir):
    """The reference formats at full llama3 width: a vlm_config("llama3",
    stage="grounded") tree, depth cut (LLM 2 of 32 layers, CLIP 2 of 24,
    InternVideo2 2 of 40 blocks; width, the 128,558-row vocabulary and
    the q/k/v split kept), seeded random bf16 on the card, written by
    models/export.write_weight_dumps in the weights-day layout (float32,
    as the reference ships), then read back by build_params(weight_root=,
    video_encoder_path=, stage_ckpt=) onto the card: every leaf must be
    bit-equal to its source. Prints the bytes written and the seconds
    spent writing and reading."""
    from grounded_video_llm_tpu_torch.cli.model_loading import build_params
    from grounded_video_llm_tpu_torch.core.config import replace, vlm_config
    from grounded_video_llm_tpu_torch.models.export import write_weight_dumps
    from grounded_video_llm_tpu_torch.train.optimizer import tree_items

    full = vlm_config("llama3", stage="grounded")
    cfg = replace(full, llm=replace(full.llm, num_layers=2),
                  clip=replace(full.clip, num_layers=2),
                  video=replace(full.video, depth=2, num_blocks_used=2))
    src = build_params(cfg, "cuda", torch.bfloat16, seed=SEED + 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = write_weight_dumps(src, cfg, workdir)
    write_s = time.perf_counter() - t0
    sizes = {}
    for root, _, files in os.walk(workdir):
        for f in files:
            sizes[f] = os.path.getsize(os.path.join(root, f))
    t0 = time.perf_counter()
    got = build_params(cfg, "cuda", torch.bfloat16, seed=SEED + 6,
                       weight_root=paths["weight_root"],
                       video_encoder_path=paths["video_encoder"],
                       stage_ckpt=paths["stage_ckpt"])
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    want, have = dict(tree_items(src)), dict(tree_items(got))
    bad = sorted(p for p, t in want.items()
                 if p not in have or have[p].dtype != t.dtype
                 or not torch.equal(have[p], t))
    ok = not bad and set(want) == set(have)
    log(f"[roundtrip] llama3 full width (hidden {cfg.llm.hidden_size}, "
        f"vocabulary {cfg.llm.padded_vocab_size}, q/k/v "
        f"{cfg.llm.q_dim}/{cfg.llm.kv_dim}/{cfg.llm.kv_dim}), depth cut: LLM "
        f"2 of 32 layers, CLIP 2 of 24, InternVideo2 2 of 40 blocks; "
        f"{sum(sizes.values())} bytes in {len(sizes)} files ("
        + ", ".join(f"{f} {n}" for f, n in sorted(sizes.items()))
        + f"); written in {write_s:.2f} s, read onto the card by "
        f"build_params in {read_s:.2f} s; {len(want)} leaves bit-equal to "
        f"the bf16 source: {ok} {'OK' if ok else 'FAIL'}")
    del src, got
    torch.cuda.empty_cache()
    shutil.rmtree(workdir, ignore_errors=True)
    if not ok:
        raise AssertionError(f"reference-format round trip: {bad[:8]} differ")


def trained_reload_path(torch, kernels, zero, generate, strat, tok, workdir):
    """The trained llama3 strategy's reference-format export
    (export_reference_checkpoint, trainable only: projectors, embed and
    lm_head), read by build_params(stage_ckpt=) over the seeded frozen tree
    the run started from: the projectors, embed and lm_head must be
    bit-equal to the trained ones and every other non-LoRA leaf to the
    run's; then one bf16 B=1 request on the loaded tree, its K1/K2 launch
    counts the config's and its tokens in the vocabulary. → launches."""
    from grounded_video_llm_tpu_torch.cli.model_loading import build_params
    from grounded_video_llm_tpu_torch.core.config import (GenerateConfig,
                                                          vlm_config)
    from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine
    from grounded_video_llm_tpu_torch.train.optimizer import tree_items

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "grounded_llava_next_video_llama3_"
                        "mix_grounded.pth")
    t0 = time.perf_counter()
    strat.export_reference_checkpoint(path)
    write_s = time.perf_counter() - t0
    trained = {p: t for p, t in tree_items(strat.state.params)
               if "/lora/" not in p}
    cfg = vlm_config("llama3", stage="inference")
    t0 = time.perf_counter()
    loaded = build_params(cfg, "cuda", torch.bfloat16, seed=SEED,
                          stage_ckpt=path)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    have = dict(tree_items(loaded))
    read = ("mm_projector/", "video_projector/", "llm/embed", "llm/lm_head")
    bad = sorted(p for p, t in trained.items()
                 if not torch.equal(have[p], t.detach()))
    n_read = sum(p.startswith(read) for p in trained)
    ok = not bad and set(have) == set(trained)
    log(f"[reload] trained llama3 export {os.path.getsize(path)} bytes "
        f"written in {write_s:.2f} s, read by build_params(stage_ckpt=) in "
        f"{read_s:.2f} s: {n_read} leaves read (projectors, embed, lm_head) "
        f"and {len(trained) - n_read} seeded frozen leaves bit-equal to the "
        f"trained run's: {ok} {'OK' if ok else 'FAIL'}")
    del trained
    shutil.rmtree(workdir, ignore_errors=True)
    if not ok:
        raise AssertionError(f"reloaded trained export differs: {bad[:8]}")
    L = cfg.llm
    gen_cfg = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False)
    engine = InferenceEngine(loaded, cfg, tok, gen_cfg, seed=SEED)
    per_req = (cfg.clip.num_layers + cfg.clip.feature_layer + 1
               + cfg.video.num_blocks_used + L.num_layers)
    got = run_path(torch, kernels, "llama3 bf16 B=1 from the trained export",
                   generate(engine, [MODES[0]], gen_cfg),
                   expect_counts(zero, L.num_layers, per_req, 0, False, 0))
    tokens = engine.last_tokens[0]
    n_vocab = L.padded_vocab_size
    in_range = bool(((tokens >= 0) & (tokens < n_vocab)).all())
    log(f"[reload] served tokens {tuple(tokens.shape)} in [0, {n_vocab}): "
        f"{in_range} {'OK' if in_range else 'FAIL'}")
    if not in_range:
        raise AssertionError("reloaded export: tokens outside the vocabulary")
    del engine, loaded
    torch.cuda.empty_cache()
    return got


def train_path(torch, kernels, cfg, params, tok, temporal, spatial):
    """The training path: cfg (vlm_config(<llm>, stage="grounded")) at full
    width on the given bf16 weights with LoRA r=128 attached (B != 0), the
    grounded preset with a global batch
    of 2 in microbatches of 1 (grad_accum 2), LoRA dropout 0.05, remat on,
    four samples truncated by collate at max_txt_len 4096, two optimizer
    steps through TrainingStrategy.run_training. Counts to 0 just before,
    read just after. Raises unless loss and grad_norm are finite, the first
    step changed nothing (lr 0), the second moved every trainable leaf,
    every frozen leaf is bit-equal to its value before, and the launch
    counts are the config's. → (launches, per-step records, the
    strategy)."""
    import dataclasses
    import tempfile

    from grounded_video_llm_tpu_torch.core.config import STAGE_PRESETS
    from grounded_video_llm_tpu_torch.data.collate import collate
    from grounded_video_llm_tpu_torch.models import vlm
    from grounded_video_llm_tpu_torch.text.templates import get_template
    from grounded_video_llm_tpu_torch.train import lora as lora_mod
    from grounded_video_llm_tpu_torch.train.optimizer import tree_items
    from grounded_video_llm_tpu_torch.train.strategy import TrainingStrategy

    name = cfg.llm_name
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
    samples = train_samples(temporal, spatial, 4, 40, SEED, name)
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
            log(f"[path] train {name} step {step}: loss={m['loss']:.5f} grad_norm="
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
                log(f"[path] train {name} after step 2: {len(changed)} of "
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
        log(f"[path] train {name} grounded B=1 accum=2: launches {got} "
            f"expected "
            f"{want} (per microbatch flash_fwd = CLIP "
            f"{cfg.clip.num_layers + cfg.clip.feature_layer + 1} + IV2 "
            f"{cfg.video.num_blocks_used} + LLM {nl} + remat recompute {nl},"
            f" flash_bwd = {nl}; {microbatches} microbatches)")
        if len(steps) != 2 or got != want:
            raise AssertionError(f"train path: {len(steps)} steps, launches "
                                 f"{got}, expected 2 steps and {want}")

        # phase split of one more microbatch (outside the counted run)
        mb = collate(samples[:1], tok, get_template(name),
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
        log(f"[path] train {name} phases of one microbatch (S_text={S_text},"
            f" spliced"
            f" {S_text - 1 + cfg.num_video_tokens}): encode_s={enc_s:.3f} "
            f"forward_loss_s={fwd_s:.3f} (encode included) backward_s="
            f"{bwd_s:.3f}; step 2 {step_s:.3f} s = 2 microbatches "
            f"{2 * (fwd_s + bwd_s):.3f} s + optimizer and the rest "
            f"{step_s - 2 * (fwd_s + bwd_s):.3f} s; model TFLOP per sample "
            f"{flops / 1e12:.1f} (bench_train.py formula), step 2 "
            f"{per_sample:.3f} s per sample = {flops / per_sample / 1e12:.1f}"
            f" TFLOP/s = {flops / per_sample / BF16_OPS:.3f} of 989 TFLOP/s")
        return got, steps, strat
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
    from grounded_video_llm_tpu_torch.ops import fused_block as fb
    from grounded_video_llm_tpu_torch.ops import int8_gemm as ig
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
               "scatter_write": cw.SCATTER_WRITE,
               "verify_attention_int8": da.VERIFY_ATTENTION_INT8,
               "scatter_write_multi": cw.SCATTER_WRITE_MULTI,
               "fused_norm_quant_gemm": fb.FUSED_NORM_QUANT_GEMM,
               "fused_quant_gemm_ls_residual":
                   fb.FUSED_QUANT_GEMM_LS_RESIDUAL,
               "i8i8_gemv": ig.I8I8_GEMV, "flash_variant": fa.FLASH_VARIANT,
               "int8_gemm": ig.INT8_GEMM,
               "int8_gemm_dynamic": ig.INT8_GEMM_DYNAMIC}
    t0 = time.perf_counter()
    seconds = cuda_build.build_all(list(kernels.values()))
    for k in kernels.values():
        k.function()
    log(f"[build] {len(seconds)} sources built in parallel in "
        f"{time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{n} {s:.1f} s" for n, s in seconds.items()))
    logs = {k.source.name: k.build_log for k in kernels.values()}
    for src, text in logs.items():
        entry = "?"          # ptxas names each entry function before its lines
        for line in text.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                entry = short_entry(found.group(1))
            elif "registers" in line or "spill" in line:
                log(f"[ptxas] {src} {entry}: {line.strip()}")

    sass_phase(kernels)

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
    # path D keeps a draft margin of S_v slots (serve/speculative.py)
    S_v = SPEC_DRAFT_LEN + 1
    max_len_spec = -(-(S_pre + MAX_NEW_TOKENS + S_v) // 128) * 128

    # ---- 3. kernels vs plain versions at the path's shapes
    flash, per_req = flash_phase(torch, fa, cfg, S_pre)
    # the grounded train microbatch: max_txt_len text tokens, one of them
    # the video slot
    S_train = vlm_config("phi3.5", stage="grounded").max_txt_len - 1 \
        + cfg.num_video_tokens
    k7 = flash_bwd_phase(torch, fa, cfg, S_train)
    k3, k6 = gemv_phase(torch, mm, cfg)
    k4 = attention_phase(torch, da, cfg, max_len, cuda_build)
    k5 = write_phase(torch, cw, cfg, max_len)
    k8 = verify_phase(torch, da, cfg, max_len_spec, S_v)
    k9 = write_phase(torch, cw, cfg, max_len_spec, S_v)
    for S in (128, 1):    # K9's widest and narrowest slot runs, checked
        write_phase(torch, cw, cfg, max_len_spec, S)
    batch6 = [x for pair in zip(MODES, MODES_2) for x in pair]
    k10 = fused_phase(torch, fb, cfg, len(batch6))
    m3 = int8_gemm_phase(torch, ig)
    m1 = i8i8_phase(torch, ig, mm, cfg)
    m2 = flash_variant_phase(torch, fa, cfg)
    families = {f.name: f for f in (flash, k7, k3, k6, k4, k5, k8, k9, *k10,
                                    m1, m2, *m3)}

    frames = synthetic_video(SEED, cfg.num_frames)
    t0 = time.perf_counter()
    temporal, spatial = bf16.preprocess_frames(frames)
    resize_ms = (time.perf_counter() - t0) * 1e3
    log(f"[path] host resize of the 96 frames, once: {resize_ms:.1f} ms")

    # ---- 4. small references
    for quantize in (None, "int8", "int8_full"):
        small_reference(torch, cfg, SEED, quantize)
    small_reference_verify(torch, cfg, SEED, S_v)
    small_reference_fused_iv2(torch, cfg, SEED, temporal)
    small_reference_static_iv2(torch, cfg, SEED, temporal)
    small_reference_quant_ab(torch, cfg, SEED)
    small_reference_train(torch, cfg, SEED)

    # ---- 5. main path
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

    def expect(*args):
        return expect_counts(zero, nl, *args)

    got = run_path(torch, kernels, "bf16 B=1", generate(bf16, [MODES[0]],
                                                         gen_cfg),
                   expect(per_req, 0, False, 0))
    launches = {k: launches[k] + got[k] for k in launches}

    full = InferenceEngine(params, cfg, tok, gen_int8, seed=SEED,
                           quantize="int8_full")
    got = run_path(torch, kernels, "A int8_full int8-cache B=6", generate(
        full, batch6, gen_int8), expect(per_req, 4 * nl, True, 1))
    launches = {k: launches[k] + got[k] for k in launches}
    t_a, tokens_a = dict(full.last_timings), full.last_tokens[0]

    # path D: mode A's batch with both serving opt-ins of the JAX package,
    # the fused W8A8 IV2 blocks (switch set only around it) and greedy
    # speculative decoding
    gen_spec = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False,
                              quantize_cache=True,
                              spec_draft_len=SPEC_DRAFT_LEN)
    nb = cfg.video.num_blocks_used

    def expect_spec(t):
        P = t["verify_passes"]
        return dict(zero, flash_fwd=per_req, fused_norm_quant_gemm=2 * nb,
                    fused_quant_gemm_ls_residual=2 * nb,
                    int8_gemv=4 * nl * P, int8_matmul=1 + P,
                    verify_attention_int8=nl * P, scatter_write_multi=P)

    with fused_iv2():
        got = run_path(torch, kernels, "D int8_full int8-cache fused-IV2 "
                       f"spec{SPEC_DRAFT_LEN} B=6",
                       generate(full, batch6, gen_spec), expect_spec)
    launches = {k: launches[k] + got[k] for k in launches}
    spec_path(torch, cfg, full, batch6, prompts, t_a, tokens_a, temporal,
              spatial)
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

    # path E: path A with calibrated static W8A8 scales (one calibration
    # pass over the IV2 blocks at the first request: nb more K1 launches)
    got = static_path(torch, kernels, params, cfg, tok, gen_int8, batch6,
                      prompts, temporal, spatial, t_a,
                      expect(per_req + nb, 4 * nl, True, 1))
    launches = {k: launches[k] + got[k] for k in launches}

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
    got = train_path(torch, kernels, vlm_config("phi3.5", stage="grounded"),
                     params, tok, temporal, spatial)[0]
    launches = {k: launches[k] + got[k] for k in launches}

    # ---- 7. the microbenchmarks: the path of M1, M2, M3 and M3d
    del params
    torch.cuda.empty_cache()
    got = microbench_path(torch, kernels, cfg, zero)
    launches = {k: launches[k] + got[k] for k in launches}

    # ---- 8. llama3 and vicuna: depth-cut references, then full-width
    # llama3 on the same frames, every Phi-3.5 tree and engine freed
    torch.cuda.synchronize()
    log(f"[main] Phi-3.5 freed: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
        f"since the last path {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    for name in ("llama3", "vicuna"):
        for quantize in (None, "int8_full"):
            small_reference(torch, vlm_config(name, stage="inference"), SEED,
                            quantize)
    small_reference_train(torch, vlm_config("llama3", stage="inference"),
                          SEED)
    llama3_train_kernel_phase(torch, fa, vlm_config("llama3",
                                                    stage="grounded"))
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_checkpoints")
    roundtrip_phase(torch, os.path.join(scratch, "roundtrip"))
    got, params = llama3_path(torch, kernels, zero, generate, temporal,
                              spatial, resize_ms)
    launches = {k: launches[k] + got[k] for k in launches}

    # ---- 9. llama3 grounded training on the same weights, then its
    # reference-format export read back and served
    got, _, strat = train_path(torch, kernels,
                               vlm_config("llama3", stage="grounded"),
                               params, build_tokenizer(
                                   vlm_config("llama3", stage="grounded")),
                               temporal, spatial)
    launches = {k: launches[k] + got[k] for k in launches}
    del params
    got = trained_reload_path(torch, kernels, zero, generate, strat,
                              build_tokenizer(vlm_config("llama3",
                                                         stage="inference")),
                              os.path.join(scratch, "trained"))
    launches = {k: launches[k] + got[k] for k in launches}
    del strat
    torch.cuda.empty_cache()
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
