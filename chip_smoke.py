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
   committed caches printed); prefix-KV serving (LLM 2 layers, bf16
   and int8_full): build_prefix_kv, prefill_continue into the three
   caches, decode_step_shared and verify_step_shared, card vs host; a two-block
   fused W8A8 InternVideo2 trunk card vs host; a two-block W8A8 trunk with
   static activation scales calibrated on the card, card vs host;
   serve/quant_ab (bf16 vs int8_full with static scales) on the depth-cut
   model, its metrics as readings; then one grounded training
   microbatch with LoRA attached (B != 0): the loss and every trainable
   leaf's gradient;
5. the main path, full-width Phi-3.5 (vlm_config("phi3.5",
   stage="inference"), seeded random weights) on one seeded synthetic
   96-frame video resized once by the engine's host preprocessing on the
   native route, which is required ([resize]: cpp/pil_resize.cc built
   alone with g++ by ops/host_build.py, ms per video, and 4 frames native
   against numpy, bit-equal): a bf16 request, then the int8 modes through
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
        proj of every block, otherwise path A's launch counts, no K10;
     F  feature-cached and prefix-KV serving in path A's configuration:
        12 queries over two videos (the resized frames and the same pixels
        reversed in time, behind two placeholder files under
        build/chip_smoke_videos/, the host having no decoder) in batches
        of 6, through run_stream_cached twice (2 encodes, then 0, equal
        tokens), run_stream_prefix through the cascade (one prefix per
        video: K2; per step K3 w8a8, K5 on the tail, K6) and
        run_stream_prefix with spec_draft_len=4 (per pass K3 at 30 rows,
        K9 on the tail, K6); each call counted like a path; then the
        prefix route's first-step logits held to the full prefill's (at
        most ROUTE_FLOOR_RATIO times the full route's own re-batching
        drift, and on the bf16 tree at most 1e-1), and one cascade decode
        step timed beside its eager attention;
     G  continuous batching behind the HTTP server's default shape
        (ServingFrontend: pool 4, prompt bucket 256, 64 new tokens, chunks
        of 8; greedy) in path A's configuration on path F's two videos,
        10 requests in the three modes with budgets 8/16/32/64 submitted
        together through ContinuousScheduler: the feature-backed pool (per
        step K3 w8a8 at 4 rows, K4, K5 at each row's own slot, K6; four
        requests served alone again, token-equal; K5 bit-equal and K4
        within its bars on one pool step with distinct slots and an
        inactive row), the prefix-backed pool (its first-step logits
        within ROUTE_FLOOR_RATIO times the feature route's drift when its
        padding changes), the shared-prefix pool with spec_draft_len=4
        (per pass K3 at 20 rows, K9 on the tail, K6), pipelined and its
        loop unpipelined on the same shapes (bit-equal tokens), and the
        HTTP server on an ephemeral port (/healthz,
        /v1/models, a generate, a streamed generate assembling the same
        text, a bad request answered 400); per round the wall time,
        tokens/s, admission and chunk-step times, time to first token and
        peak memory, tagged with the card.
     H  the evaluation runner, cli/eval.py's in-process run_benchmark, in
        path A's configuration (16 new tokens, feature LRU of 8) over 12
        synthetic videos (96 frames of 240x320 each, durations 30-120 s,
        behind placeholder files under build/chip_smoke_eval/, resized
        natively by the engine's preprocessing): 36 Charades-STA items
        from a charades_sta annotation file with --prefix_cache (12
        prefixes; the encodes the LRU implies), the first 12 again (their
        videos re-encode), multiple choice and grounded QA (6 items each)
        through run_stream_cached, dense captioning of 2 videos through
        run_stream; each call counted like a path, its metric keys the
        JAX package's, items/s and the phase sums printed; then beam
        search (num_beams=4, 32 tokens): bf16 B=1 (K1/K2 only) and
        int8_full B=2 (per step 129 weight-only int8_matmul on the bf16
        cache), num_beams=1 equal to the bf16 request's greedy tokens, ms
        per step beside the cache reorder's share, and the joint log-prob
        of the best beam and of greedy (a reading, not a gate).
   Every serving loop runs through the step graphs
   (serve/graphs.StepGraphs): on the card each decode step, verify pass,
   pool chunk and beam step is a CUDA graph, captured at its key's second
   step and replayed after. After path D, [graph] legs run each captured
   loop at GRAPH_NEW_TOKENS (16) through the eager switch
   (StepGraphs.eager()) and twice through the graphs: mode A's decode (B =
   6), bf16 B=1, path D's verify passes, the cascade of paths F / H, path
   G's decode and speculative chunks (pool 4, chunks of 8) and beams (bf16
   B=1, K=4; beside it what the one-graph copy-back design would add), each
   printing ms per step for both routes, the capture ms, the replays and
   the graph pool's bytes, its greedy tokens bit-equal to the eager
   loop's; mode A's captured step holds the same kernel nodes as one eager
   step of its body (128 + 1 int8_mm_kernel, 32 K4, one K5); sampled draws
   inside a graph (sample_logits and spec_accept_tokens from a registered
   torch.Generator) stay in their top-p support, and whether they equal
   the eager draws is printed; llama3's mode A has a leg too (phase 8).
   Each path runs with every launch count set to 0 just before it; its
   counts are read just after and held against the counts the config
   implies (a replay adds what its capture counted). Phase times, peak device memory, and a shape/finiteness check of
   the features and logits. After path A, on its tree: the phase profile
   at the JAX script's configuration (cli/phase_profile.build_stages, B =
   6: internvideo2 on 72 clips, clip on 72 frames, encode, prefill at 63 +
   3,420 tokens into the int8 cache, 32 decode steps), each stage once
   unprofiled (obs/profiler.PhaseTimer) and once under torch.profiler, its
   launches held to the config's and its profile to the port's kernels by
   device name ([phase] lines); one B = 1 decode step inside
   obs/profiler.device_trace with an annotate region, the trace written to
   build/chip_smoke_trace/ holding the region and a port kernel; and the
   device preprocessing route (ops/preprocess.dual_stream_preprocess_device,
   the JAX package's preprocess_xla) on the card against its host run
   within 1e-5;
   Path J, after B and C: tensor-split compute (parallel/tensor.py) on a
   (1, 1, 2) mesh of two gloo ranks that share the card (NCCL takes no two
   ranks on one card; gloo stages each collective through the host), the
   script's full-width Phi-3.5 bf16 tree sharded head-aligned: each rank
   serves the bf16 B=1 request through InferenceEngine (eager: the step
   graphs refuse a sharded tree) and takes one grounded step (B=1, the
   train path's first sample, LoRA r=128, remat, count 0); every
   parameter, activation and cache of a rank on cuda:0, every cache of 16
   kv heads; the ranks' tokens equal, the first equal to the bf16 B=1
   request's (the count of equal greedy tokens printed), the prefill
   logits within ROUTE_FLOOR_RATIO times the single-process prefill's own
   re-batching drift of the single-process logits, the loss and global
   gradient norm within BOUND_TP_LOSS / BOUND_TP_GRAD_NORM of the
   single-process step on the same tree and batch; K1 (8 heads), K2 and K7
   (16 heads) in the launch shapes and the step's device kernels; times
   and peaks labelled as two gloo ranks on one card, not a measure of
   tensor parallelism over NVLink ([tp] lines);
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
   of one more microbatch and the model-FLOP share; then path I, the
   pretrain and sft stages through TrainingStrategy on a 1-rank NCCL mesh
   (parallel/mesh.build_mesh over a process group started on a FileStore;
   the backend must be NCCL and the mesh on the card): pretrain on the
   tree without LoRA, embed and lm_head cut to the base vocabulary (4
   captions, 2 steps: only the projectors may move), sft on the trained
   tree (6 samples, 3 steps with an asynchronous interval save after step
   2: the projectors, LoRA, embed and lm_head move), each at a global batch
   of 2 in microbatches of 1 with path 6's launch counts per microbatch;
   per step loss, grad_norm, seconds and peak memory; the seconds the loop
   blocked on the save, step 3's seconds and whether the file was still
   being written when step 3 ended; the file read back bit-equal to the
   state at step 2; one sft step on the mesh against the plain step from
   the same state and batch, loss, grad_norm and every updated leaf
   bit-equal (at world size 1 every leaf is a plain tensor and every
   all-reduce is over one rank: a check of the NCCL group and the mesh
   plumbing, not of the gathers);
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
   the [setup] line: the bf16 build and the engine's int8_full
   quantization of it (seconds, peak rise) beside build_params(quantize=
   "int8_full"), which builds the LLM directly in int8 (its peak rise must
   be below the bf16 route's; every LLM leaf bit-equal to the engine's,
   every other leaf to the bf16 tree's); one bf16 B=1 encode whole and
   with encoder_chunk_clips=4 (features
   within relative L2 1e-6, each run's peak memory); K2, K3's w8a8 branch,
   K4 (G = 4) and K6 (128,558 rows) at llama3's own shapes, timed beside
   their plain versions, library calls and bounds; a bf16 B=1 request
   (94 flash launches) and a mode A request on the direct tree
   (int8_full, int8 cache, B=6: per step 128 w8a8 int8_gemv, 32 K4, 1 K5,
   1 lm_head; 1 K6 a request),
   their launch counts held to the config's, their phase split, prefill
   length and peak memory printed, their tokens in the vocabulary. Before
   them: the depth-cut training reference of phase 4 for llama3; K2 and K7
   at llama3's grounded training shape [1, 6411, 32, 128] with 8 kv heads
   (the spliced length printed), held to their plain versions, K7 launched
   twice bit-equal, graph-timed beside SDPA's fastest causal forward and
   backward (enable_gqa or K/V expanded, named) and the bound; and the
   reference-format round trip: a full-width llama3 tree (LLM 1 of 32
   layers, CLIP 1 of 24, InternVideo2 1 of 40 blocks; width, vocabulary
   and the q/k/v split kept) written in the weights-day layout by
   models/export.write_weight_dumps and its weight dumps read back by
   build_params (weight_root, video_encoder_path; the stage checkpoint is
   phase 9's [reload]) onto the card, every leaf they hold bit-equal to
   the bf16 source, bytes and seconds printed; then read
   again with quantize="int8_full": the LLM bit-equal to
   quantize_llm_for_serving of the bf16 read-back, seconds and peak rise
   printed;
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

import contextlib
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
        # path J's rank-local heads: the encoders' and the LLM's heads over
        # a tensor axis of TP_RANKS
        "clip_rank": dict(B=2, Sq=cfg.clip.num_patches + 1,
                          H=cfg.clip.num_heads // TP_RANKS,
                          D=cfg.clip.head_dim, seed=5, timed=False),
        "internvideo2_bounded_rank": dict(
            B=2, Sq=cfg.video.seq_len, H=cfg.video.num_heads // TP_RANKS,
            D=cfg.video.head_dim, bounded=True, seed=6, timed=False),
        "prefill_causal_rank": dict(B=1, Sq=S_pre,
                                    H=cfg.llm.num_heads // TP_RANKS,
                                    D=cfg.llm.head_dim, causal=True,
                                    pads=(0,), seed=7, timed=False),
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
    # path J's rank-local heads at the training shape
    check_flash_bwd(torch, fa, "train_causal_rank", 1, S_train,
                    L.num_heads // TP_RANKS, L.head_dim, pads=(37,),
                    window=L.sliding_window, seed=53)
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
    captured from the call (graph_nodes). Exact however the kernels
    overlap."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    names = graph_nodes(graph)
    del graph
    torch.cuda.empty_cache()
    return names


def graph_nodes(graph) -> list:
    """The nodes of a captured torch.cuda.CUDAGraph(keep_graph=True):
    kernels by their mangled names (cuFuncGetName), other nodes as
    "<node type N>"."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

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
                  clip=replace(cfg_full.clip, num_layers=2),
                  video=replace(cfg_full.video, depth=1, num_blocks_used=1),
                  llm=replace(cfg_full.llm, num_layers=1))
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
    log(f"[small-ref] {cfg_full.llm_name} depth-cut full width (CLIP 1 of "
        f"2 layers, IV2 1 block, LLM 1 layer, 1 segment), {what}, rel L2: "
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
    (CLIP 1 of 2 layers, IV2 1 block, LLM 1 layer, 1 segment): bf16
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
                  clip=replace(cfg_full.clip, num_layers=2),
                  video=replace(cfg_full.video, depth=1, num_blocks_used=1),
                  llm=replace(cfg_full.llm, num_layers=1))
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
                  clip=replace(cfg_full.clip, num_layers=2),
                  video=replace(cfg_full.video, depth=1, num_blocks_used=1),
                  llm=replace(cfg_full.llm, num_layers=1))
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
    log(f"[small-ref] train {cfg.llm_name}: depth-cut full width (CLIP 1 of "
        f"2 layers, IV2 1 block, LLM 1 layer, LoRA r=128 with B != 0, 1 "
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


def resize_phase(engine, frames, card):
    """The engine's host resize of one video (96 frames to 224, the 12
    segment frames to 336) on the native route, which it requires (the
    standalone build of cpp/pil_resize.cc where the host has no decoder
    library); then 4 frames at the temporal size through the native and
    the numpy route, bit-equal, each timed → (temporal, spatial, ms)."""
    from grounded_video_llm_tpu_torch.ops import pil_resize

    pil_resize.reset_native_cache()
    t0 = time.perf_counter()
    pil_resize._native_lib()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    temporal, spatial = engine.preprocess_frames(frames)
    ms = (time.perf_counter() - t0) * 1e3
    calls = dict(pil_resize.ROUTE_CALLS)
    log(f"[resize] library {pil_resize.NATIVE_LIBRARY} (loaded or built in "
        f"{build_s:.2f} s; {pil_resize.NATIVE_ERROR or 'no build error'}); "
        f"route calls {calls}")
    if calls != {"native": 2, "numpy": 0}:
        raise AssertionError(f"the host resize did not run natively: {calls}"
                             f" ({pil_resize.NATIVE_ERROR})")
    four = np.ascontiguousarray(frames[:4])
    h, w = four.shape[1:3]
    rh, rw = pil_resize.resized_shape_torchvision(h, w, 224)
    t0 = time.perf_counter()
    native = pil_resize.resize_bicubic_batch_u8(four, rh, rw)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = np.stack([pil_resize._resize_np(f, rh, rw) for f in four])
    numpy_ms = (time.perf_counter() - t0) * 1e3
    equal = bool(np.array_equal(native, plain))
    log(f"[resize] one video ({frames.shape[0]} frames of {h}x{w} to 224, "
        f"{engine.cfg.num_segs} segment frames to 336), native: {ms:.1f} "
        f"ms/video; 4 frames to {rh}x{rw}: native {native_ms:.2f} ms, numpy "
        f"{numpy_ms:.1f} ms ({numpy_ms / native_ms:.0f}x), bit-equal "
        f"{equal}; {card}")
    if not equal:
        raise AssertionError("native resize differs from the numpy route")
    return temporal, spatial, ms


def tree_differences(torch, a, b) -> list:
    """The paths of two trees (nested dicts of tensors, Int8Weight and
    Int8Embedding leaves) that are not bit-equal: another structure, type,
    dtype, shape, value or w8a8 flag."""
    from grounded_video_llm_tpu_torch.train.optimizer import tree_items

    ta, tb = dict(tree_items(a)), dict(tree_items(b))
    bad = sorted(set(ta) ^ set(tb))

    def equal(x, y):
        if isinstance(x, torch.Tensor):
            return (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and torch.equal(x, y))
        if isinstance(x, tuple):    # Int8Weight, Int8Embedding
            return (type(x) is type(y)
                    and all(equal(u, v) for u, v in zip(x, y)))
        return x == y

    return bad + sorted(p for p in set(ta) & set(tb)
                        if not equal(ta[p], tb[p]))


# the port's device kernels (name fragments) each phase-profile stage's
# profile must show
PHASE_KERNELS = {"internvideo2": ("flash_fwd_kernel",),
                 "clip": ("flash_fwd_kernel",),
                 "encode": ("flash_fwd_kernel",),
                 "prefill": ("flash_fwd_kernel", "int8_mm_kernel"),
                 "decode": ("int8_mm_kernel", "attention_kernel",
                            "scatter_kernel")}


def phase_profile_phase(torch, kernels, params, cfg, card):
    """cli/phase_profile's stages on path A's tree (int8_full, int8 cache)
    at the JAX script's shapes, B = 6: each stage once unprofiled
    (PhaseTimer) and once under torch.profiler, its launches counted and
    held to the config's (decode: 128 w8a8 int8_gemv, 32 K4, 1 K5 and one
    lm_head int8_matmul a step), its profile holding the port's kernels
    by device name (prefill: flash_fwd and the int8 product kernel;
    decode: the int8 product, int8-cache attention and scatter kernels)."""
    from grounded_video_llm_tpu_torch.cli import phase_profile as pp

    nl = cfg.llm.num_layers
    n_clip = cfg.clip.num_layers + cfg.clip.feature_layer + 1
    nb = cfg.video.num_blocks_used
    steps = pp.DECODE_STEPS
    zero = {n: 0 for n in kernels}
    want = {"internvideo2": dict(zero, flash_fwd=nb),
            "clip": dict(zero, flash_fwd=n_clip),
            "encode": dict(zero, flash_fwd=nb + n_clip),
            "prefill": dict(zero, flash_fwd=nl, int8_matmul=1),
            "decode": dict(zero, int8_gemv=4 * nl * steps,
                           decode_attention_int8=nl * steps,
                           scatter_write=steps, int8_matmul=steps)}
    t0 = time.perf_counter()
    lines: list = []
    with torch.inference_mode():
        stages = pp.build_stages(params, cfg, 6)
        walls = pp.time_stages(stages, warm=0, repeats=1)
        for st, wall in zip(stages, walls):
            r = pp.profile_stage(st, wall, lines, counters=kernels)
            seen = [frag for frag in PHASE_KERNELS[st.name]
                    if any(frag in row[0] for row in r["rows"])]
            ok = (r["launches"] == want[st.name]
                  and len(seen) == len(PHASE_KERNELS[st.name]))
            log(f"[phase] {st.label}: launches as expected "
                f"{r['launches'] == want[st.name]}, port kernels in the "
                f"profile {seen} of {list(PHASE_KERNELS[st.name])} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"phase profile {st.label}: launches "
                                     f"{r['launches']} (expected "
                                     f"{want[st.name]}), kernels {seen}")
    log(f"[phase] {len(stages)} stages profiled in "
        f"{time.perf_counter() - t0:.1f} s; {card}")


def trace_phase(torch, params, cfg):
    """One B = 1 decode step on the tree inside obs/profiler.device_trace,
    in an annotate region: the trace written to build/chip_smoke_trace/
    must hold the region and a port kernel."""
    import glob

    from grounded_video_llm_tpu_torch.cli import phase_profile as pp
    from grounded_video_llm_tpu_torch.obs import profiler

    root = os.path.dirname(os.path.abspath(__file__))
    trace_dir = os.path.join(root, "build", "chip_smoke_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    region = "chip_smoke_decode_step"
    with torch.inference_mode():
        dec = pp.build_stages(params, cfg, 1, ["decode"], decode_steps=1)[0]
        dec.fn()
        with profiler.device_trace(trace_dir):
            with profiler.annotate(region):
                dec.fn()
            profiler.sync(dec.probe)
    files = glob.glob(os.path.join(trace_dir, "*.json"))
    events = []
    if files:
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    annotated = any(e.get("name") == region for e in events)
    port = sorted({frag for e in events if e.get("cat") == "kernel"
                   for frag in PHASE_KERNELS["decode"]
                   if frag in e.get("name", "")})
    ok = len(files) == 1 and annotated and bool(port)
    log(f"[phase] device_trace of one B=1 decode step: {len(files)} trace "
        f"file(s), {len(events)} events, region {region!r} present "
        f"{annotated}, port kernels {port} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("obs/profiler.device_trace: the trace lacks the"
                             " annotation or the port's kernels")
    shutil.rmtree(trace_dir, ignore_errors=True)


def device_preprocess_phase(torch, frames, cfg, card):
    """The device preprocessing route (ops/preprocess,
    dual_stream_preprocess_device: the JAX package's preprocess_xla) of one
    video on the card against the same function on the host, fp32, within
    1e-5; both timed."""
    from grounded_video_llm_tpu_torch.ops import preprocess

    host_frames = torch.from_numpy(frames)
    t0 = time.perf_counter()
    host = preprocess.dual_stream_preprocess_device(
        host_frames, cfg.num_segs, out_dtype=torch.float32)
    host_ms = (time.perf_counter() - t0) * 1e3
    dev_frames = host_frames.cuda()
    preprocess.dual_stream_preprocess_device(dev_frames, cfg.num_segs,
                                             out_dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = preprocess.dual_stream_preprocess_device(
        dev_frames, cfg.num_segs, out_dtype=torch.float32)
    torch.cuda.synchronize()
    dev_ms = (time.perf_counter() - t0) * 1e3
    err = max(float((d.cpu() - h).abs().max()) for d, h in zip(dev, host))
    ok = err <= 1e-5 and all(d.shape == h.shape for d, h in zip(dev, host))
    log(f"[phase] device preprocessing (jax.image.resize's bicubic) of one "
        f"video, {frames.shape[0]} frames of {frames.shape[1]}x"
        f"{frames.shape[2]}: temporal {tuple(dev[0].shape)}, spatial "
        f"{tuple(dev[1].shape)}; card {dev_ms:.2f} ms, host {host_ms:.1f} "
        f"ms; max |card - host| {err:.3e} (<= 1e-05) "
        f"{'OK' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("the device preprocessing route differs from "
                             "its host run")


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
        f"encode_ms={t.get('encode', 0.0) * 1e3:.1f} "
        f"prefill_ms={t['prefill'] * 1e3:.1f}"
        f" decode_ms={t['decode'] * 1e3:.1f} decode_ms_per_"
        f"{'step' if key == 'decode_steps' else 'pass'}="
        f"{t['decode'] * 1e3 / steps:.2f} peak_device_memory={peak:.2f} GiB")
    log(f"[path] {name}: launches {got} expected {want}")
    if got != want:
        raise AssertionError(f"{name}: launch counts {got}, expected {want}")
    return got


GRAPH_NEW_TOKENS = 16   # [graph] legs: new tokens a request (<= 16 steps)


def graph_leg(torch, name, graphs, run, card, unit="step"):
    """The [graph] leg of a captured loop: run() drives one request through
    the loop's entry point → (tokens on the host, steps, decode seconds);
    once under graphs.eager(), then twice through the step graphs (the
    first warms and captures the key, the second only replays). Greedy
    tokens and steps must be bit-equal; ms per step of both routes (the
    graph's from the second call), the capture ms, replays and the graph
    pool's bytes are printed with the card."""
    with graphs.eager():
        tok_e, n_e, sec_e = run()
    before = dict(graphs.stats)
    tok_1, n_1, sec_1 = run()
    tok_g, n_g, sec_g = run()
    st = {k: graphs.stats[k] - before[k] for k in before}
    st["pool_bytes"] = graphs.pool_bytes()
    ok = (n_e == n_1 == n_g and torch.equal(tok_e, tok_1)
          and torch.equal(tok_e, tok_g))
    ms_e, ms_g = 1e3 * sec_e / max(n_e, 1), 1e3 * sec_g / max(n_g, 1)
    log(f"[graph] {name}: eager {ms_e:.2f} ms/{unit}, graph {ms_g:.2f} "
        f"ms/{unit} ({ms_e / ms_g:.2f}x), the capturing call "
        f"{1e3 * sec_1 / max(n_1, 1):.2f} ms/{unit}; {n_g} {unit}s a "
        f"request, {st['captures']} capture(s) {st['capture_ms']:.1f} ms, "
        f"{st['replays']} replays, graph pool "
        f"{st['pool_bytes'] / 2 ** 20:.1f} MiB; greedy tokens bit-equal "
        f"{ok}; {card}")
    if not ok:
        raise AssertionError(f"[graph] {name}: the step graphs' tokens or "
                             "steps differ from the eager loop's")
    return ms_e, ms_g


def engine_run(engine, call, key="decode_steps"):
    """A graph_leg run over an engine route: call() serves one request;
    the tokens, steps and decode seconds from the engine's last_timings."""
    def run():
        call()
        t = engine.last_timings
        return engine.last_tokens[0].clone(), t[key], t["decode"]
    return run


def clone_state(state):
    """A copy of a step graph's state: its tensors cloned, NamedTuples and
    tuples rebuilt."""
    if hasattr(state, "clone"):
        return state.clone()
    if hasattr(state, "_fields"):
        return type(state)(*[clone_state(x) for x in state])
    if isinstance(state, tuple):
        return tuple(clone_state(x) for x in state)
    return state


def captured_step_check(torch, graphs, nl, card):
    """The kernel nodes of the decode step graph an engine captured (mode
    A's: int8_full, int8 cache) against one eager step of the same body
    (device_kernels): the same names and counts, and the per-step counts
    gemv_phase times: 4 nl + 1 int8_mm_kernel (w8a8 projections, the
    lm_head), nl K4, one K5."""
    from collections import Counter

    loop = next(lp for lp in graphs.loops()
                if lp.key[0][0] == "decode" and 0 in lp.graphs)
    got = graph_nodes(loop.graphs[0])
    with torch.inference_mode():
        # a copy of the finished loop's state, back at its second token
        st = clone_state(loop.state)
        st.step.fill_(1)
        want, _ = device_kernels(torch, lambda: loop.bodies[0](st))

    def count(names, frag):
        return sum(frag in n for n in names)

    per_step = {"int8_mm_kernel": 4 * nl + 1, "attention_kernel": nl,
                "scatter_kernel": 1}
    ok = (Counter(got) == Counter(want)
          and all(count(got, f) == n for f, n in per_step.items()))
    log(f"[graph] mode A's captured decode step: {len(got)} nodes, "
        f"{sum(not n.startswith('<') for n in got)} kernels, "
        + ", ".join(f"{f} {count(got, f)} (want {n})"
                    for f, n in per_step.items())
        + f"; one eager step of the body: {len(want)} nodes; same names "
        f"and counts {Counter(got) == Counter(want)} "
        f"{'OK' if ok else 'FAIL'}; {card}")
    if not ok:
        extra = Counter(got) - Counter(want)
        missing = Counter(want) - Counter(got)
        raise AssertionError(f"captured step: extra {dict(extra)}, missing "
                             f"{dict(missing)}")


def cascade_run(torch, engine, cfg, feats, prompts, n):
    """A graph_leg run of the cascade (paths F and H's shared-prefix
    decode): the prompts' shared [pre-image text | video] head built once
    (build_prefix_kv), then generate_tokens_from_prefix(shared_prefix=True)
    on the engine's graphs, greedy, n new tokens."""
    from grounded_video_llm_tpu_torch.serve.generate import (
        _ceil128, build_prefix_kv, generate_tokens_from_prefix)
    from grounded_video_llm_tpu_torch.text.templates import IMAGE_TOKEN_INDEX

    seqs = [engine.tokenize_prompt(p) for p in prompts]
    img = [s.index(IMAGE_TOKEN_INDEX) for s in seqs]
    pre = seqs[0][:img[0]]
    if any(s[:a] != pre for s, a in zip(seqs, img)):
        raise AssertionError("cascade leg: the prompts share no head")
    posts = [s[a + 1:] for s, a in zip(seqs, img)]
    Sq = _ceil128(max(len(p) for p in posts))
    ids, mask = engine._pad_bucket_batch(posts, Sq)
    Sp = len(pre) + cfg.num_video_tokens
    hint = _ceil128(Sp + Sq + n)
    pre_ids = torch.tensor([pre], device="cuda")
    prefix = build_prefix_kv(engine.params, cfg, pre_ids,
                             torch.ones_like(pre_ids),
                             feats[None].to("cuda"), hint)
    tok = engine.tokenizer
    ids = torch.from_numpy(ids).long().cuda()
    mask = torch.from_numpy(mask).long().cuda()

    def run():
        t = {}
        out, _ = generate_tokens_from_prefix(
            engine.params, cfg, ids, mask, *prefix, engine.generator,
            max_new_tokens=n, do_sample=False, eos_token_id=tok.eos_token_id,
            pad_token_id=tok.pad_token_id, quantize_cache=True,
            shared_prefix=True, rope_hint=hint, timings=t,
            graphs=engine.graphs)
        return out.cpu(), t["decode_steps"], t["decode"]
    return run


def pool_run(torch, server, requests):
    """A graph_leg run of a continuous pool: serve(requests) from an idle
    pool → (the requests' tokens, pad -1, chunk steps, the chunks' host
    seconds from launch to tokens landing)."""
    def run():
        before = dict(server.timings)
        outs = server.serve(requests)
        t = server.timings
        toks = torch.full((len(outs), max(len(o) for o in outs)), -1,
                          dtype=torch.int64)
        for i, o in enumerate(outs):
            toks[i, :len(o)] = torch.from_numpy(o.astype(np.int64))
        return (toks, t["timed_steps"] - before.get("timed_steps", 0),
                t["chunk"] - before.get("chunk", 0.0))
    return run


def sampled_graph_check(torch, card, V=32064, rows=6, draws=64):
    """Sampling inside a step graph: `draws` draws of sample_logits
    (temperature 0.7, top-p 0.9) and of spec_accept_tokens' sampled rule
    on fixed logits, from a torch.Generator registered with the graph,
    against the eager loop from the same seed. Every token must lie in the
    top-p support computed on the host; graph draws equal to eager ones is
    printed (a reading: the ROADMAP states it)."""
    from typing import NamedTuple

    from grounded_video_llm_tpu_torch.serve.generate import sample_logits
    from grounded_video_llm_tpu_torch.serve.graphs import StepGraphs
    from grounded_video_llm_tpu_torch.serve.speculative import (
        spec_accept_tokens)

    class Draws(NamedTuple):
        logits: object
        vlogits: object
        drafts: object
        out: object
        acc: object
        step: object

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    logits = torch.randn(rows, V, generator=g, device="cuda") * 4.0
    vlogits = torch.randn(rows, 5, V, generator=g, device="cuda") * 4.0
    drafts = vlogits[:, :4].argmax(-1)

    def body(st):
        tok = sample_logits(st.logits, g, 0.7, 0.9, True)
        a, em = spec_accept_tokens(st.vlogits, st.drafts, g, 0.7, 0.9, True)
        st.out.index_copy_(0, st.step, tok[None])
        st.acc.index_copy_(0, st.step, torch.cat([a[:, None], em], 1)[None])
        st.step.add_(1)
        return st

    got = []
    for eager in (True, False):
        graphs = StepGraphs()
        g.manual_seed(SEED + 1)
        st = Draws(logits, vlogits, drafts,
                   torch.zeros(draws, rows, dtype=torch.int64, device="cuda"),
                   torch.zeros(draws, rows, 6, dtype=torch.int64,
                               device="cuda"),
                   torch.zeros(1, dtype=torch.int64, device="cuda"))
        loop = graphs.loop(("sample",), st, body, generator=g)
        with graphs.eager() if eager else contextlib.nullcontext():
            for _ in range(draws):
                loop.step()
        torch.cuda.synchronize()
        got.append((loop.state.out.cpu(), loop.state.acc.cpu()))
    # the top-p support of each row, on the host
    lg = logits.double().cpu() / 0.7
    srt, idx = torch.sort(lg, dim=-1, descending=True)
    p = torch.softmax(srt, -1)
    keep = (torch.cumsum(p, -1) - p) < 0.9
    support = [set(idx[r][keep[r]].tolist()) for r in range(rows)]
    inside = all(int(t) in support[r] for out, _ in got
                 for row in out for r, t in enumerate(row))
    valid = all(bool(((acc[..., 1:] >= 0) & (acc[..., 1:] < V)).all())
                and bool(((acc[..., 0] >= 1) & (acc[..., 0] <= 5)).all())
                for _, acc in got)
    same = (torch.equal(got[0][0], got[1][0])
            and torch.equal(got[0][1], got[1][1]))
    ok = inside and valid
    log(f"[graph] sampled draws in a step graph ({draws} steps of "
        f"sample_logits at [{rows}, {V}] and of spec_accept_tokens at "
        f"[{rows}, 5, {V}], temperature 0.7, top-p 0.9, a registered "
        f"torch.Generator): every token in its top-p support {inside}, "
        f"accept counts and tokens valid {valid}; graph draws equal to the "
        f"eager loop's from the same seed: {same} {'OK' if ok else 'FAIL'}; "
        f"{card}")
    if not ok:
        raise AssertionError("sampling inside a step graph left the top-p "
                             "support or the vocabulary")
    return same


def serving_graph_legs(torch, cfg, bf16, full, batch6, prompts, temporal,
                       spatial, card):
    """The [graph] legs of Phi-3.5's serving loops (GRAPH_NEW_TOKENS each):
    mode A's decode (B = 6, then its captured step's kernel nodes), the
    bf16 B = 1 decode, path D's verify passes, the cascade of paths F / H,
    path G's decode and speculative chunks (pool 4, chunks of 8), beams
    (bf16 B = 1, K = 4); then sampling inside a graph."""
    from grounded_video_llm_tpu_torch.core.config import GenerateConfig
    from grounded_video_llm_tpu_torch.serve.continuous import (
        ContinuousServer, Request)
    from grounded_video_llm_tpu_torch.serve.graphs import StepGraphs

    n = GRAPH_NEW_TOKENS
    g_bf16 = GenerateConfig(max_new_tokens=n, do_sample=False)
    g_int8 = GenerateConfig(max_new_tokens=n, do_sample=False,
                            quantize_cache=True)
    g_spec = GenerateConfig(max_new_tokens=n, do_sample=False,
                            quantize_cache=True,
                            spec_draft_len=SPEC_DRAFT_LEN)
    g_beam = GenerateConfig(max_new_tokens=n, do_sample=False, num_beams=4)
    feats = full.encode_features(temporal, spatial)
    feats_b = bf16.encode_features(temporal, spatial)
    p6, p1 = prompts(batch6, full), prompts([MODES[0]], bf16)
    out = {}
    out["A"] = graph_leg(torch, "A int8_full int8-cache B=6 decode",
                         full.graphs, engine_run(
                             full, lambda: full.generate_from_features(
                                 p6, feats, g_int8)), card)
    captured_step_check(torch, full.graphs, cfg.llm.num_layers, card)
    out["bf16"] = graph_leg(torch, "bf16 B=1 decode", bf16.graphs,
                            engine_run(bf16, lambda: bf16.generate_from_features(
                                p1, feats_b, g_bf16)), card)
    out["D"] = graph_leg(torch, f"D spec{SPEC_DRAFT_LEN} B=6 verify",
                         full.graphs, engine_run(
                             full, lambda: full.generate_from_features(
                                 p6, feats, g_spec), "verify_passes"),
                         card, "pass")
    out["F/H"] = graph_leg(torch, "F/H cascade B=6 decode", full.graphs,
                           cascade_run(torch, full, cfg, feats, p6, n), card)
    seqs = [full.tokenize_prompt(text) for text in p6[:4]]
    bucket = -(-max(len(q) for q in seqs) // 64) * 64
    for spec in (0, SPEC_DRAFT_LEN):
        server = ContinuousServer(full.params, cfg, pool_size=4,
                                  prompt_len=bucket,
                                  max_new_tokens=n, chunk=POOL["chunk"],
                                  eos_token_id=full.tokenizer.eos_token_id,
                                  pad_token_id=full.tokenizer.pad_token_id,
                                  spec_draft_len=spec)
        reqs = [Request(*full._pad_bucket(q, bucket), None, None,
                        max_new_tokens=n, features=feats) for q in seqs]
        name = (f"G pool 4 spec{spec} chunk" if spec
                else "G pool 4 decode chunk")
        out[name] = graph_leg(torch, name, server.graphs,
                              pool_run(torch, server, reqs), card,
                              "chunk step")
        del server
    # a full-width beam cache with its spare (11.5 GB) is above an engine's
    # kept state, so each beam call captures anew; the leg lends the engine
    # a runner without that bound, so that its second call only replays
    kept, bf16.graphs = bf16.graphs, StepGraphs(max_state_bytes=None)
    try:
        out["beam"] = graph_leg(torch, "beam4 bf16 B=1", bf16.graphs,
                                engine_run(bf16, lambda: bf16.generate(
                                    p1, temporal, spatial, g_beam)), card)
        # the design not taken: one graph whose reorder writes the spare
        # and copies it back (the cache's k and v once more a step)
        st = next(lp for lp in bf16.graphs.loops()
                  if lp.key[0][0] == "beam").state

        def copy_back():
            st.k[0].copy_(st.k[1])
            st.v[0].copy_(st.v[1])

        nbytes = 2 * (st.k[0].numel() * st.k[0].element_size())
        with torch.inference_mode():   # the state tensors are inference's
            copy_ms = graph_ms(torch, copy_back)
        log(f"[graph] beam4 bf16 B=1: two graphs (one per direction of the "
            f"buffer swap); the one-graph design's copy back of k and v "
            f"({nbytes / 2 ** 20:.1f} MiB) would add {copy_ms:.4f} ms a "
            f"step; {card}")
        del st
    finally:
        bf16.graphs = kept
    sampled_graph_check(torch, card)
    torch.cuda.empty_cache()
    return out


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


PREFIX_QUERIES = 12    # path F: queries over two videos
# path F: the prefix route's first-step logits may move from the full
# prefill's by at most this multiple of the full route's own drift when its
# queries run alone (the rounding floor of a 32-layer comparison, measured
# in the same run)
ROUTE_FLOOR_RATIO = 2.0


def prefix_steps(torch, lp, cfg, data, dev, next_tok=None, prefix=None,
                 plain=False):
    """The prefix-KV steps of small_reference_prefix on one tree: the prefix
    K/V (build_prefix_kv, or the given (k, v, mask)), prefill_continue into
    each of the three caches, then on the shared cache one
    decode_step_shared (of next_tok, else the prefill's argmax), one
    verify_step_shared of the candidates and a commit on the tail → (five
    logits and the committed tail lengths, the prefix, next_tok). plain
    adds the logits of decode_step on the bf16 and the int8 single cache
    (PLAIN_STAGES), after the tail lengths."""
    from grounded_video_llm_tpu_torch.models import llm
    from grounded_video_llm_tpu_torch.serve.generate import build_prefix_kv

    L, hint, S_v = cfg.llm, data["hint"], data["cands"].shape[1]
    dt = llm.embed_dtype(lp["embed"])
    with torch.inference_mode():
        if prefix is None:
            pre = data["pre"].to(dev)
            prefix = build_prefix_kv({"llm": lp}, cfg, pre,
                                     torch.ones_like(pre),
                                     data["feats"].to(dev, dt), hint)
        k, v, pm = (x.to(dev) for x in prefix)
        emb = llm.embed_lookup(lp["embed"], data["post"].to(dev), dt)
        m = data["post_mask"].to(dev)
        res, single = [], []
        for kind in ("bf16", "int8", "shared"):
            logits, cache, valid, pos = llm.prefill_continue(
                lp, L, emb, m, k, v, pm, hint,
                quantize_cache=kind != "bf16",
                tail_len=128 if kind == "shared" else None)
            res.append(logits)
            single.append((cache, valid))
        if next_tok is None:
            next_tok = logits.argmax(-1).cpu()
        cur = llm.embed_lookup(lp["embed"], next_tok.to(dev), dt)[:, None]
        lg, cache, valid = llm.decode_step_shared(
            lp, L, cur, cache, valid, pos, rope_hint=hint)
        res.append(lg)
        positions = (pos + 1)[:, None] + torch.arange(S_v, device=dev)
        lg, cache = llm.verify_step_shared(
            lp, L, llm.embed_lookup(lp["embed"], data["cands"].to(dev), dt),
            cache, valid, positions, rope_hint=hint)
        res.append(lg)
        tail, valid = llm.commit_verify(
            cache.tail, valid, torch.tensor([S_v, 2], device=dev), S_v)
        res.append(tail.length)
        if plain:
            res += [llm.decode_step(lp, L, cur, c, vd, pos)[0]
                    for c, vd in single[:2]]
    return res, prefix, next_tok


PREFIX_STAGES = ("prefill bf16 cache", "prefill int8 cache",
                 "prefill shared cache", "decode_step_shared",
                 "verify_step_shared")
PLAIN_STAGES = ("decode_step bf16 cache", "decode_step int8 cache")


def small_reference_prefix(torch, cfg_full, seed, quantize):
    """Prefix-KV serving on a depth-cut full-width LLM (2 layers; a prefix
    of 40 text and 600 video tokens, B = 2 left-padded questions of up to
    32 tokens): prefix_steps, card (kernels: K2 for the prefix, K5 and K9
    on the tail, K3/K6 under int8) against host (plain versions): quantize
    None, bf16 card vs fp32 host within BOUND_SMALL; "int8_full", the same
    int8 weights on both within BOUND_SMALL_W8A8. On the bf16 tree the card
    is also held within BOUND_SMALL to the same bf16 tree on the host, and
    two readings say where its gap to the fp32 host comes from: that bf16
    host against the fp32 host (no kernel: bf16 activations move the int8
    cache's codes), and the fp32 host fed the card's bf16 prefix K/V
    against the card."""
    from grounded_video_llm_tpu_torch.core.config import replace
    from grounded_video_llm_tpu_torch.models import llm
    from grounded_video_llm_tpu_torch.ops import cache_write as cw
    from grounded_video_llm_tpu_torch.ops import flash_attention as fa
    from grounded_video_llm_tpu_torch.serve.quantize import \
        quantize_llm_for_serving

    cfg = replace(cfg_full, llm=replace(cfg_full.llm, num_layers=2))
    L = cfg.llm
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    lp = llm.init_params(L, generator=g, device="cuda", dtype=torch.bfloat16)
    if quantize:
        lp = quantize_llm_for_serving(lp, w8a8=True)
    B, St, NV, Sq, S_v, new = 2, 40, 600, 32, SPEC_DRAFT_LEN + 1, 8
    Sp = St + NV
    rng = np.random.default_rng(seed)
    data = dict(hint=-(-(Sp + Sq + new + S_v) // 128) * 128,
                pre=torch.from_numpy(rng.integers(3, L.vocab_size, (1, St))),
                post=torch.from_numpy(rng.integers(3, L.vocab_size, (B, Sq))),
                post_mask=torch.ones(B, Sq, dtype=torch.long))
    data["post_mask"][1, :11] = 0                      # left padding
    data["feats"] = torch.from_numpy(rng.normal(size=(1, NV, L.hidden_size))
                                     .astype(np.float32) * 0.05)
    data["cands"] = torch.from_numpy(rng.integers(3, L.vocab_size, (B, S_v)))
    host = to_host(lp, None if quantize else torch.float32)
    ref, _, next_tok = prefix_steps(torch, host, cfg, data, "cpu",
                                    plain=not quantize)
    counts = (fa.FLASH_FWD.launches, cw.SCATTER_WRITE.launches,
              cw.SCATTER_WRITE_MULTI.launches)
    card, card_prefix, _ = prefix_steps(torch, lp, cfg, data, "cuda",
                                        next_tok)
    torch.cuda.synchronize()
    launched = [fa.FLASH_FWD.launches - counts[0],
                cw.SCATTER_WRITE.launches - counts[1],
                cw.SCATTER_WRITE_MULTI.launches - counts[2]]
    n_stages = len(PREFIX_STAGES)
    errs = [rel_err(torch, card[i], ref[i]) for i in range(n_stages)]
    same_len = bool(torch.equal(card[n_stages].cpu(), ref[n_stages]))
    bound = BOUND_SMALL_W8A8 if quantize else BOUND_SMALL
    ok = (max(errs) <= bound and same_len
          and launched == [L.num_layers, 1, 1])
    what = ("int8_full, the same int8 weights on both" if quantize
            else "card bf16 vs host fp32")
    log(f"[small-ref] prefix {cfg_full.llm_name} depth-cut full width (LLM 2"
        f" layers, prefix {St} text + {NV} video tokens, B={B} questions of "
        f"{Sq} with a left-padded row, S={S_v} candidates), {what}; card "
        f"launches K2 / K5 / K9 {launched} (want [{L.num_layers}, 1, 1]); "
        f"rel L2 " + ", ".join(f"{n} {e:.3e}"
                               for n, e in zip(PREFIX_STAGES, errs))
        + f" (<= {bound}); committed tail lengths equal {same_len} "
        f"{'OK' if ok else 'FAIL'}")
    if not quantize:
        # where the gap to the fp32 host comes from: the same steps with no
        # kernel (host bf16 against host fp32, with decode_step on the bf16
        # and the int8 single cache beside the cascade's) and the fp32 host
        # fed the card's prefix K/V, readings; the card against the bf16
        # host, the same precision, also within BOUND_SMALL
        host_bf16, _, _ = prefix_steps(torch, to_host(lp), cfg, data, "cpu",
                                       next_tok, plain=True)
        fed, _, _ = prefix_steps(torch, host, cfg, data, "cpu", next_tok,
                                 card_prefix)
        stages = PREFIX_STAGES + ("tail lengths",) + PLAIN_STAGES
        for what, a, b, held in (
                ("host bf16 vs host fp32 (no kernel)", host_bf16, ref, False),
                ("card bf16 vs host bf16", card, host_bf16, True),
                ("host fp32 fed the card's prefix K/V vs card", fed, card,
                 False)):
            errs = {n: rel_err(torch, a[i], b[i])
                    for i, n in enumerate(stages[:len(a)])
                    if n != "tail lengths"}
            ok_here = max(errs.values()) <= BOUND_SMALL
            ok = ok and (ok_here or not held)
            log(f"[small-ref] prefix {cfg_full.llm_name} "
                f"{'held' if held else 'reading'}, {what}: rel L2 "
                + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                + (f" (<= {BOUND_SMALL}) {'OK' if ok_here else 'FAIL'}"
                   if held else ""))
    if not ok:
        raise AssertionError("prefix-KV serving: card disagrees with the "
                             "host reference")
    del lp, card, card_prefix
    torch.cuda.empty_cache()


def route_logits(torch, eng, cfg, feats, prompts, question_len):
    """First-step logits of one batch of prompts on one video's features
    [NV, H], through the engine's tree: the full prefill at B = len(prompts)
    ("full"), each prompt alone ("alone"), and the prefix route
    (build_prefix_kv, then prefill_continue of the questions left-padded to
    question_len into the cascade cache; "prefix", with that cache, its
    tail mask, next positions and LongRoPE hint)."""
    from grounded_video_llm_tpu_torch.models import llm, vlm
    from grounded_video_llm_tpu_torch.serve.generate import build_prefix_kv
    from grounded_video_llm_tpu_torch.text.templates import IMAGE_TOKEN_INDEX

    lp, L = eng.params["llm"], cfg.llm
    feats = feats.cuda()

    def full(ps):
        ids, am = (torch.from_numpy(a).long().cuda()
                   for a in eng._batch_ids(ps))
        embeds, _, m = vlm.splice_multimodal(
            ids, None, am, feats[None].expand(len(ps), *feats.shape),
            lp["embed"])
        max_len = -(-(embeds.shape[1] + MAX_NEW_TOKENS) // 128) * 128
        logits, _ = llm.prefill(lp, L, embeds, m, llm.QuantKVCache.create(
            L, len(ps), max_len, device="cuda"))
        return logits, embeds.shape[1]

    with torch.inference_mode():
        out = dict(zip(("full", "S_full"), full(prompts)))
        out["alone"] = torch.cat([full([p])[0] for p in prompts])
        seqs = [eng.tokenize_prompt(p) for p in prompts]
        img = seqs[0].index(IMAGE_TOKEN_INDEX)
        pre = torch.tensor([seqs[0][:img]], device="cuda")
        out["Sp"] = img + cfg.num_video_tokens
        out["hint"] = -(-(out["Sp"] + question_len + MAX_NEW_TOKENS)
                        // 128) * 128
        k, v, pm = build_prefix_kv(eng.params, cfg, pre, torch.ones_like(pre),
                                   feats[None], out["hint"])
        q_ids, q_mask = (torch.from_numpy(a).long().cuda() for a in
                         eng._pad_bucket_batch([s[img + 1:] for s in seqs],
                                               question_len))
        q_emb = llm.embed_lookup(lp["embed"], q_ids,
                                 llm.embed_dtype(lp["embed"]))
        (out["prefix"], out["cache"], out["valid"],
         out["pos"]) = llm.prefill_continue(
            lp, L, q_emb, q_mask, k, v, pm, out["hint"],
            tail_len=-(-(question_len + MAX_NEW_TOKENS) // 128) * 128)
    return out


def two_videos(eng, temporal, spatial):
    """Paths F and G's two videos: the frames the paths resized (96 s) and
    the same pixels reversed in time (60 s). The GPU host has no video
    decoder, so two placeholder files under build/chip_smoke_videos/ give
    the feature cache its keys (path, mtime, size) and the engine's
    preprocess_video returns their frames → (paths, frames by path, the
    directory, removed by the caller)."""
    vdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_videos")
    os.makedirs(vdir, exist_ok=True)
    paths = []
    for i in range(2):
        paths.append(os.path.join(vdir, f"video{i}.mp4"))
        with open(paths[-1], "wb") as f:
            f.write(b"placeholder" * (i + 1))
    frames = {paths[0]: (temporal, spatial, 96.0),
              paths[1]: (np.ascontiguousarray(temporal[::-1]),
                         np.ascontiguousarray(spatial[::-1]), 60.0)}
    eng.preprocess_video = frames.__getitem__
    return paths, frames, vdir


def prefix_path(torch, kernels, zero, params, cfg, tok, temporal, spatial,
                per_req, card):
    """Path F: feature-cached and prefix-KV serving at full width (Phi-3.5,
    int8_full, int8 cache, greedy, MAX_NEW_TOKENS, batches of 6) on two
    videos: the frames the paths resized (96 s) and the same pixels
    reversed in time (60 s). The GPU host has no video decoder, so two
    placeholder files under build/chip_smoke_videos/ give the cache its
    keys (path, mtime, size) and the engine's preprocess_video returns
    their frames. PREFIX_QUERIES queries alternate between the videos and
    between the grounding and qa question texts, mode "grounding":
      1. run_stream_cached: 2 encodes (K1 62 each), 2 full prefills;
      2. the same call: 0 encodes, tokens equal to call 1's;
      3. run_stream_prefix through the cascade: 0 encodes, one prefix (K2
         per layer) per video, per decode step 4·nl w8a8 int8_gemv, 1 K5
         and 1 lm_head;
      4. run_stream_prefix with spec_draft_len: per verify pass 4·nl
         int8_gemv at 30 rows, 1 K9, 1 lm_head.
    Each call is counted like a path. Then the prefix route's first-step
    logits against the full prefill's on the same cached features
    (route_logits), on the int8_full and the bf16 tree, each within
    ROUTE_FLOOR_RATIO times the full prefill's own drift when its queries
    run alone, measured in the same run, and the bf16 tree also within
    BOUND_SMALL_W8A8: 32 layers of W8A8 rows move the full route against
    itself re-batched by up to 1.6e-1 on random features (H100), so a
    fixed bar cannot hold the int8_full tree. Then one cascade decode step
    timed beside its eager attention
    (nl calls of llm._cascade_attention). → the summed launch counts."""
    from grounded_video_llm_tpu_torch.core.config import GenerateConfig
    from grounded_video_llm_tpu_torch.models import llm
    from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine
    from grounded_video_llm_tpu_torch.text.templates import IMAGE_TOKEN_INDEX

    nl = cfg.llm.num_layers
    enc = per_req - nl                      # K1 launches of one encode
    gen = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False,
                         quantize_cache=True)
    gen_spec = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False,
                              quantize_cache=True,
                              spec_draft_len=SPEC_DRAFT_LEN)
    eng = InferenceEngine(params, cfg, tok, gen, seed=SEED,
                          quantize="int8_full")
    paths, frames, vdir = two_videos(eng, temporal, spatial)
    texts = [p for _, p in (MODES[0], MODES[1], MODES_2[0], MODES_2[1])]
    videos = [paths[i % 2] for i in range(PREFIX_QUERIES)]
    queries = [texts[(i // 2) % len(texts)] for i in range(PREFIX_QUERIES)]
    mode = "grounding"
    seqs = [eng.tokenize_prompt(eng.build_prompt(q, mode, 96.0))
            for q in queries]
    post = max(len(s) - s.index(IMAGE_TOKEN_INDEX) - 1 for s in seqs)
    question_len = max(64, -(-post // 64) * 64)

    def expect(n_enc, n_prefill, n_prefix, cascade):
        def fn(t):
            s = t.get("decode_steps", 0)
            P = t.get("verify_passes", 0)
            return dict(zero, flash_fwd=n_enc * enc + n_prefill * nl
                        + n_prefix * nl,
                        int8_gemv=4 * nl * (s + P),
                        decode_attention_int8=0 if cascade else nl * s,
                        scatter_write=s, scatter_write_multi=P,
                        int8_matmul=2 + s + P)
        return fn

    def call(route, g, check):
        def fn():
            kw = dict(question_len=question_len) if route == "prefix" else {}
            run = (eng.run_stream_prefix if route == "prefix"
                   else eng.run_stream_cached)
            out = run(videos, queries, mode=mode, batch_size=6, gen_cfg=g,
                      **kw)
            t = eng.last_timings
            check(out, t)
            return t
        return fn

    results, launches, tokens = {}, dict(zero), {}

    def record(name, out, t):
        results[name] = out
        tokens[name] = eng.last_tokens[0]
        steps = t.get("decode_steps", t.get("verify_passes", 0))
        log(f"[path] F {name}: encode {t.get('encode', 0.0):.3f} s "
            f"({t.get('encodes', 0)} encodes), prefix "
            f"{t.get('prefix', 0.0):.3f} s ({t.get('prefixes', 0)} prefixes),"
            f" prefill {t['prefill']:.3f} s, decode {t['decode']:.3f} s "
            f"({t['decode'] * 1e3 / max(steps, 1):.2f} ms per "
            f"{'pass' if 'verify_passes' in t else 'step'} over {steps}), "
            f"preprocess {t.get('preprocess', 0.0):.3f} s; durations "
            f"{sorted(set(r.duration for r in out))}; {card}")

    def want_encodes(n):
        def check(out, t):
            if t.get("encodes", 0) != n or len(out) != PREFIX_QUERIES:
                raise AssertionError(f"path F: {t.get('encodes', 0)} encodes"
                                     f" (want {n}), {len(out)} results")
            if [r.duration for r in out] != [frames[v][2] for v in videos]:
                raise AssertionError("path F: results not in input order")
        return check

    for name, route, g, n_enc, n_prefill, n_prefix in (
            ("1 run_stream_cached", "cached", gen, 2, 2, 0),
            ("2 run_stream_cached again", "cached", gen, 0, 2, 0),
            ("3 run_stream_prefix cascade", "prefix", gen, 0, 0, 2),
            (f"4 run_stream_prefix spec{SPEC_DRAFT_LEN}", "prefix", gen_spec,
             0, 0, 2)):
        def check(out, t, name=name, n_enc=n_enc):
            want_encodes(n_enc)(out, t)
            record(name, out, t)
        got = run_path(torch, kernels, f"F {name} (question_len "
                       f"{question_len})", call(route, g, check),
                       expect(n_enc, n_prefill, n_prefix, route == "prefix"))
        launches = {k: launches[k] + got[k] for k in launches}
    same = bool(torch.equal(tokens["1 run_stream_cached"],
                            tokens["2 run_stream_cached again"]))
    agree = {n: float((tokens[n] == tokens["1 run_stream_cached"])
                      .float().mean()) for n in tokens}
    log(f"[path] F tokens equal to call 1's, by call: {agree} (call 2 must "
        f"be 1.0; the prefix routes are readings: random weights flip "
        f"argmaxes) {'OK' if same else 'FAIL'}")
    if not same:
        raise AssertionError("path F: the repeated run_stream_cached call "
                             "gave other tokens")

    # the prefix route's first-step logits against the full prefill's, on
    # video 1's cached features and its queries, on the int8_full tree and
    # on the bf16 one; the full route against itself re-batched (each query
    # alone) gives the rounding floor of a 32-layer comparison
    feats, duration = eng.encode_video_cached(paths[0])
    prompts = [eng.build_prompt(q, mode, duration)
               for v, q in zip(videos, queries) if v == paths[0]]
    B = len(prompts)
    bf16 = InferenceEngine(params, cfg, tok, seed=SEED)
    routes = {name: route_logits(torch, e, cfg, feats, prompts, question_len)
              for name, e in (("bf16", bf16), ("int8_full", eng))}
    checks = []
    for name, r in routes.items():
        err = rel_err(torch, r["prefix"], r["full"])
        floor = rel_err(torch, r["alone"], r["full"])
        argmax = [float((r[x].argmax(-1) == r["full"].argmax(-1))
                        .float().mean()) for x in ("prefix", "alone")]
        bar = ROUTE_FLOOR_RATIO * floor
        if name == "bf16":
            bar = min(bar, BOUND_SMALL_W8A8)
        ok = err <= bar
        checks.append(ok)
        log(f"[path] F prefix vs full prefill, {name} tree, video 1's {B} "
            f"queries: first-step logits rel L2 {err:.3e} (<= {bar:.3e}: "
            f"{ROUTE_FLOOR_RATIO} x the floor"
            + (f", at most {BOUND_SMALL_W8A8}" if name == "bf16" else "")
            + f"); floor, the full route B={B} vs each query alone "
            f"{floor:.3e}, ratio {err / floor:.3f}; argmax agreement with "
            f"the full route B={B}: "
            f"prefix {argmax[0]:.3f}, alone {argmax[1]:.3f} (readings); "
            f"prefix {r['Sp']} tokens, hint {r['hint']}, full prompt "
            f"{r['S_full']} {'OK' if ok else 'FAIL'}; {card}")
    del bf16, routes["bf16"]
    r = routes["int8_full"]
    cache, valid, pos, hint = r["cache"], r["valid"], r["pos"], r["hint"]
    lp, L = eng.params["llm"], cfg.llm
    with torch.inference_mode():
        # one cascade decode step, timed, beside its eager attention
        tok_emb = llm.embed_lookup(lp["embed"], r["prefix"].argmax(-1))[:, None]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        step_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            start.record()
            _, cache, valid = llm.decode_step_shared(
                lp, L, tok_emb, cache, valid, pos, rope_hint=hint)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            pos = pos + 1
        H, Hkv, Dh = L.num_heads, L.num_kv_heads, L.head_dim
        gq = torch.Generator(device="cuda")
        gq.manual_seed(SEED)
        q = torch.randn(B, 1, H, Dh, generator=gq, device="cuda",
                        dtype=torch.bfloat16)
        kn, vn = (torch.randn(B, 1, Hkv, Dh, generator=gq, device="cuda",
                              dtype=torch.bfloat16) for _ in range(2))
        keep_p, keep_t = llm._shared_keep(L, cache.prefix_mask, valid,
                                          pos[:, None])
        keep_new = torch.ones(1, 1, dtype=torch.bool, device="cuda")
        tail = cache.tail

        def attention():
            for i in range(nl):
                llm._cascade_attention(
                    q, kn, vn, keep_new,
                    (cache.pk[i], cache.pk_scale[i], cache.pv[i],
                     cache.pv_scale[i]), keep_p,
                    (tail.k[i], tail.k_scale[i], tail.v[i],
                     tail.v_scale[i]), keep_t, Dh ** -0.5)

        attn_ms = cuda_ms(torch, attention, 3)
    step = min(step_ms)
    log(f"[path] F cascade decode step at B={B} (CUDA events, the lowest of "
        f"3): {step:.2f} ms, of it the eager cascade attention ({nl} layers,"
        f" the int8 prefix of {r['Sp']} slots dequantized each layer) "
        f"{attn_ms:.2f} ms, share {attn_ms / step:.3f}; "
        f"peak_device_memory={torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; {card}")
    if not all(checks):
        raise AssertionError("path F: the prefix route's logits disagree "
                             "with the full prefill's")
    del eng, feats, cache, tail, r, routes
    shutil.rmtree(vdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# path G: continuous batching and the HTTP server at the server's default
# shape (serve/server.ServingFrontend, cli/server.py's defaults)
POOL = dict(pool_size=4, prompt_len=256, max_new_tokens=64, chunk=8)
POOL_BUDGETS = (8, 16, 32, 64)     # per-request budgets, cycled
POOL_ALONE = (0, 1, 4, 5)          # served alone again: row independence
SHARED_ALONE = (1, 5)              # the same on round 3's cascade pool
TAIL_READING = 5                   # round 3's tail-length reading


def pool_asks(paths):
    """Path G's 10 requests: the five prompts whose whole prompt fits the
    256-token bucket (every mode; path A's grounding query takes 290) on
    each video, budgets cycled → [(video, prompt, mode, budget)]."""
    texts = [MODES[1], MODES[2], *MODES_2]
    return [(paths[i % 2], texts[i // 2][1], texts[i // 2][0],
             POOL_BUDGETS[i % len(POOL_BUDGETS)]) for i in range(10)]


def pool_expect(zero, nl, enc, *, prefix=False, spec=False, shared=False):
    """A round's launch counts from the server's timings (admissions, steps:
    decode steps or verify passes) and its set-up (encodes, prefix
    builds): K1 per encode, K2 per feature-backed admission prefill and per
    prefix build; per step or pass 4·nl K3 w8a8 (at pool_size or pool_size
    × (draft + 1) rows) and one lm_head; per step K5 and, on the plain
    cache, nl K4; per pass K9 and, on the plain cache, nl K8; one lm_head
    per admission."""
    def fn(t, prep):
        s, adm = t.get("steps", 0), t.get("admissions", 0)
        want = dict(zero, flash_fwd=(prep.get("encodes", 0) * enc
                                     + prep.get("builds", 0) * nl
                                     + (0 if prefix else adm * nl)),
                    int8_gemv=4 * nl * s, int8_matmul=s + adm)
        attn = 0 if shared else nl * s
        if spec:
            want.update(verify_attention_int8=attn, scatter_write_multi=s)
        else:
            want.update(decode_attention_int8=attn, scatter_write=s)
        return want
    return fn


def pool_round(torch, kernels, name, frontend, asks, expect, card,
               prepare=None):
    """One round of path G: every count to 0; prepare() (the encodes or
    prefix builds of the unique videos, on this thread, before any request
    is in flight: its readings); the asks submitted together through
    frontend.submit; every future awaited; the counts held against
    expect(server timings, readings). Prints requests, wall seconds,
    tokens, tokens/s, admission seconds (set-up and admission prefill
    apart), ms per chunk step by CUDA events and by the host clock, time to
    first token and peak memory → (token arrays, launches)."""
    server = frontend.server
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    server.timings = {}
    first, sent, futs = {}, {}, []
    t0 = time.perf_counter()
    prep = prepare() if prepare is not None else {}
    for i, (video, prompt, mode, budget) in enumerate(asks):
        sent[i] = time.perf_counter()
        fut, _ = frontend.submit(
            video, prompt, mode, budget,
            on_token=lambda tok, i=i: first.setdefault(i, time.perf_counter()))
        futs.append(fut)
    tokens = [f.result(timeout=900) for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: k.launches for n, k in kernels.items()}
    t = dict(server.timings)
    want = expect(t, prep)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_tok = sum(len(x) for x in tokens)
    steps = t.get("steps", 0)
    timed = max(t.get("timed_steps", 0), 1)
    ttft = np.asarray(sorted(first[i] - sent[i] for i in first)
                      or [float("nan")])
    # the same from the round's start: what a request that meets an
    # unencoded video (or an unbuilt prefix) waits, set-up included
    ttft0 = np.asarray(sorted(first[i] - t0 for i in first)
                       or [float("nan")])
    unit, units = (("pass", "passes") if server.spec_draft_len
                   else ("step", "steps"))
    setup = ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                      f"{k} {v}" for k, v in prep.items())
    tail = f" tail_len={server._tail_len}" if server.shared_prefix else ""
    log(f"[path] G {name}: requests={len(asks)} max_len={server.max_len}"
        f"{tail} "
        f"wall_s={wall:.3f} tokens={n_tok} tokens_per_s={n_tok / wall:.2f}; "
        f"set-up ({setup or 'none'}); admissions={t.get('admissions', 0)} "
        f"admission_prefill_s_per_request="
        f"{t.get('admit', 0.0) / max(t.get('admissions', 1), 1):.4f}; "
        f"{steps} {units} in {t.get('chunks', 0)} chunks: ms_per_{unit} "
        f"cuda_events={t.get('chunk_device_ms', 0.0) / timed:.2f} "
        f"host_clock={t.get('chunk', 0.0) * 1e3 / timed:.2f} (launch to "
        f"tokens read); time to first "
        f"token s from submission (after the set-up) "
        f"median={float(np.median(ttft)):.3f} max={float(ttft.max()):.3f}, "
        f"from the round's start (set-up included) "
        f"median={float(np.median(ttft0)):.3f} max={float(ttft0.max()):.3f}"
        f"; peak_device_memory={peak:.2f} GiB; "
        f"{card}")
    log(f"[path] G {name}: launches {got} expected {want}")
    if got != want:
        raise AssertionError(f"path G {name}: launch counts {got}, expected "
                             f"{want}")
    bad = [i for i, (x, a) in enumerate(zip(tokens, asks))
           if not 0 < len(x) <= a[3]]
    if bad:
        raise AssertionError(f"path G {name}: requests {bad} gave no tokens "
                             "or more than their budget")
    return tokens, got


def shared_alone(torch, llm, eng, asks, i, pipeline_chunks):
    """Request asks[i] alone through a fresh shared-prefix pool of round 3's
    shape (pipeline_chunks: its doubled margin and longer tail; the loop
    itself unpipelined), greedy → (tokens, every verify pass's (logits of
    its row [S, V] fp32, the row's valid tail slots then), the pool's
    tail_len)."""
    from grounded_video_llm_tpu_torch.serve.server import ServingFrontend

    frontend = ServingFrontend(eng, **POOL, prefix_cache=True,
                               shared_prefix_pool=True,
                               spec_draft_len=SPEC_DRAFT_LEN,
                               pipeline_chunks=pipeline_chunks)
    frontend.shutdown()              # served here, on this thread
    server = frontend.server
    server.pipeline = False
    req, _ = eng.make_continuous_request(
        asks[i][0], asks[i][1], asks[i][2], prompt_len=POOL["prompt_len"],
        max_new_tokens=asks[i][3], prefix_rope_hint=server.max_len)
    passes = []
    real = llm.verify_step_shared

    def record(params, cfg, embeds, cache, valid, *a, **k):
        out = real(params, cfg, embeds, cache, valid, *a, **k)
        # the lone request holds slot 0
        passes.append((out[0][0].float().clone(), valid[0].sum()))
        return out
    with mock.patch.object(llm, "verify_step_shared", record):
        tokens = server.serve([req])[0]
    torch.cuda.synchronize()
    tail = server._tail_len
    del frontend, server, req
    torch.cuda.empty_cache()
    return tokens, [(x, int(n)) for x, n in passes], tail


def tail_product_reading(torch, llm, cfg, Sp, tails, valid, device):
    """The cascade's tail product (llm._pv_f32: softmax weights times the
    per-slot tail's values, bf16 operands, fp32 out) at round 3's shapes
    (pool rows, S = SPEC_DRAFT_LEN + 1 queries, the weights a slice of the
    whole [prefix ; tail ; in-pass] row), weights 0 past `valid` slots, on
    each tail length in `tails` → max |difference| between the first and
    the second tail's outputs (0.0: bit-equal)."""
    L = cfg.llm
    B, Hkv, Dh = POOL["pool_size"], L.num_kv_heads, L.head_dim
    M = L.num_heads // Hkv * (SPEC_DRAFT_LEN + 1)
    g = torch.Generator(device=device).manual_seed(SEED)
    Mt = max(tails)
    v = torch.randn(B, Hkv, Mt, Dh, generator=g, device=device)
    w = torch.rand(B, Hkv, M, Mt, generator=g, device=device)
    w[..., valid:] = 0
    outs = []
    for t in tails:
        row = torch.zeros(B, Hkv, M, Sp + t + SPEC_DRAFT_LEN + 1,
                          dtype=torch.bfloat16, device=device)
        row[..., Sp:Sp + t] = w[..., :t]
        outs.append(llm._pv_f32(row[..., Sp:Sp + t],
                                v[:, :, :t].to(torch.bfloat16)))
    return float((outs[0] - outs[1]).abs().max())


def pool_step_check(torch, da, cw, llm, cont, eng, cfg, asks, card):
    """One decode step of a pool whose rows sit at distinct lengths (three
    requests admitted a chunk apart) with its fourth slot never used
    (inactive): K5 bit-equal to its plain version on that step's writes,
    the same storage, every other byte untouched; K4 within its bars
    (BOUND_ATTN_REL, BOUND_ATTN_ROW) on layer 0's inputs, the pool's own
    ragged masks and the inactive row's empty one included."""
    server = cont.ContinuousServer(eng.params, cfg, **POOL,
                                   temperature=0.0, do_sample=False,
                                   eos_token_id=eng.tokenizer.eos_token_id,
                                   pad_token_id=eng.tokenizer.pad_token_id)
    emitted, results = {i: [] for i in range(3)}, {}
    for i in range(3):
        req, _ = eng.make_continuous_request(
            asks[i][0], asks[i][1], asks[i][2],
            prompt_len=POOL["prompt_len"], max_new_tokens=64)
        server._admit([(i, server.stage_request(req, server.device))],
                      emitted, results)
        if i < 2:
            server._run_chunk(emitted, results)
    seen = {}

    def k4(q, kq, ks, vq, vs, mask, kn, vn, scale):
        if "k4" not in seen:
            seen["k4"] = [x.clone() for x in (q, kq, ks, vq, vs, mask, kn,
                                              vn)] + [scale]
        return da.decode_attention_int8(q, kq, ks, vq, vs, mask, kn, vn,
                                        scale=scale)

    def k5(caches, news, idx):
        seen["k5"] = ([c.clone() for c in caches], news, idx.clone(), caches,
                      [c.data_ptr() for c in caches])
        cw.scatter_write(caches, news, idx)

    lengths = server.state.cache.length.tolist()
    with mock.patch.multiple(llm, decode_attention_int8=k4, scatter_write=k5):
        server._run_chunk(emitted, results, force_chunk=1)
    torch.cuda.synchronize()
    before, news, idx, after, ptrs = seen["k5"]
    slots = idx.tolist()
    expect = [c.clone() for c in before]
    cw.scatter_write_reference(expect, news, idx.cpu())
    same = all(torch.equal(a, b) for a, b in zip(after, expect))
    kept = [c.data_ptr() for c in after] == ptrs
    keep = torch.ones(len(slots), after[0].shape[3], dtype=torch.bool,
                      device=after[0].device)
    for b, slot in enumerate(slots):
        keep[b, slot] = False
    untouched = all(
        torch.equal(c.transpose(1, 2)[:, :, keep].view(torch.uint8),
                    o.transpose(1, 2)[:, :, keep].view(torch.uint8))
        for c, o in zip(after, before))
    q, kq, ks, vq, vs, mask, kn, vn, scale = seen["k4"]
    o = da.decode_attention_int8(q, kq, ks, vq, vs, mask, kn, vn, scale=scale)
    o_ref = da.decode_attention_int8_reference(q, kq, ks, vq, vs, mask, kn,
                                               vn, scale=scale)
    do = o.float() - o_ref.float()
    rel = float(torch.linalg.vector_norm(do)
                / torch.linalg.vector_norm(o_ref.float()))
    row = float((torch.linalg.vector_norm(do, dim=-1)
                 / torch.linalg.vector_norm(o_ref.float(), dim=-1)).max())
    visible = mask.sum(dim=-1).tolist()
    ok5 = same and kept and untouched and len(set(slots)) == len(slots)
    ok4 = (rel <= BOUND_ATTN_REL and row <= BOUND_ATTN_ROW
           and bool(torch.isfinite(o).all()) and visible[-1] == 0)
    log(f"[path] G pool step: lengths {lengths}, active "
        f"{server.state.active.tolist()}; K5 writes slots {slots} (distinct "
        f"per row) equal_to_plain={same} same_storage={kept} "
        f"untouched_bytes_equal={untouched} {'OK' if ok5 else 'FAIL'}; K4 "
        f"layer 0 on the pool's masks (visible slots per row {visible}): "
        f"rel|do|={rel:.3e} (<= {BOUND_ATTN_REL}) max per (row, head) "
        f"rel|do|={row:.3e} (<= {BOUND_ATTN_ROW:.3e}) "
        f"{'OK' if ok4 else 'FAIL'}; {card}")
    if not (ok4 and ok5):
        raise AssertionError("path G: K4 or K5 disagrees with its plain "
                             "version on a pool step")


def admission_logits(torch, cont, eng, cfg, asks, video, prefix_len):
    """First-step logits of `video`'s asks through the pool's two admission
    prefills (B = 1): feature-backed, the prompt left-padded to the bucket
    (the plain pool's max_len), and prefix-backed, the question left-padded
    to the bucket (the prefix pool's). The floor is path F's: the feature
    route against itself with the padding changed, each prompt unpadded at
    its own length (the route at B = n against B = 1 is no floor: the
    card's kernels gave bit-equal logits) → (prefix vs feature rel L2,
    floor, n)."""
    from grounded_video_llm_tpu_torch.text.templates import IMAGE_TOKEN_INDEX

    plain_len = -(-(POOL["prompt_len"] - 1 + cfg.num_video_tokens
                    + POOL["max_new_tokens"] + POOL["chunk"]) // 128) * 128
    prefix_max = -(-(prefix_len + POOL["prompt_len"]
                     + POOL["max_new_tokens"] + POOL["chunk"]) // 128) * 128
    mine = [a for a in asks if a[0] == video]
    feats, duration = eng.encode_video_cached(video)
    feats = feats.to(eng.device)
    seqs = [eng.tokenize_prompt(eng.build_prompt(prompt, mode, duration))
            for _, prompt, mode, _ in mine]
    n = len(seqs)

    def t(a):
        return torch.from_numpy(np.asarray(a)).long().to(eng.device)

    def feature(ids, mask):
        return cont._prefill_batch_from_features(
            eng.params, cfg, t(ids), t(mask),
            feats[None].expand(len(ids), *feats.shape), plain_len)[0]

    padded = [eng._pad_bucket(s, POOL["prompt_len"]) for s in seqs]
    img = seqs[0].index(IMAGE_TOKEN_INDEX)
    with torch.no_grad():
        alone = torch.cat([feature(i[None], m[None]) for i, m in padded])
        unpadded = torch.cat([feature([s], [[1] * len(s)]) for s in seqs])
        prefix = eng.prefix_kv_cached(video, seqs[0][:img], feats, prefix_max)
        pref = []
        for s in seqs:
            q, qm = eng._pad_bucket(s[img + 1:], POOL["prompt_len"])
            pref.append(cont._prefill_batch_from_prefix(
                eng.params, cfg, t(q[None]), t(qm[None]), *prefix,
                prefix_max)[0])
        pref = torch.cat(pref)
    return rel_err(torch, pref, alone), rel_err(torch, unpadded, alone), n


def continuous_path(torch, kernels, zero, params, cfg, tok, temporal,
                    spatial, per_req, card):
    """Path G: continuous batching behind the HTTP server's default shape
    (ServingFrontend(pool_size=4, prompt_len=256, max_new_tokens=64,
    chunk=8), greedy) at full width (Phi-3.5, int8_full) on path F's two
    videos, each round's requests submitted together through
    ContinuousScheduler:
      1. the feature-backed pool: 10 requests in the three modes with
         budgets 8/16/32/64, the two videos encoded once; then
         POOL_ALONE's requests each served alone through a fresh pool of
         the same shape, token-equal (rows are independent under the
         active mask), and pool_step_check (K5 and K4 on a pool step);
      2. the prefix-backed pool (prefix_cache): the same requests; the
         first-step logits of a prefix admission against a feature
         admission within ROUTE_FLOOR_RATIO times the feature route's own
         drift when its padding changes, measured in the same run (path
         F's rule; admission_logits);
      3. the shared-prefix pool with spec_draft_len=SPEC_DRAFT_LEN and
         pipeline_chunks, then its loop unpipelined on the same shapes:
         bit-equal tokens; SHARED_ALONE's requests each served alone
         through a fresh pool of those shapes, token-equal; request
         TAIL_READING's verify passes on the default pool's shorter tail
         against those shapes', and the tail product on both (readings:
         shared_alone, tail_product_reading);
      4. HTTP: serve_http on 127.0.0.1, an ephemeral port: /healthz,
         /v1/models, one /v1/generate with stream false and one with stream
         true of a short round-1 request with text (both give its tokens
         and text; the deltas assemble it), one bad request answered 400,
         as the JAX server does.
    Each round is counted like a path (pool_expect) → the summed counts."""
    import threading
    import urllib.error
    import urllib.request

    from grounded_video_llm_tpu_torch.core.config import GenerateConfig
    from grounded_video_llm_tpu_torch.models import llm
    from grounded_video_llm_tpu_torch.ops import cache_write as cw
    from grounded_video_llm_tpu_torch.ops import decode_attention_int8 as da
    from grounded_video_llm_tpu_torch.serve import continuous as cont
    from grounded_video_llm_tpu_torch.serve import engine as engine_mod
    from grounded_video_llm_tpu_torch.serve.server import (ServingFrontend,
                                                           serve_http)

    nl = cfg.llm.num_layers
    enc = per_req - nl                      # K1 launches of one encode
    gen = GenerateConfig(max_new_tokens=POOL["max_new_tokens"],
                         do_sample=False, quantize_cache=True)
    eng = engine_mod.InferenceEngine(params, cfg, tok, gen, seed=SEED,
                                     quantize="int8_full")
    paths, _, vdir = two_videos(eng, temporal, spatial)
    asks = pool_asks(paths)
    launches = dict(zero)

    def add(got):
        for k in launches:
            launches[k] += got[k]

    def encodes():
        t = {}
        for p in paths:
            eng.encode_video_cached(p, timings=t)
        return {"encodes": t["encodes"], "encode_s": t["encode"]}

    def prefixes(frontend):
        def fn():
            n = []
            real = engine_mod.build_prefix_kv
            t0 = time.perf_counter()
            with mock.patch.object(engine_mod, "build_prefix_kv",
                                   lambda *a, **k: n.append(1)
                                   or real(*a, **k)):
                for p in paths:
                    eng.make_continuous_request(
                        p, asks[0][1], asks[0][2],
                        prompt_len=POOL["prompt_len"],
                        prefix_rope_hint=frontend.server.max_len)
            torch.cuda.synchronize()
            return {"builds": len(n), "prefix_s": time.perf_counter() - t0}
        return fn

    # ---- 1. the feature-backed pool
    frontend = ServingFrontend(eng, **POOL)
    tokens1, got = pool_round(
        torch, kernels, "1 feature-backed pool", frontend, asks,
        pool_expect(zero, nl, enc), card, encodes)
    frontend.shutdown()
    del frontend
    add(got)
    same = []
    for i in POOL_ALONE:
        alone = cont.ContinuousServer(
            eng.params, cfg, **POOL, temperature=0.0, do_sample=False,
            eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
        req, _ = eng.make_continuous_request(
            asks[i][0], asks[i][1], asks[i][2],
            prompt_len=POOL["prompt_len"], max_new_tokens=asks[i][3])
        same.append(bool(np.array_equal(alone.serve([req])[0], tokens1[i])))
        del alone
    log(f"[path] G 1 rows independent: requests {list(POOL_ALONE)} served "
        f"alone through a fresh pool of the same shape give the pool's "
        f"tokens: {same} {'OK' if all(same) else 'FAIL'}")
    if not all(same):
        raise AssertionError("path G: a request served alone gave other "
                             "tokens than in the pool")
    pool_step_check(torch, da, cw, llm, cont, eng, cfg, asks, card)

    # ---- 2. the prefix-backed pool
    frontend = ServingFrontend(eng, **POOL, prefix_cache=True)
    prefix_len = frontend.server._prefix_len
    _, got = pool_round(torch, kernels, "2 prefix-backed pool", frontend,
                        asks, pool_expect(zero, nl, enc, prefix=True), card,
                        prefixes(frontend))
    frontend.shutdown()
    del frontend
    add(got)
    err, floor, n = admission_logits(torch, cont, eng, cfg, asks, paths[0],
                                     prefix_len)
    ok = err <= ROUTE_FLOOR_RATIO * floor
    log(f"[path] G 2 prefix vs feature admission, video 0's {n} requests: "
        f"first-step logits rel L2 {err:.3e} (<= {ROUTE_FLOOR_RATIO} x the "
        f"floor = {ROUTE_FLOOR_RATIO * floor:.3e}); floor, the feature route "
        f"with the prompt left-padded to the bucket vs unpadded {floor:.3e}, "
        f"ratio {err / floor if floor else float('inf'):.3f}; prefix "
        f"{prefix_len} tokens {'OK' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("path G: the prefix admission's logits disagree "
                             "with the feature admission's")

    # ---- 3. the shared-prefix pool, speculative, pipelined, then the same
    # pool's loop unpipelined: pipelining doubles the overshoot margin, which
    # at this shape takes the per-slot tail from 384 to 512 slots, and the
    # eager cascade attention's tail product rounds otherwise over another
    # length (tail_product_reading), so the unpipelined loop runs on the
    # pipelined pool's shapes
    spec_tokens = {}
    for pipelined in (True, False):
        frontend = ServingFrontend(eng, **POOL, prefix_cache=True,
                                   shared_prefix_pool=True,
                                   spec_draft_len=SPEC_DRAFT_LEN,
                                   pipeline_chunks=True)
        frontend.server.pipeline = pipelined
        name = (f"3 shared-prefix pool spec{SPEC_DRAFT_LEN} "
                + ("pipelined" if pipelined else "unpipelined, the same "
                   "shapes"))
        spec_tokens[pipelined], got = pool_round(
            torch, kernels, name, frontend, asks,
            pool_expect(zero, nl, enc, prefix=True, spec=True, shared=True),
            card, prefixes(frontend))
        frontend.shutdown()
        del frontend
        add(got)
    same = all(np.array_equal(a, b) for a, b in
               zip(spec_tokens[False], spec_tokens[True]))
    agree = float(np.mean([np.array_equal(a, b) for a, b in
                           zip(spec_tokens[False], tokens1)]))
    log(f"[path] G 3 pipelined tokens bit-equal to the unpipelined loop's on "
        f"the same pool: {same}; requests equal to round 1's (a reading: "
        f"other routes, random weights) {agree:.2f} "
        f"{'OK' if same else 'FAIL'}")
    if not same:
        raise AssertionError("path G: the pipelined pool gave other tokens")
    # rows independent on the cascade: SHARED_ALONE's requests each served
    # alone through a fresh pool of the round's shapes give the round's
    # tokens; then request 0 alone on the default (unpipelined) pool's
    # shapes, whose tail is shorter: the first verify pass's logits of the
    # two tails locate the default-shape token mismatch (a reading)
    alone = {i: shared_alone(torch, llm, eng, asks, i, True)
             for i in SHARED_ALONE}
    same = [bool(np.array_equal(alone[i][0], spec_tokens[False][i]))
            for i in SHARED_ALONE]
    log(f"[path] G 3 rows independent: requests {list(SHARED_ALONE)} served "
        f"alone through a fresh shared-prefix pool of the round's shapes "
        f"give the round's tokens: {same} {'OK' if all(same) else 'FAIL'}")
    if not all(same):
        raise AssertionError("path G: a request served alone through the "
                             "shared-prefix pool gave other tokens")
    # request TAIL_READING alone on the default pool's shorter tail beside
    # the same on the round's shapes: pass by pass, the first verify pass
    # whose logits differ and the valid tail slots then; and the tail
    # product alone on the two tails, weights 0 past the question bucket
    # and past one slot more
    i = TAIL_READING
    short, long_ = shared_alone(torch, llm, eng, asks, i, False), alone[i]
    pairs = list(zip(short[1], long_[1]))
    diff = [j for j, (a, b) in enumerate(pairs) if not torch.equal(a[0], b[0])]
    first = (f"pass {diff[0]} of {len(pairs)} (valid tail slots "
             f"{pairs[diff[0]][0][1]}, logits rel L2 "
             f"{rel_err(torch, pairs[diff[0]][0][0], pairs[diff[0]][1][0]):.3e}"
             f"; every pass before it bit-equal, the last with "
             f"{pairs[diff[0] - 1][0][1] if diff[0] else '-'} valid slots)"
             if diff else f"none of {len(pairs)}")
    worst = max((rel_err(torch, a[0], b[0]) for a, b in pairs), default=0.0)
    prod = {n: tail_product_reading(torch, llm, cfg, prefix_len,
                                    (short[2], long_[2]), n, eng.device)
            for n in (POOL["prompt_len"], POOL["prompt_len"] + 1)}
    log(f"[path] G 3 request {i} alone, tail_len {short[2]} (the default "
        f"pool) vs {long_[2]} (the round's shapes): first verify pass "
        f"logits rel L2 {rel_err(torch, pairs[0][0][0], pairs[0][1][0]):.3e}"
        f"; the first pass whose logits differ: {first}; the largest rel L2 "
        f"{worst:.3e}; tokens equal {bool(np.array_equal(short[0], long_[0]))}"
        f"; the tail product (_pv_f32) on the two tails, max |diff| with "
        + ", ".join(f"{n} valid slots {d:.3e}" for n, d in prod.items())
        + f" (readings); {card}")

    # ---- 4. HTTP: of round 1's requests with a budget of at most 16, the
    # one whose text is the longest (random weights make most tokens ids
    # that decode to no text)
    texts = [tok.decode([int(x) for x in t], skip_special_tokens=True).strip()
             for t in tokens1]
    pick = max((i for i, a in enumerate(asks) if a[3] <= 16),
               key=lambda i: len(texts[i]))
    frontend = ServingFrontend(eng, **POOL)
    httpd = serve_http(frontend, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def request(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data=data, headers={
            "Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, r.headers["Content-Type"], r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers["Content-Type"], e.read()

    try:
        for k in kernels.values():
            k.launches = 0
        frontend.server.timings = {}
        t0 = time.perf_counter()
        health = request("/healthz")
        models = request("/v1/models")
        video, prompt, mode, budget = asks[pick]
        body = {"video_path": video, "prompt": prompt, "mode": mode,
                "max_new_tokens": budget}
        plain = request("/v1/generate", body)
        streamed = request("/v1/generate", dict(body, stream=True))
        bad = request("/v1/generate", {"prompt": "no video"})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        frontend.shutdown()
        thread.join(timeout=60)
    got = {n: k.launches for n, k in kernels.items()}
    t = dict(frontend.server.timings)
    add(got)
    want = pool_expect(zero, nl, enc)(t, {})
    payload = json.loads(plain[2]) if plain[0] == 200 else {}
    deltas, final = [], None
    for line in streamed[2].decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            obj = json.loads(line[len("data: "):])
            if obj.get("done"):
                final = obj
            else:
                deltas.append(obj["delta"])
    ok = (health[0] == 200 and json.loads(health[2])["status"] == "ok"
          and models[0] == 200
          and json.loads(models[2])["data"][0]["family"] == "phi3.5"
          and plain[0] == 200 and streamed[0] == 200
          and streamed[1] == "text/event-stream" and final is not None
          and "".join(deltas).strip() == final["text"] == payload["text"]
          == texts[pick]
          and payload["num_tokens"] == final["num_tokens"]
          == len(tokens1[pick])
          and bad[0] == 400 and got == want)
    log(f"[path] G 4 HTTP on {base}: /healthz {health[0]}, /v1/models "
        f"{models[0]}, /v1/generate of round 1's request {pick} {plain[0]} "
        f"({payload.get('num_tokens')} tokens, text {payload.get('text')!r}; "
        f"round 1 gave {len(tokens1[pick])} tokens, {texts[pick]!r}), "
        f"streamed {streamed[0]} {streamed[1]} in {len(deltas)} deltas "
        f"assembling the same text: "
        f"{final is not None and ''.join(deltas).strip() == payload.get('text')}"
        f", a request without video_path {bad[0]} (want 400); wall_s="
        f"{wall:.3f}; launches {got} expected {want} "
        f"{'OK' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("path G: the HTTP round trip failed")
    del eng
    shutil.rmtree(vdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# path H: the evaluation runner (cli/eval.py's in-process runner) at full
# width, and beam search
EVAL_VIDEOS = 12        # synthetic videos, each from its own seed
EVAL_PER_VIDEO = 3      # grounding items a video, listed together
EVAL_NEW_TOKENS = 16
EVAL_RERUN = 12         # the first items (4 videos) run again
EVAL_FEATURE_CACHE = 8  # the engine's feature LRU
EVAL_QUERIES = ("a person opens a door", "a person sits on a chair",
                "someone is cooking at the stove", "a person puts a book "
                "away", "a person turns off the light", "someone drinks from "
                "a cup", "a person walks through the doorway", "a person "
                "takes off their shoes", "someone is laughing on the sofa",
                "a person closes the window")
BEAM_K = 4


def eval_video(seed: int, n_frames: int = 96, h: int = 240, w: int = 320):
    """Seeded uint8 frames [F, h, w, 3] for path H: moving waves of a
    random phase and frequency per channel plus uniform noise, made in a
    few vectorized passes (synthetic_video's per-frame draws would cost
    about 1 s a video on the host)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    t = (0.2 * np.arange(n_frames, dtype=np.float32))[:, None, None]
    out = np.empty((n_frames, h, w, 3), np.uint8)
    for c in range(3):
        a = xx / rng.uniform(10, 30) + yy / rng.uniform(15, 35) \
            + rng.uniform(0, 2 * np.pi)
        wave = np.sin(a)[None] * np.cos(t) + np.cos(a)[None] * np.sin(t)
        noise = rng.integers(-12, 13, (n_frames, h, w), dtype=np.int16)
        out[..., c] = np.clip(127.5 + 90 * wave + noise, 0, 255)
    return out


def lru_encodes(lru: list, size: int, paths) -> int:
    """The encodes the engine's feature LRU makes for encode_video_cached
    calls on paths, in order; lru (most recent last) is updated."""
    n = 0
    for p in paths:
        if p in lru:
            lru.remove(p)
        else:
            n += 1
        lru.append(p)
        del lru[:max(0, len(lru) - size)]
    return n


def eval_path(torch, kernels, zero, params, cfg, tok, per_req, card):
    """Path H: cli/eval.py's in-process runner (run_benchmark) on mode A's
    tree (int8_full, int8 cache, batches of 6, greedy, EVAL_NEW_TOKENS) over
    EVAL_VIDEOS synthetic videos (96 frames of 240x320 each, durations
    30-120 s) behind placeholder files under build/chip_smoke_eval/: the
    engine's preprocess_video makes each video's frames and resizes them
    with its own preprocessing, on the native route (required).
      1. grounding: EVAL_VIDEOS * EVAL_PER_VIDEO Charades-STA items, a
         video's items listed together, from an annotation file in the
         charades_sta format read by the CLI's loader, with --prefix_cache:
         run_stream_prefix, one prefix a video, the encodes the feature LRU
         (EVAL_FEATURE_CACHE videos) implies;
      2. the first EVAL_RERUN items again (evicted videos encode again);
      3. multiple choice (6 items) and grounded QA (6 items) on two videos
         each through run_stream_cached;
      4. dense captioning of 2 videos through run_stream.
    Each call is counted like a path; the metric keys must be the JAX
    package's. → (summed launch counts, the engine)."""
    from grounded_video_llm_tpu_torch.cli import eval as cli_eval
    from grounded_video_llm_tpu_torch.core.config import GenerateConfig
    from grounded_video_llm_tpu_torch.ops import pil_resize
    from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine

    t_path = time.perf_counter()
    nl = cfg.llm.num_layers
    enc = per_req - nl                      # K1 launches of one encode
    eng = InferenceEngine(
        params, cfg, tok, GenerateConfig(max_new_tokens=EVAL_NEW_TOKENS,
                                         do_sample=False, temperature=0.0,
                                         quantize_cache=True),
        seed=SEED, quantize="int8_full",
        feature_cache_size=EVAL_FEATURE_CACHE)
    vdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_eval")
    shutil.rmtree(vdir, ignore_errors=True)
    os.makedirs(vdir)
    names = [f"ev{i:02d}" for i in range(EVAL_VIDEOS)]
    durations = {}
    for i, name in enumerate(names):
        with open(os.path.join(vdir, name + ".mp4"), "wb") as f:
            f.write(name.encode())
        durations[os.path.join(vdir, name + ".mp4")] = round(
            30.0 + 90.0 * i / (EVAL_VIDEOS - 1), 1)
    seeds = {p: 1000 + i for i, p in enumerate(durations)}
    preps = []

    def preprocess_video(path):
        temporal, spatial = eng.preprocess_frames(
            eval_video(seeds[path], cfg.num_frames))
        preps.append(path)
        return temporal, spatial, durations[path]

    eng.preprocess_video = preprocess_video
    rng = np.random.default_rng(SEED)
    lines = []
    for i, name in enumerate(names):
        d = durations[os.path.join(vdir, name + ".mp4")]
        for j in range(EVAL_PER_VIDEO):
            s0, s1 = sorted(rng.uniform(0, d, 2))
            q = EVAL_QUERIES[(EVAL_PER_VIDEO * i + j) % len(EVAL_QUERIES)]
            lines.append(f"{name} {s0:.1f} {s1:.1f}##{q}")
    anno = os.path.join(vdir, "charades_sta_test.txt")
    with open(anno, "w") as f:
        f.write("\n".join(lines) + "\n")
    base = ["--allow_random_weights", "--quantize", "int8_full",
            "--max_new_tokens", str(EVAL_NEW_TOKENS), "--video_root", vdir]
    keys = {"grounding": {"R1@0.3", "R1@0.5", "R1@0.7", "mIoU"},
            "mc": {"accuracy"}, "gqa": {"GQA", "mIoP", "mIoU", "Acc"},
            "captioning": {"SODA_c", "METEOR"}}
    lru: list = []
    launches = dict(zero)
    pil_resize.ROUTE_CALLS.update(native=0, numpy=0)

    def bench(name, argv, prefix, want_encodes, n_batches, route):
        """One run_benchmark call, counted like a path."""
        args = cli_eval.parse_args(base + argv)
        eng.prefix_cache = prefix
        out = {}

        def fn():
            t0 = time.perf_counter()
            out["result"] = cli_eval.run_benchmark(eng, args)
            out["wall"] = time.perf_counter() - t0
            return eng.last_timings

        def expect(t):
            s = t["decode_steps"]
            flash = {"prefix": t.get("encodes", 0) * enc
                     + t.get("prefixes", 0) * nl,
                     "cached": t.get("encodes", 0) * enc + n_batches * nl,
                     "plain": n_batches * per_req}[route]
            return dict(zero, flash_fwd=flash, int8_gemv=4 * nl * s,
                        decode_attention_int8=0 if route == "prefix"
                        else nl * s,
                        scatter_write=s, int8_matmul=n_batches + s)

        got = run_path(torch, kernels, f"H {name}", fn, expect)
        for k in launches:
            launches[k] += got[k]
        t, r = eng.last_timings, out["result"]
        m = r["metrics"]
        bad = []
        if set(m) != keys[args.benchmark]:
            bad.append(f"metric keys {sorted(m)}")
        if not all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in m.values()):
            bad.append(f"metric values {m}")
        if want_encodes is not None and t.get("encodes", 0) != want_encodes:
            bad.append(f"{t.get('encodes', 0)} encodes, the LRU implies "
                       f"{want_encodes}")
        log(f"[path] H {name}: {r['n_items']} items in {out['wall']:.2f} s, "
            f"{r['n_items'] / out['wall']:.3f} items/s; encode "
            f"{t.get('encode', 0.0):.3f} s ({t.get('encodes', 0)} encodes),"
            f" prefix {t.get('prefix', 0.0):.3f} s ({t.get('prefixes', 0)} "
            f"prefixes), prefill {t['prefill']:.3f} s, decode "
            f"{t['decode']:.3f} s ({t['decode_steps']} steps, "
            f"{t['decode'] * 1e3 / max(t['decode_steps'], 1):.2f} ms/step), "
            f"preprocess waited {t.get('preprocess', 0.0):.3f} s; metrics "
            f"{json.dumps(m)}; {card}")
        if bad:
            raise AssertionError(f"path H {name}: " + "; ".join(bad))
        return r, t

    # 1. grounding, prefix route: encodes in first-appearance order
    paths = [os.path.join(vdir, name + ".mp4") for name in names]
    n_items = EVAL_VIDEOS * EVAL_PER_VIDEO
    r, t = bench("1 grounding charades_sta --prefix_cache",
                 ["--benchmark", "grounding", "--anno_format",
                  "charades_sta", "--anno_path", anno, "--prefix_cache"],
                 True, lru_encodes(lru, EVAL_FEATURE_CACHE, paths),
                 EVAL_VIDEOS, "prefix")
    if r["n_items"] != n_items or t["prefixes"] != EVAL_VIDEOS:
        raise AssertionError(f"path H: {r['n_items']} items, "
                             f"{t['prefixes']} prefixes")
    # 2. the first items again: their videos left the LRU
    rerun = paths[:EVAL_RERUN // EVAL_PER_VIDEO]
    r, t = bench(f"2 grounding, the first {EVAL_RERUN} items again",
                 ["--benchmark", "grounding", "--anno_format",
                  "charades_sta", "--anno_path", anno, "--prefix_cache",
                  "--max_items", str(EVAL_RERUN)], True,
                 lru_encodes(lru, EVAL_FEATURE_CACHE, rerun), len(rerun),
                 "prefix")
    # 3. multiple choice and grounded QA on two videos each, cached route
    mc_videos, gqa_videos = names[4:6], names[0:2]
    opts = ["a kitchen", "a bedroom", "a garage", "a garden"]
    mc = [{"video": mc_videos[i % 2] + ".mp4",
           "question": f"Where does scene {i} take place?",
           "options": opts, "answer": "ABCD"[i % 4]} for i in range(6)]
    gqa = [{"video": gqa_videos[i % 2] + ".mp4",
            "question": f"What does the person hold in shot {i}?",
            "options": ["a cup", "a book", "a phone"], "answer": i % 3,
            "start": 2.0 + i, "end": 9.0 + 2 * i} for i in range(6)]
    for name, items, vids in (("mc", mc, mc_videos), ("gqa", gqa,
                                                      gqa_videos)):
        path = os.path.join(vdir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(items, f)
        order = sorted(os.path.join(vdir, it["video"]) for it in items)
        bench(f"3 {name} (run_stream_cached)",
              ["--benchmark", name, "--anno_path", path], False,
              lru_encodes(lru, EVAL_FEATURE_CACHE, order), 1, "cached")
    # 4. dense captioning of two videos (run_stream: one batch of 2)
    caps = {names[v]: {"duration": durations[paths[v]],
                       "timestamps": [[0.0, 10.0], [12.0, 25.0]],
                       "sentences": ["A person opens the door.",
                                     "The person sits down."]}
            for v in (EVAL_VIDEOS // 3, 2 * EVAL_VIDEOS // 3)}
    cap_path = os.path.join(vdir, "captions.json")
    with open(cap_path, "w") as f:
        json.dump(caps, f)
    preps_before = len(preps)
    bench("4 captioning (run_stream)", ["--benchmark", "captioning",
                                        "--anno_path", cap_path,
                                        "--batch_size", "2"], False, None, 1,
          "plain")
    if len(preps) - preps_before != 2:
        raise AssertionError("path H: captioning preprocessed "
                             f"{len(preps) - preps_before} videos, want 2")
    calls = dict(pil_resize.ROUTE_CALLS)
    log(f"[path] H host resizes {calls} for {len(preps)} preprocessed videos"
        f" (2 each: the frames, the segment frames); path H wall "
        f"{time.perf_counter() - t_path:.1f} s; {card}")
    if calls != {"native": 2 * len(preps), "numpy": 0}:
        raise AssertionError(f"path H: resize routes {calls}")
    shutil.rmtree(vdir, ignore_errors=True)
    return launches, eng


def sequence_logprob(torch, llm, vlm, params, cfg, ids, mask, sp, tp, tokens,
                     eos):
    """Teacher-forced joint log-prob of each row's tokens [B, T] after its
    prompt, up to and including its first EOS: one forward over
    [prompt ; tokens[:, :-1]] → [B] fp64 on the host."""
    with torch.inference_mode():
        feats = vlm.encode_video(params, cfg, sp, tp)
        embeds, _, m = vlm.splice_multimodal(ids, None, mask, feats,
                                             params["llm"]["embed"])
        S = embeds.shape[1]
        emb = llm.embed_lookup(params["llm"]["embed"], tokens[:, :-1],
                               embeds.dtype)
        full = torch.cat([embeds, emb], dim=1)
        fm = torch.cat([m, torch.ones_like(tokens[:, :-1])], dim=1)
        hidden = llm.forward_hidden(params["llm"], cfg.llm, full, fm)
        logits = llm.logits_from_hidden(params["llm"], hidden[:, S - 1:])
        logp = torch.log_softmax(logits.float(), dim=-1)
        picked = logp.gather(-1, tokens[..., None])[..., 0].double().cpu()
    out = []
    for row, lp in zip(tokens.cpu(), picked):
        hit = (row == eos).nonzero()
        n = int(hit[0]) + 1 if len(hit) else len(row)
        out.append(float(lp[:n].sum()))
    return out


def beam_path(torch, kernels, zero, bf16, full, cfg, temporal, spatial,
              greedy, per_req, card):
    """Beam search at full width on phase 5's frames: a bf16 B=1 request
    with num_beams=BEAM_K and MAX_NEW_TOKENS (K1/K2 only: the bf16 decode
    attention is eager), then an int8_full B=2 one (the bf16 cache: per
    step 4·nl weight-only K3 at 8 rows and K6 on the lm_head), counted like
    paths; num_beams=1 must give the bf16 B=1 path's greedy tokens; tokens
    in the vocabulary and lengths equal to their non-pad counts; ms per
    step and the share of a step the cache reorder takes (the two
    index_selects of a step, timed alone); the joint log-prob of the best
    beam and of greedy by one teacher-forced forward, a reading: beam
    search does not promise the higher one. → summed launch counts."""
    from grounded_video_llm_tpu_torch.core.config import GenerateConfig
    from grounded_video_llm_tpu_torch.models import llm, vlm
    from grounded_video_llm_tpu_torch.serve.beam import beam_search_tokens
    from grounded_video_llm_tpu_torch.serve.generate import _ceil128

    nl = cfg.llm.num_layers
    launches = dict(zero)
    duration = 96.0
    eos, pad = bf16.tokenizer.eos_token_id, bf16.tokenizer.pad_token_id
    V = cfg.llm.padded_vocab_size
    gen = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False,
                         num_beams=BEAM_K)
    checks = []
    for name, eng, pairs, k6 in (
            ("bf16 B=1", bf16, [MODES[0]], 0),
            ("int8_full B=2", full, [MODES[0], MODES[1]], 4 * nl + 1)):
        prompts = [eng.build_prompt(p, m, duration) for m, p in pairs]

        def fn(eng=eng, prompts=prompts):
            eng.generate(prompts, temporal, spatial, gen)
            return eng.last_timings

        got = run_path(torch, kernels, f"beam{BEAM_K} {name}", fn,
                       expect_counts(zero, nl, per_req, 0, False, k6))
        launches = {k: launches[k] + got[k] for k in launches}
        t = eng.last_timings
        tokens, lengths = eng.last_tokens
        ok = bool(((tokens >= 0) & (tokens < V)).all()) and torch.equal(
            lengths, (tokens != pad).sum(-1))
        checks.append(ok)
        step_ms = t["decode"] * 1e3 / max(t["decode_steps"], 1)
        ids, mask = eng._batch_ids(prompts)
        B = len(prompts)
        S_full = ids.shape[1] - 1 + cfg.num_video_tokens
        L = cfg.llm
        shape = (nl, B * BEAM_K, _ceil128(S_full + MAX_NEW_TOKENS),
                 L.num_kv_heads, L.head_dim)
        kv = [torch.zeros(shape, dtype=torch.bfloat16, device=eng.device)
              for _ in range(4)]
        gidx = torch.arange(B * BEAM_K, device=eng.device).flip(0)

        def reorder():
            torch.index_select(kv[0], 1, gidx, out=kv[2])
            torch.index_select(kv[1], 1, gidx, out=kv[3])

        reorder_ms = cuda_ms(torch, reorder, 5)
        del kv
        log(f"[beam] {name}, num_beams={BEAM_K}: {t['decode_steps']} steps "
            f"of {step_ms:.2f} ms (host clock), the cache reorder "
            f"({2 * np.prod(shape) * 2 / 2**30:.2f} GiB gathered a step) "
            f"{reorder_ms:.3f} ms, share {reorder_ms / step_ms:.3f}; tokens "
            f"in the vocabulary, lengths the non-pad counts: {ok}; "
            f"{card}")
        if name == "bf16 B=1":
            sp = eng._dev(spatial[None])
            tp = eng._dev(temporal[None])
            ids_t, mask_t = eng._dev(ids).long(), eng._dev(mask).long()
            one, _ = beam_search_tokens(
                eng.params, cfg, ids_t, mask_t, sp, tp,
                max_new_tokens=MAX_NEW_TOKENS, num_beams=1,
                eos_token_id=eos, pad_token_id=pad)
            same = torch.equal(one.cpu(), greedy)
            checks.append(same)
            lp_beam, lp_greedy = (sequence_logprob(
                torch, llm, vlm, eng.params, cfg, ids_t, mask_t, sp, tp,
                x.to(eng.device), eos)[0] for x in (tokens, greedy))
            log(f"[beam] bf16 B=1 num_beams=1 tokens equal to the bf16 B=1 "
                f"path's greedy tokens: {same}; joint log-prob by one "
                f"teacher-forced forward (a reading, not a gate): best of "
                f"{BEAM_K} beams {lp_beam:.4f}, greedy {lp_greedy:.4f}; "
                f"{card}")
    if not all(checks):
        raise AssertionError("beam search at full width: a check failed")
    torch.cuda.empty_cache()
    return launches


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
                resize_ms, card):
    """Full-width llama3 (vlm_config("llama3", stage="inference"):
    Meta-Llama-3-8B, 32 layers, 32 heads, 8 kv heads of 128; CLIP ViT-L/14
    and InternVideo2-1B as in the Phi-3.5 paths), seeded random bf16
    weights, on the frames the Phi-3.5 paths resized: the chunked encode
    check, the kernels at llama3's shapes, then a bf16 B=1 request and a
    mode A request (int8_full, int8 cache, B=6), their launch counts held
    to the config's, their tokens in the vocabulary and their texts
    parsed; then mode A's [graph] leg. → (the summed launch counts, the
    bf16 params)."""
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
    gen_cfg = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False)
    gen_int8 = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False,
                              quantize_cache=True)

    def timed(fn):
        """(fn(), seconds, the peak's rise above what was allocated before,
        what stays allocated after; both in GiB)"""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                (torch.cuda.memory_allocated() - base) / 2 ** 30)

    params, bf16_s, bf16_rise, bf16_gib = timed(
        lambda: build_params(cfg, "cuda", torch.bfloat16, seed=SEED))
    log(f"[params] full-width llama3 bf16 built on the card in "
        f"{bf16_s:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # the set-up of mode A's tree two ways: the engine's quantization of the
    # bf16 tree (the route every entry point took before build_params had
    # quantize=), then the LLM built directly in int8; the LLMs bit-equal
    engine_q, q_s, q_rise, _ = timed(lambda: InferenceEngine(
        params, cfg, tok, gen_int8, seed=SEED, quantize="int8_full"))
    quant_llm = engine_q.params["llm"]
    del engine_q
    direct, direct_s, direct_rise, _ = timed(lambda: build_params(
        cfg, "cuda", torch.bfloat16, seed=SEED, quantize="int8_full"))
    bad = tree_differences(torch, direct["llm"], quant_llm)
    bad += ["not llm: " + p for p in tree_differences(
        torch, {k: v for k, v in direct.items() if k != "llm"},
        {k: v for k, v in params.items() if k != "llm"})]
    # the route's peak above what was allocated before its bf16 build
    route_rise = max(bf16_rise, bf16_gib + q_rise)
    del quant_llm
    torch.cuda.empty_cache()
    ok = not bad and direct_rise < route_rise
    log(f"[setup] llama3 mode A tree, built directly "
        f"(build_params(quantize='int8_full')): {direct_s:.2f} s, peak rise "
        f"{direct_rise:.2f} GiB; bf16 then the engine's quantization: "
        f"build_params {bf16_s:.2f} s (peak rise {bf16_rise:.2f} GiB) + "
        f"quantization {q_s:.2f} s (peak rise {q_rise:.2f} GiB above the "
        f"{bf16_gib:.2f} GiB bf16 tree), {bf16_s + q_s:.2f} s and a peak "
        f"rise of {route_rise:.2f} GiB in all; every leaf of the direct tree "
        f"bit-equal (LLM to the engine-quantized one, the rest to the bf16 "
        f"tree): {not bad} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the direct int8 build: {bad[:8]} differ, or "
                             f"its peak rise {direct_rise:.2f} GiB is not "
                             f"below the route's {route_rise:.2f} GiB")
    encode_chunk_check(torch, vlm, params, cfg, temporal, spatial)
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
    # mode A serves the direct tree; the engine quantizes its encoders
    full = InferenceEngine(direct, cfg, tok, gen_int8, seed=SEED,
                           quantize="int8_full")
    del direct
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
    g16 = GenerateConfig(max_new_tokens=GRAPH_NEW_TOKENS, do_sample=False,
                         quantize_cache=True)
    feats = full.encode_features(temporal, spatial)
    p6 = [full.build_prompt(p, m, 96.0) for m, p in batch6]
    graph_leg(torch, "llama3 A int8_full int8-cache B=6 decode", full.graphs,
              engine_run(full, lambda: full.generate_from_features(
                  p6, feats, g16)), card)
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
    stage="grounded") tree, depth cut (LLM 1 of 32 layers, CLIP 1 of 24,
    InternVideo2 1 of 40 blocks; width, the 128,558-row vocabulary and
    the q/k/v split kept), seeded random bf16 on the card, written by
    models/export.write_weight_dumps in the weights-day layout (float32,
    as the reference ships), then the weight dumps read back by
    build_params(weight_root=, video_encoder_path=) onto the card: every
    leaf they hold must be bit-equal to its source. The stage checkpoint
    among the files (the projectors, embed and lm_head again) is read by
    the [reload] check of the trained export instead, so the video
    projector, which only it holds, is seeded here. Prints the bytes
    written and the seconds spent writing and reading."""
    from grounded_video_llm_tpu_torch.cli.model_loading import build_params
    from grounded_video_llm_tpu_torch.core.config import replace, vlm_config
    from grounded_video_llm_tpu_torch.models.export import write_weight_dumps
    from grounded_video_llm_tpu_torch.train.optimizer import tree_items

    full = vlm_config("llama3", stage="grounded")
    cfg = replace(full, llm=replace(full.llm, num_layers=1),
                  clip=replace(full.clip, num_layers=1),
                  video=replace(full.video, depth=1, num_blocks_used=1))
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
                       video_encoder_path=paths["video_encoder"])
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    want, have = dict(tree_items(src)), dict(tree_items(got))
    held = {p for p in want if not p.startswith("video_projector/")}
    bad = sorted(p for p in held
                 if p not in have or have[p].dtype != want[p].dtype
                 or not torch.equal(have[p], want[p]))
    ok = not bad and set(want) == set(have)
    log(f"[roundtrip] llama3 full width (hidden {cfg.llm.hidden_size}, "
        f"vocabulary {cfg.llm.padded_vocab_size}, q/k/v "
        f"{cfg.llm.q_dim}/{cfg.llm.kv_dim}/{cfg.llm.kv_dim}), depth cut: LLM "
        f"1 of 32 layers, CLIP 1 of 24, InternVideo2 1 of 40 blocks; "
        f"{sum(sizes.values())} bytes in {len(sizes)} files ("
        + ", ".join(f"{f} {n}" for f, n in sorted(sizes.items()))
        + f"); written in {write_s:.2f} s, the weight dumps (all but "
        f"stage_grounded.pth) read onto the card by build_params in "
        f"{read_s:.2f} s; their {len(held)} leaves bit-equal to the bf16 "
        f"source: {ok} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"reference-format round trip: {bad[:8]} differ")
    # the same files read again with the LLM built directly in int8: its
    # leaves bit-equal to the quantized bf16 read-back, the rest equal to it
    from grounded_video_llm_tpu_torch.serve.quantize import \
        quantize_llm_for_serving

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = build_params(cfg, "cuda", torch.bfloat16, seed=SEED + 6,
                     weight_root=paths["weight_root"],
                     video_encoder_path=paths["video_encoder"],
                     quantize="int8_full")
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    q_rise = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    bad = tree_differences(torch, q, dict(got, llm=quantize_llm_for_serving(
        got["llm"], w8a8=True)))
    bf16_gib = sum(t.numel() * t.element_size()
                   for t in have.values()) / 2 ** 30
    log(f"[roundtrip] the same files read by build_params(quantize="
        f"'int8_full') in {q_s:.2f} s, peak rise {q_rise:.2f} GiB (the bf16 "
        f"read holds {bf16_gib:.2f} GiB): the LLM bit-equal to quantize_llm_for_serving of the bf16 "
        f"read-back, every other leaf to it: {not bad} "
        f"{'OK' if not bad else 'FAIL'}")
    del src, got, q
    torch.cuda.empty_cache()
    shutil.rmtree(workdir, ignore_errors=True)
    if bad:
        raise AssertionError(f"int8 read of the reference files: {bad[:8]} "
                             "differ")


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


def stage_text(seed: int, stage: str, rounds: int,
               llm_name: str = "phi3.5") -> str:
    """A conversation in the stage's data format, rendered by the LLM's
    template: pretrain a caption of the video (MixPretrain: no grounding
    mark, no time tokens), sft a mix of questions on the video and
    grounding turns, the grounding questions marked and answered in <n>
    time tokens (MixSFT)."""
    from grounded_video_llm_tpu_torch.text import codec
    from grounded_video_llm_tpu_torch.text.templates import get_template

    rng = np.random.default_rng(seed)
    events = ["the host turns to the camera", "a car passes the studio window",
              "the weather map appears", "the anchor reads the headline",
              "a reporter walks along the street", "the crowd starts to cheer"]
    if stage == "pretrain":
        caption = " ".join(f"Then {events[i]}." for i in
                           rng.integers(0, len(events), size=rounds))
        conv = [{"from": "human", "value": "<image>\nDescribe the video."},
                {"from": "gpt", "value": caption}]
    else:
        conv = []
        for r in range(rounds):
            e, f = events[r % 6], events[(r + 2) % 6]
            if r % 2:
                a, b = sorted(int(x) for x in rng.integers(0, 301, size=2))
                q, ans = (f"When does {e} and then {f}? Please return the "
                          "start and end timestamps."), f"From <{a}> to <{b}>."
            else:
                q, ans = f"What happens after {e}?", f"After that, {f}."
            conv.append({"from": "human",
                         "value": ("<image>\n" if r == 0 else "") + q})
            conv.append({"from": "gpt", "value": ans})
        conv = codec.mark_grounding_conversations(conv)
    return get_template(llm_name).encode(conv)


def stage_samples(temporal, spatial, stage: str, n: int, seed: int):
    rounds = 6 if stage == "pretrain" else 40
    return [{"video_ids": f"synthetic{i}", "text_inputs":
             stage_text(seed + i, stage, rounds),
             "temporal_pixel_values": temporal,
             "spatial_pixel_values": spatial} for i in range(n)]


def stage_path(torch, kernels, params, temporal, spatial, workdir):
    """Path I: the pretrain and sft presets at full width through
    TrainingStrategy on a 1-rank NCCL mesh (a FileStore under workdir, no
    fallback: the backend must be NCCL and the mesh on the card), each at
    a global batch of 2 in microbatches of 1, remat on (LoRA dropout 0.05
    in sft). pretrain: the tree without LoRA, embed and lm_head cut to the
    base vocabulary (its config has no expansion), 4 captions, 2 steps;
    the first changes nothing (lr 0), the second must move the projectors
    and nothing else (the LLM is frozen, embed and lm_head at lr 0 there).
    sft: path 6's trained tree (LoRA, expanded vocabulary), 6 samples, 3
    steps with an asynchronous interval save after step 2, so step 3 runs
    while it is written; the second step must move the projectors, the
    LoRA adapters, embed and lm_head, and nothing else. Counts to 0 just
    before each run, read just after (K1/K2 and K7 as in path 6). Then the
    async save read back bit-equal to the state at step 2, and one sft
    step through the mesh's step function against the plain (meshless)
    step from the same state and batch: loss, grad_norm and every updated
    leaf bit-equal (both under torch's deterministic algorithms, so the
    embedding gradient's duplicate rows add in one order). → launches."""
    import dataclasses
    from datetime import timedelta

    import torch.distributed as dist

    from grounded_video_llm_tpu_torch.cli.model_loading import \
        build_tokenizer
    from grounded_video_llm_tpu_torch.core import checkpoint as ckpt
    from grounded_video_llm_tpu_torch.core.config import (STAGE_PRESETS,
                                                          vlm_config)
    from grounded_video_llm_tpu_torch.data.collate import collate
    from grounded_video_llm_tpu_torch.models import vlm
    from grounded_video_llm_tpu_torch.parallel.mesh import build_mesh
    from grounded_video_llm_tpu_torch.text.templates import get_template
    from grounded_video_llm_tpu_torch.train.optimizer import (make_optimizer,
                                                              tree_items)
    from grounded_video_llm_tpu_torch.train.step import make_train_step
    from grounded_video_llm_tpu_torch.train.strategy import TrainingStrategy

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(workdir, "store"), 1),
        rank=0, world_size=1, timeout=timedelta(seconds=600),
        device_id=torch.device("cuda", 0))
    launches = {n: 0 for n in kernels}
    orig = {s: STAGE_PRESETS[s] for s in ("pretrain", "sft")}
    try:
        mesh = build_mesh(1, 1, 1)
        if (dist.get_backend() != "nccl" or mesh.device.type != "cuda"
                or mesh.device_mesh.device_type != "cuda"):
            raise AssertionError(f"path I: mesh {mesh} is not an NCCL mesh "
                                 "on the card")
        log(f"[path] I {mesh}")
        V = vlm_config("phi3.5", stage="pretrain").llm.vocab_size
        layers = {k: v for k, v in params["llm"]["layers"].items()
                  if k != "lora"}
        pre_tree = dict(params, llm=dict(
            params["llm"], layers=layers,
            embed=params["llm"]["embed"][:V].detach().clone(),
            lm_head=params["llm"]["lm_head"][:, :V].detach().clone()))
        runs = (("pretrain", pre_tree, 4, 0.0),
                ("sft", params, 6, 0.7))
        for stage, tree, n, interval in runs:
            cfg = vlm_config("phi3.5", stage=stage)
            tok = build_tokenizer(cfg,
                                  expand=STAGE_PRESETS[stage].expand_vocab)
            STAGE_PRESETS[stage] = dataclasses.replace(
                orig[stage], global_batch_size=2, per_device_batch_size=1,
                epochs=1)
            samples = stage_samples(temporal, spatial, stage, n, SEED + 11)
            strat = TrainingStrategy(cfg, stage, tree, tok,
                                     run_dir=os.path.join(workdir, stage),
                                     mesh=mesh, n_train_examples=n, seed=SEED)
            if strat.mesh is not mesh or strat.grad_accum != 2:
                raise AssertionError(f"path I {stage}: mesh {strat.mesh}, "
                                     f"grad_accum {strat.grad_accum}")
            tp = strat.state.params
            before = {p: t.detach().to("cpu", copy=True)
                      for p, t in tree_items(tp)}
            moving = {p for p in before
                      if p.split("/")[0] in ("mm_projector",
                                             "video_projector")}
            if stage == "sft":
                moving |= {p for p in before if strat.optimizer.updated(p)}
            steps, clock, at_save = [], {}, {}

            def on_step(step, m, stage=stage, tp=tp, before=before,
                        moving=moving, strat=strat):
                torch.cuda.synchronize()
                now = time.perf_counter()
                rec = dict(m, step=step, seconds=now - clock["t"],
                           peak_gib=torch.cuda.max_memory_allocated()
                           / 2 ** 30)
                steps.append(rec)
                if not (np.isfinite(m["loss"])
                        and np.isfinite(m["grad_norm"])):
                    raise AssertionError(f"path I {stage} step {step}: "
                                         "non-finite loss or grad_norm")
                changed = {p for p, t in tree_items(tp)
                           if not torch.equal(t.detach().cpu(), before[p])}
                if step == 1 and changed:
                    raise AssertionError(f"path I {stage} step 1 (lr 0) "
                                         f"changed {sorted(changed)}")
                if step == 2 and changed != moving:
                    raise AssertionError(
                        f"path I {stage} step 2: moved "
                        f"{sorted(changed - moving)} that must not, not "
                        f"{sorted(moving - changed)} that must")
                if step == 2:
                    log(f"[path] I {stage} after step 2: {len(changed)} "
                        f"leaves moved (the stage's trainable groups), "
                        f"{len(before) - len(changed)} bit-equal")
                if step == 3 and interval:
                    at_save["writing"] = ckpt.save_in_flight()
                if step == 2 and interval:
                    # the state the interval save after this step writes
                    at_save["params"] = {p: tp_leaf.detach().to("cpu",
                                                                copy=True)
                                         for p, tp_leaf in tree_items(tp)
                                         if p in moving}
                    at_save["mu"] = {p: t.to("cpu", copy=True) for p, t in
                                     strat.state.opt_state["mu"].items()}
                    at_save["nu"] = {p: t.to("cpu", copy=True) for p, t in
                                     strat.state.opt_state["nu"].items()}
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                clock["t"] = time.perf_counter()

            for k in kernels.values():
                k.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            clock["t"] = time.perf_counter()
            strat.run_training(samples, resume_interval=interval,
                               on_step=on_step)
            got = {n_: k.launches for n_, k in kernels.items()}
            nl = cfg.llm.num_layers
            per_mb = {"flash_fwd": (cfg.clip.num_layers
                                    + cfg.clip.feature_layer + 1)
                      + cfg.video.num_blocks_used + 2 * nl,
                      "flash_bwd": nl}
            want = {n_: 2 * len(steps) * per_mb.get(n_, 0) for n_ in kernels}
            S_text = collate(samples[:1], tok, get_template("phi3.5"),
                             max_txt_len=strat.stage.max_txt_len
                             ).input_ids.shape[1]
            for rec in steps:
                log(f"[path] I {stage} step {rec['step']}: loss="
                    f"{rec['loss']:.5f} grad_norm={rec['grad_norm']:.4f} "
                    f"step_s={rec['seconds']:.3f} s_per_sample="
                    f"{rec['seconds'] / 2:.3f} peak_device_memory="
                    f"{rec['peak_gib']:.2f} GiB (S_text {S_text}, spliced "
                    f"{S_text - 1 + cfg.num_video_tokens})")
            log(f"[path] I {stage} B=1 accum=2 on the NCCL mesh: launches "
                f"{got} expected {want}")
            if got != want:
                raise AssertionError(f"path I {stage}: launches {got}, "
                                     f"expected {want}")
            launches = {k: launches[k] + got[k] for k in launches}
            if not interval:
                continue

            # ---- the asynchronous save at step 2, read back
            blocked = strat.save_blocked_s
            after_save = steps[2]["seconds"] - blocked[0]
            path = os.path.join(workdir, stage, "state_latest.pt")
            t0 = time.perf_counter()
            saved = torch.load(path, map_location="cpu", mmap=True,
                               weights_only=True)
            bad = []
            for p, t in tree_items(tp):
                want_t = at_save["params"].get(p)
                got_t = saved["params"]
                for k in p.split("/"):
                    got_t = got_t[k]
                same = (torch.equal(got_t, want_t) if want_t is not None
                        else torch.equal(got_t.to("cuda"), t.detach()))
                if not same:
                    bad.append(p)
            for k in ("mu", "nu"):
                bad += [f"{k}/{p}" for p, t in at_save[k].items()
                        if not torch.equal(saved["opt_state"][k][p], t)]
            if saved["step"] != 2 or saved["opt_state"]["count"] != 2:
                bad.append("step/count")
            read_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            log(f"[path] I {stage} async interval save after step 2: loop "
                f"blocked {blocked[0]:.3f} s (device to pinned host copy "
                f"of {size / 2 ** 30:.2f} GiB, the pinned buffers allocated"
                f" in this save), then step 3 ran "
                f"{steps[2]['seconds']:.3f} s with the blocking included "
                f"= {after_save:.3f} s after it, "
                + ("the writer still writing when step 3 ended"
                   if at_save["writing"] else
                   "the writer done before step 3 ended")
                + f" (step 2 {steps[1]['seconds']:.3f} s); read back in "
                f"{read_s:.2f} "
                f"s: {'bit-equal' if not bad else 'DIFFERS'} to the state "
                f"at step 2")
            if bad:
                raise AssertionError(f"path I: the async save differs at "
                                     f"{bad[:8]}")
            del saved, at_save
            shutil.rmtree(os.path.join(workdir, stage), ignore_errors=True)

            # ---- one mesh step against the plain step
            mb = collate(samples[:2], tok, get_template("phi3.5"),
                         max_txt_len=strat.stage.max_txt_len, device="cuda")
            batch = vlm.Batch(*(x.reshape(2, 1, *x.shape[1:]) for x in mb))
            plain_opt, _ = make_optimizer(strat.stage, strat.total_steps,
                                          tp)
            plain = make_train_step(cfg, plain_opt, grad_accum=2, remat=True,
                                    lora_dropout=strat.stage.lora_dropout,
                                    dropout_seed=SEED)
            st = strat.state
            # count 1: the schedule's peak (at the run's last count, 3, the
            # cosine has decayed to 0 and nothing would move)
            start = ({p: t.detach().clone() for p, t in tree_items(tp)
                      if p in moving},
                     {k: {p: t.clone() for p, t in st.opt_state[k].items()}
                      for k in ("mu", "nu")}, 1, st.step)

            def restore():
                flat = dict(tree_items(tp))
                with torch.no_grad():
                    for p, t in start[0].items():
                        flat[p].copy_(t)
                    for k in ("mu", "nu"):
                        for p, t in start[1][k].items():
                            st.opt_state[k][p].copy_(t)
                st.opt_state["count"], st.step = start[2], start[3]

            out = {}
            deterministic = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                for name, fn in (("mesh", strat.step_fn), ("plain", plain)):
                    restore()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, m = fn(st, batch)
                    torch.cuda.synchronize()
                    out[name] = (float(m["loss"]), float(m["grad_norm"]),
                                 time.perf_counter() - t0,
                                 {p: t.detach().clone() for p, t in
                                  tree_items(tp) if p in moving})
            finally:
                torch.use_deterministic_algorithms(deterministic)
            same_leaves = all(torch.equal(out["mesh"][3][p],
                                          out["plain"][3][p])
                              for p in moving)
            equal = (out["mesh"][:2] == out["plain"][:2]) and same_leaves
            log(f"[path] I {stage} one step on the mesh vs the plain step "
                f"from the same state and batch: loss {out['mesh'][0]!r} vs "
                f"{out['plain'][0]!r}, grad_norm {out['mesh'][1]!r} vs "
                f"{out['plain'][1]!r}, {len(moving)} updated leaves "
                f"{'bit-equal' if same_leaves else 'DIFFER'}; "
                f"{out['mesh'][2]:.3f} s vs {out['plain'][2]:.3f} s")
            if not equal:
                raise AssertionError("path I: the mesh step differs from "
                                     "the plain step")
            del out, start
        return launches
    finally:
        for s, c in orig.items():
            STAGE_PRESETS[s] = c
        dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# path J: tensor-split compute, two gloo ranks on the one card
# ---------------------------------------------------------------------------

TP_RANKS = 2                    # the tensor axis of path J's (1, 1, 2) mesh
TP_NEW_TOKENS = 16              # path J's greedy tokens a request
# the request, and its re-batch mate: the same question with more words,
# so that the request's row is left-padded when the two share a batch
TP_PROMPTS = (MODES[0], (MODES[0][0], MODES[0][1] + " Answer with the "
                         "timestamps of the whole event, from its very "
                         "first second to its last."))
# split vs single-process grounded step, both bf16 on the card: the loss as
# the card-vs-host bar (BOUND_TRAIN_LOSS); the global gradient norm at a
# tenth of the per-leaf gradient bar, since it sums every leaf's squares
BOUND_TP_LOSS = BOUND_TRAIN_LOSS
BOUND_TP_GRAD_NORM = 1e-2


def tp_lora(torch, cfg):
    """The adapters of path J's step (r=128, B drawn non-zero), the same
    draws in every process: a cuda generator seeded from SEED."""
    from grounded_video_llm_tpu_torch.train import lora as lora_mod

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 7)
    lora = lora_mod.init_lora(cfg.llm, generator=g, device="cuda",
                              dtype=torch.bfloat16)
    for la in lora.values():
        la["b"].normal_(0.0, 0.02, generator=g)
    return lora


def tp_request_logits(torch, params, cfg, eng, prompts, feats):
    """First-step fp32 logits of prompts on one video's features [1, NV, H]
    through the tree: splice, prefill into a bf16 cache of the rank's kv
    heads."""
    from grounded_video_llm_tpu_torch.models import llm, vlm

    with torch.inference_mode():
        ids, am = (torch.from_numpy(a).long().cuda()
                   for a in eng._batch_ids(prompts))
        B = len(prompts)
        embeds, _, m = vlm.splice_multimodal(
            ids, None, am, feats.expand(B, *feats.shape[1:]),
            params["llm"]["embed"])
        max_len = -(-(embeds.shape[1] + MAX_NEW_TOKENS) // 128) * 128
        cache = llm.KVCache.create(llm.rank_config(params["llm"], cfg.llm), B,
                                   max_len, dtype=embeds.dtype, device="cuda")
        logits, _ = llm.prefill(params["llm"], cfg.llm, embeds, m, cache)
    return logits.float().cpu()


def tp_step(torch, params, cfg_g, tok, temporal, spatial, mesh=None):
    """One grounded optimizer step at count 0 (lr 0: nothing moves) on
    params with tp_lora attached, B=1 (the train path's first sample),
    remat on, the stage's LoRA dropout, sharded on mesh where given →
    (loss, grad_norm, seconds, (peak, allocated before it) GiB, the train
    state, the text length)."""
    from grounded_video_llm_tpu_torch.core.config import STAGE_PRESETS
    from grounded_video_llm_tpu_torch.data.collate import collate
    from grounded_video_llm_tpu_torch.text.templates import get_template
    from grounded_video_llm_tpu_torch.train import lora as lora_mod
    from grounded_video_llm_tpu_torch.train.optimizer import make_optimizer
    from grounded_video_llm_tpu_torch.train.step import (create_train_state,
                                                         make_train_step,
                                                         shard_batch)

    stage = STAGE_PRESETS["grounded"]
    tree = dict(params, llm=lora_mod.attach_lora(params["llm"],
                                                 tp_lora(torch, cfg_g)))
    opt, _ = make_optimizer(stage, 100, tree)
    state = create_train_state(tree, opt, mesh=mesh, cfg=cfg_g)
    step = make_train_step(cfg_g, opt, grad_accum=1, remat=True,
                           lora_dropout=stage.lora_dropout,
                           dropout_seed=SEED, mesh=mesh)
    mb = collate(train_samples(temporal, spatial, 1, 40, SEED)[:1], tok,
                 get_template("phi3.5"), max_txt_len=cfg_g.max_txt_len,
                 device="cuda")
    if mesh is not None:
        mb = shard_batch(mb, mesh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, mb)
    torch.cuda.synchronize()
    return (float(m["loss"]), float(m["grad_norm"]),
            time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() / 2 ** 30, base), state,
            mb.input_ids.shape[1])


def tp_references(torch, params, cfg, tok, eng, temporal, spatial, card):
    """Path J's single-process side on the script's bf16 tree: the
    request's prefill logits alone and re-batched with its mate (the full
    prefill's own drift), and the grounded step (its loss, global gradient
    norm and peak). The step's count is 0, so it moves no leaf."""
    from grounded_video_llm_tpu_torch.core.config import vlm_config
    from grounded_video_llm_tpu_torch.models import vlm
    from grounded_video_llm_tpu_torch.train.optimizer import tree_items

    prompts = [eng.build_prompt(p, m, 96.0) for m, p in TP_PROMPTS]
    with torch.inference_mode():
        feats = vlm.encode_video(
            params, cfg, torch.from_numpy(spatial[None]).cuda(),
            torch.from_numpy(temporal[None]).cuda())
    alone = tp_request_logits(torch, params, cfg, eng, prompts[:1], feats)
    both = tp_request_logits(torch, params, cfg, eng, prompts, feats)
    del feats
    drift = rel_err(torch, both[:1], alone)
    pad = len(eng.tokenize_prompt(prompts[1])) - len(
        eng.tokenize_prompt(prompts[0]))
    cfg_g = vlm_config("phi3.5", stage="grounded")
    loss, gnorm, step_s, peak, state, S_text = tp_step(
        torch, params, cfg_g, tok, temporal, spatial)
    for _, leaf in tree_items(params):
        leaf.requires_grad_(False)
    del state
    torch.cuda.empty_cache()
    log(f"[tp] single process: request prefill logits re-batched with its "
        f"mate (B=2, the request left-padded by {pad} tokens) vs alone rel "
        f"L2 {drift:.3e}; grounded step B=1 "
        f"(S_text {S_text}): loss {loss:.5f} grad_norm {gnorm:.4f} "
        f"step_s={step_s:.3f} peak_device_memory={peak[0]:.2f} GiB "
        f"({peak[1]:.2f} GiB allocated before the step); {card}")
    return {"prompts": prompts, "logits": alone, "drift": drift,
            "loss": loss, "grad_norm": gnorm, "peak_gib": peak,
            "step_s": step_s}


def tp_rank(rank, world, prompts, temporal, spatial):
    """One rank of path J (spawned; gloo, both ranks on cuda:0): the
    script's bf16 tree sharded on a (1, 1, world) mesh, then (1) the
    request through InferenceEngine (eager: step graphs refuse a sharded
    tree) and its prefill logits, (2) the grounded step, its launch shapes
    and its device kernels. → plain data for the parent."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from grounded_video_llm_tpu_torch.cli.model_loading import (
        build_params, build_tokenizer)
    from grounded_video_llm_tpu_torch.core.config import (GenerateConfig,
                                                          vlm_config)
    from grounded_video_llm_tpu_torch.models import llm, vlm
    from grounded_video_llm_tpu_torch.ops import flash_attention as fa
    from grounded_video_llm_tpu_torch.parallel.mesh import build_mesh
    from grounded_video_llm_tpu_torch.parallel.partitioning import (
        local, shard_params)
    from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine
    from grounded_video_llm_tpu_torch.train.optimizer import tree_items

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = build_mesh(1, 1, world, device="cuda")
    cfg = vlm_config("phi3.5", stage="inference")
    tok = build_tokenizer(cfg)
    out = {"rank": rank}
    t0 = time.perf_counter()
    params = shard_params(build_params(cfg, "cuda", torch.bfloat16,
                                       seed=SEED), mesh, cfg)
    torch.cuda.empty_cache()        # the whole tree's blocks, for the other
    torch.cuda.synchronize()        # rank
    out["shard_s"] = time.perf_counter() - t0
    out["param_devices"] = sorted({str(local(t).device)
                                   for _, t in tree_items(params)})
    out["param_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    caches = []
    creates = {c: c.create for c in (llm.KVCache, llm.QuantKVCache)}

    def watch(cls):
        def make(*a, **kw):
            c = creates[cls](*a, **kw)
            caches.append((str(c.k.device), c.k.shape[
                3 if cls is llm.KVCache else 2]))
            return c
        return make

    for cls in creates:
        cls.create = watch(cls)
    shapes = collections.Counter()
    fwd, bwd = fa.flash_fwd, fa.flash_bwd

    def flash_fwd(q, k, v, bias, scale, causal, bounded=False, *a, **kw):
        shapes[("K2" if causal else "K1", tuple(q.shape), bool(bounded))] += 1
        return fwd(q, k, v, bias, scale, causal, bounded, *a, **kw)

    def flash_bwd(q, *a, **kw):
        shapes[("K7", tuple(q.shape), False)] += 1
        return bwd(q, *a, **kw)

    encode, feats = vlm.encode_video, []

    def encode_video(*a, **kw):
        feats.append(encode(*a, **kw))
        return feats[-1]

    fa.flash_fwd, fa.flash_bwd = flash_fwd, flash_bwd
    vlm.encode_video = encode_video
    try:
        eng = InferenceEngine(params, cfg, tok, GenerateConfig(
            max_new_tokens=TP_NEW_TOKENS, do_sample=False), seed=SEED)
        counters = {"flash_fwd": fa.FLASH_FWD, "flash_bwd": fa.FLASH_BWD}
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with eng.graphs.eager():
            eng.generate(prompts[:1], temporal, spatial)
        torch.cuda.synchronize()
        out["serve_s"] = time.perf_counter() - t0
        out["serve_timings"] = dict(eng.last_timings)
        out["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["serve_launches"] = {n: c.launches for n, c in counters.items()}
        out["tokens"] = eng.last_tokens[0][0].clone()
        out["serve_shapes"] = dict(shapes)
        shapes.clear()
        # the request's prefill logits on the features the engine encoded
        out["feats_device"] = str(feats[0].device)
        out["logits"] = tp_request_logits(torch, params, cfg, eng,
                                          prompts[:1], feats[0])
        del eng, feats[:]
        torch.cuda.empty_cache()

        shapes.clear()
        for c in counters.values():
            c.launches = 0
        # the step under the profiler (device kernels only): its launch
        # counts, launch shapes and device kernel list
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            loss, gnorm, step_s, peak, state, _ = tp_step(
                torch, params, vlm_config("phi3.5", stage="grounded"), tok,
                temporal, spatial, mesh)
        out.update(loss=loss, grad_norm=gnorm, step_s=step_s,
                   step_peak_gib=peak,
                   step_launches={n: c.launches for n, c in counters.items()},
                   step_shapes=dict(shapes),
                   state_devices=sorted({str(local(t).device) for _, t in
                                         tree_items(state.params)}))
        del state
        torch.cuda.empty_cache()
        names = collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "flash" in e.name)
        out["step_kernels"] = {
            re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", n): c
            for n, c in names.items()}
    finally:
        fa.flash_fwd, fa.flash_bwd = fwd, bwd
        vlm.encode_video = encode
        for cls, fn in creates.items():
            cls.create = fn
    out["caches"] = sorted(set(caches))
    return out


def tensor_path(torch, kernels, zero, params, cfg, tok, eng, greedy,
                temporal, spatial, per_req, card):
    """Path J: the (1, 1, 2) mesh's split compute on the card, at full width
    and depth, against the single-process route on the same tree
    (tp_references): two gloo ranks (parallel/launch.spawn, NCCL takes no
    two ranks on one card), both on cuda:0, gloo staging every collective
    through the host. Each rank serves the bf16 B=1 request through
    InferenceEngine and takes one grounded step. Raises unless every
    parameter, activation and cache of a rank is on cuda:0, every cache
    holds num_kv_heads / 2 heads, both ranks give the same tokens and the
    single-process first token, the prefill logits are within
    ROUTE_FLOOR_RATIO times the full prefill's own re-batching drift, the
    loss and gradient norm within BOUND_TP_LOSS / BOUND_TP_GRAD_NORM, and
    the launches are the path's at the rank's head counts. → (rank 0's
    launches, as a path's)."""
    from grounded_video_llm_tpu_torch.parallel.launch import spawn

    ref = tp_references(torch, params, cfg, tok, eng, temporal, spatial,
                        card)
    t0 = time.perf_counter()
    ranks = spawn(tp_rank, TP_RANKS, ref["prompts"], temporal, spatial,
                  timeout=900.0, collective_timeout=600.0)
    wall = time.perf_counter() - t0
    L, nl = cfg.llm, cfg.llm.num_layers
    n_clip = cfg.clip.num_layers + cfg.clip.feature_layer + 1
    nb = cfg.video.num_blocks_used
    h_llm, h_enc = L.num_heads // TP_RANKS, cfg.clip.num_heads // TP_RANKS
    fails = []
    label = f"{TP_RANKS} gloo ranks on one card, host-staged collectives"
    for r in ranks:
        devs = set(r["param_devices"]) | set(r["state_devices"]) | {
            r["feats_device"]} | {d for d, _ in r["caches"]}
        heads = {h for _, h in r["caches"]}
        first = int(r["tokens"][0]) == int(greedy[0])
        n = min(len(r["tokens"]), len(greedy))
        equal = int((r["tokens"][:n] == greedy[:n]).sum())
        lerr = rel_err(torch, r["logits"], ref["logits"])
        dl = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
        dg = abs(r["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
        t = r["serve_timings"]
        log(f"[tp] rank {r['rank']}: devices {sorted(devs)}; caches "
            f"{r['caches']} (want {L.num_kv_heads // TP_RANKS} kv heads); "
            f"sharded tree {r['param_gib']:.2f} GiB in {r['shard_s']:.2f} s")
        log(f"[tp] rank {r['rank']} serve bf16 B=1: first token equal "
            f"{first}, greedy tokens equal to the single process "
            f"{equal} of {n}; prefill logits rel L2 {lerr:.3e} (<= "
            f"{ROUTE_FLOOR_RATIO} x the re-batching drift {ref['drift']:.3e}"
            f"); encode_ms={t.get('encode', 0.0) * 1e3:.1f} prefill_ms="
            f"{t['prefill'] * 1e3:.1f} decode_ms={t['decode'] * 1e3:.1f} "
            f"({t['decode_steps']} steps) wall_s={r['serve_s']:.3f} "
            f"peak_device_memory={r['serve_peak_gib']:.2f} GiB; {label}; "
            f"{card}")
        log(f"[tp] rank {r['rank']} grounded step B=1 (under the profiler, "
            f"device kernels only): loss {r['loss']:.5f} "
            f"(single process {ref['loss']:.5f}, rel {dl:.3e} <= "
            f"{BOUND_TP_LOSS}) grad_norm {r['grad_norm']:.4f} (single "
            f"process {ref['grad_norm']:.4f}, rel {dg:.3e} <= "
            f"{BOUND_TP_GRAD_NORM}); step_s={r['step_s']:.3f} (single "
            f"process {ref['step_s']:.3f}) peak_device_memory="
            f"{r['step_peak_gib'][0]:.2f} GiB, {r['step_peak_gib'][1]:.2f} "
            f"allocated before the step (single process "
            f"{ref['peak_gib'][0]:.2f}, {ref['peak_gib'][1]:.2f}); {label}; "
            f"{card}")
        log(f"[tp] rank {r['rank']} launch shapes: serve "
            f"{r['serve_shapes']}; step {r['step_shapes']}")
        log(f"[tp] rank {r['rank']} device kernels of one step: "
            f"{r['step_kernels']}")
        want_serve = {"flash_fwd": per_req, "flash_bwd": 0}
        want_step = {"flash_fwd": n_clip + nb + 2 * nl, "flash_bwd": nl}
        heads_seen = {(k, s[2]) for k, s, _ in
                      [*r["serve_shapes"], *r["step_shapes"]]}
        want_heads = {("K1", h_enc), ("K2", h_llm), ("K7", h_llm)}
        checks = {
            "devices": devs == {"cuda:0"},
            "cache heads": heads == {L.num_kv_heads // TP_RANKS},
            "tokens between ranks": torch.equal(r["tokens"],
                                                ranks[0]["tokens"]),
            "first token": first,
            "prefill logits": lerr <= ROUTE_FLOOR_RATIO * ref["drift"],
            "loss": dl <= BOUND_TP_LOSS,
            "grad_norm": dg <= BOUND_TP_GRAD_NORM,
            "serve launches": r["serve_launches"] == want_serve,
            "step launches": r["step_launches"] == want_step,
            "head counts": heads_seen == want_heads,
            "step kernels": any("flash_bwd" in n for n in r["step_kernels"])
            and any("flash_fwd" in n for n in r["step_kernels"]),
        }
        fails += [f"rank {r['rank']}: {k}" for k, ok in checks.items()
                  if not ok]
    log(f"[path] J tensor split (1, 1, {TP_RANKS}) full-width phi3.5 bf16: "
        f"{len(ranks)} ranks in {wall:.1f} s (start, build, shard, serve, "
        f"step); {'OK' if not fails else 'FAIL ' + str(fails)}; {label}; "
        f"{card}")
    if fails:
        raise AssertionError(f"path J: {fails}")
    r0 = ranks[0]
    got = dict(zero)
    for c in (r0["serve_launches"], r0["step_launches"]):
        for k, v in c.items():
            got[k] += v
    return got


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

    t_start = time.perf_counter()

    def stamp(name):
        log(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s")

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
    stamp("build")

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
    stamp("kernels")

    frames = synthetic_video(SEED, cfg.num_frames)
    temporal, spatial, resize_ms = resize_phase(bf16, frames, card)

    # ---- 4. small references
    for quantize in (None, "int8", "int8_full"):
        small_reference(torch, cfg, SEED, quantize)
    small_reference_verify(torch, cfg, SEED, S_v)
    for quantize in (None, "int8_full"):
        small_reference_prefix(torch, cfg, SEED, quantize)
    small_reference_fused_iv2(torch, cfg, SEED, temporal)
    small_reference_static_iv2(torch, cfg, SEED, temporal)
    small_reference_quant_ab(torch, cfg, SEED)
    small_reference_train(torch, cfg, SEED)
    stamp("small references")

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
    greedy_bf16 = bf16.last_tokens[0].clone()

    full = InferenceEngine(params, cfg, tok, gen_int8, seed=SEED,
                           quantize="int8_full")
    got = run_path(torch, kernels, "A int8_full int8-cache B=6", generate(
        full, batch6, gen_int8), expect(per_req, 4 * nl, True, 1))
    launches = {k: launches[k] + got[k] for k in launches}
    t_a, tokens_a = dict(full.last_timings), full.last_tokens[0]
    # the phase profile at the JAX script's configuration on path A's tree,
    # obs/profiler's trace, the device preprocessing route
    phase_profile_phase(torch, kernels, full.params, cfg, card)
    trace_phase(torch, full.params, cfg)
    device_preprocess_phase(torch, frames, cfg, card)

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
    # the step graphs: each captured loop against the eager switch
    serving_graph_legs(torch, cfg, bf16, full, batch6, prompts, temporal,
                       spatial, card)
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
    stamp("paths A, D and the graph legs")

    # path E: path A with calibrated static W8A8 scales (one calibration
    # pass over the IV2 blocks at the first request: nb more K1 launches)
    got = static_path(torch, kernels, params, cfg, tok, gen_int8, batch6,
                      prompts, temporal, spatial, t_a,
                      expect(per_req + nb, 4 * nl, True, 1))
    launches = {k: launches[k] + got[k] for k in launches}
    stamp("path E")

    # path F: feature-cached and prefix-KV serving (mode A's configuration)
    got = prefix_path(torch, kernels, zero, params, cfg, tok, temporal,
                      spatial, per_req, card)
    launches = {k: launches[k] + got[k] for k in launches}
    stamp("path F")

    # path G: continuous batching and the HTTP server (mode A's tree)
    got = continuous_path(torch, kernels, zero, params, cfg, tok, temporal,
                          spatial, per_req, card)
    launches = {k: launches[k] + got[k] for k in launches}
    stamp("path G")

    # path H: the evaluation runner (mode A's tree), then beam search
    got, full = eval_path(torch, kernels, zero, params, cfg, tok, per_req,
                          card)
    launches = {k: launches[k] + got[k] for k in launches}
    got = beam_path(torch, kernels, zero, bf16, full, cfg, temporal, spatial,
                    greedy_bf16, per_req, card)
    launches = {k: launches[k] + got[k] for k in launches}
    stamp("path H and beams")
    del full
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
    del weight_only
    torch.cuda.empty_cache()
    stamp("paths A-H, B, C")

    # path J: tensor-split compute on two gloo ranks sharing the card
    got = tensor_path(torch, kernels, zero, params, cfg, tok, bf16,
                      greedy_bf16[0], temporal, spatial, per_req, card)
    launches = {k: launches[k] + got[k] for k in launches}
    del bf16
    torch.cuda.empty_cache()
    stamp("path J")

    # ---- 6. the training path, on the same bf16 weights; then path I:
    # the pretrain and sft stages on a 1-rank NCCL mesh
    got = train_path(torch, kernels, vlm_config("phi3.5", stage="grounded"),
                     params, tok, temporal, spatial)[0]
    launches = {k: launches[k] + got[k] for k in launches}
    stamp("train path")
    got = stage_path(torch, kernels, params, temporal, spatial, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build",
        "chip_smoke_stages"))
    launches = {k: launches[k] + got[k] for k in launches}
    stamp("path I")

    # ---- 7. the microbenchmarks: the path of M1, M2, M3 and M3d
    del params
    torch.cuda.empty_cache()
    got = microbench_path(torch, kernels, cfg, zero)
    launches = {k: launches[k] + got[k] for k in launches}
    stamp("microbenchmarks")

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
    stamp("llama3 and vicuna references, llama3 K2/K7")
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_checkpoints")
    roundtrip_phase(torch, os.path.join(scratch, "roundtrip"))
    stamp("round trip")
    got, params = llama3_path(torch, kernels, zero, generate, temporal,
                              spatial, resize_ms, card)
    launches = {k: launches[k] + got[k] for k in launches}
    stamp("llama3 path")

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
    stamp("llama3 training and reload")
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
