#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (grounded_video_llm_tpu_torch) on one
NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py            # full run, one card, exits 0 on success

Phases, each printed on its own lines; any failure raises (exit code != 0):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the flash-attention kernel build (nvcc, from csrc/ in this checkout);
3. kernel vs its plain PyTorch version, bf16 inputs, at the serving path's
   shapes: CLIP [12,577,16,64], InternVideo2 [12,2049,16,88] bounded, the
   prefill [1,S,32,96] causal with a keep-mask (S = the engine's own prompt
   length), and a B=2 left-padded causal case that must show dead rows
   (o == 0, lse == +inf). Max |do|, relative L2 of do and max |dlse|
   against their bounds and the median times of both from CUDA events;
4. a small-input reference: a depth-cut full-width model, bf16 on the card
   (kernel path) against the same weights in fp32 on the host (plain path):
   video features, prefill logits and one decode step's logits;
5. the main path: full-width Phi-3.5 bf16 InferenceEngine (seeded random
   weights, vlm_config("phi3.5", stage="inference"): 96 frames, 3,420 video
   tokens) on a seeded synthetic uint8 video, three requests (grounding, qa,
   referring), greedy, 32 new tokens. Per request: text, intervals, phase
   times, the kernel launch count (23 CLIP + 39 InternVideo2 + 32 prefill);
   then peak device memory and a shape/finiteness check of the encoder
   features and prefill logits.

The last two lines are one JSON object describing the kernels and one
JSON object {"ok": true, "device": {...}}. Without a CUDA device the script
exits with code 2 and prints no result.
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
BOUND_SMALL = 3e-2  # relative L2, bf16 card path vs fp32 host path
REPLACES = ("grounded_video_llm_tpu/ops/flash_attention.py:53 (_fwd_kernel) "
            "+ :140 (_fwd_kernel_causal), pallas_call at :299")
SOURCE = "grounded_video_llm_tpu_torch/csrc/flash_fwd.cu"
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


def check_kernel(torch, fa, name, B, Sq, H, D, *, Sk=None, Hkv=None,
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
    ms = cuda_ms(torch, kernel, 20) if timed else float("nan")
    plain_ms = cuda_ms(torch, plain, 5) if timed else float("nan")
    log(f"[kernel] {name:<22} q={[B, Sq, H, D]} kv={[B, Sk, Hkv, D]} "
        f"causal={causal} bounded={bounded} window={window} "
        f"dead_rows={n_dead} max|do|={d_o:.3e} (<= {BOUND_O}) "
        f"rel|do|={r_o:.3e} (<= {BOUND_O_REL}) "
        f"max|dlse|={d_lse:.3e} (<= {BOUND_LSE})"
        + (f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}" if timed else "")
        + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    if (n_dead > 0) != expect_dead:
        raise AssertionError(f"{name}: {n_dead} dead rows, expected "
                             f"{'some' if expect_dead else 'none'}")
    del q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return {"max_abs_err": d_o, "max_lse_err": d_lse, "ms": ms,
            "plain_ms": plain_ms}


def check_kernel_edges(torch, fa):
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
        check_kernel(torch, fa, name, seed=100 + i, timed=False, **kw)


def rel_err(torch, a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def small_reference(torch, cfg_full, seed):
    """Depth-cut full-width model: card (bf16, kernel) vs host (fp32, plain
    version), same weights, same frames and prompt."""
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
    p_gpu = build_params(cfg, "cuda", torch.bfloat16, seed)

    def to_host(tree):
        if isinstance(tree, dict):
            return {k: to_host(v) for k, v in tree.items()}
        return tree.float().cpu()

    p_cpu = to_host(p_gpu)
    tok = build_tokenizer(cfg)
    eng = InferenceEngine(p_gpu, cfg, tok)
    temporal, spatial = eng.preprocess_frames(synthetic_video(seed + 1, n_frames))
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
            cache = llm.KVCache.create(cfg.llm, 1, S + 8, dtype=embeds.dtype,
                                       device=dev)
            logits, cache = llm.prefill(lp, cfg.llm, embeds, m, cache)
            # one decode step on the same token: bf16 cache and lm_head
            # products with fp32 results on the card, fp32 on the host
            if next_tok is None:
                next_tok = int(logits.argmax(-1)[0])
            valid = torch.zeros(1, S + 8, dtype=torch.bool, device=dev)
            valid[:, :S] = True
            tok = torch.tensor([next_tok], device=dev)
            step_logits, _, _ = llm.decode_step(
                lp, cfg.llm, llm.embed_lookup(lp["embed"], tok)[:, None],
                cache, valid, torch.tensor([S], device=dev))
        if step_logits.dtype != torch.float32:
            raise AssertionError(f"decode logits are {step_logits.dtype}")
        outs[dev] = (feats, logits, step_logits)
    errs = [rel_err(torch, outs["cuda"][i], outs["cpu"][i]) for i in range(3)]
    ok = max(errs) <= BOUND_SMALL
    log(f"[small-ref] depth-cut full width (CLIP 2 of 3 layers, IV2 2 "
        f"blocks, LLM 2 layers, 1 segment), card bf16 vs host fp32, rel L2: "
        f"video features {errs[0]:.3e}, prefill logits {errs[1]:.3e}, "
        f"decode-step logits {errs[2]:.3e} (<= {BOUND_SMALL}) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("card path disagrees with the host reference")
    del p_gpu, p_cpu, eng, outs
    torch.cuda.empty_cache()


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
    from grounded_video_llm_tpu_torch.ops import flash_attention as fa
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

    # ---- 2. kernel build
    t0 = time.perf_counter()
    fa.FLASH_FWD.function()
    log(f"[build] flash_fwd.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {fa.FLASH_FWD.build_seconds}"
        f" s) -> {fa.FLASH_FWD.library_path()}")
    for line in fa.FLASH_FWD.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[ptxas] {line.strip()}")

    cfg = vlm_config("phi3.5", stage="inference")
    tok = build_tokenizer(cfg)
    gen_cfg = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS,
                             do_sample=False)

    # ---- small-input reference (before the full model takes the card)
    small_reference(torch, cfg, SEED)

    # ---- 3. kernel vs plain version at the path's shapes
    t0 = time.perf_counter()
    params = build_params(cfg, "cuda", torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    log(f"[params] full-width phi3.5 bf16 built on the card in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    engine = InferenceEngine(params, cfg, tok, gen_cfg, seed=SEED)
    duration = 96.0
    # the engine's own prefill length for the first request
    S_pre = (len(engine.tokenize_prompt(engine.build_prompt(
        MODES[0][1], MODES[0][0], duration))) - 1 + cfg.num_video_tokens)
    heads = cfg.llm.num_heads
    per_req = {"clip": cfg.clip.num_layers + cfg.clip.feature_layer + 1,
               "iv2": cfg.video.num_blocks_used,
               "prefill": cfg.llm.num_layers}
    res = {
        "clip": check_kernel(torch, fa, "clip", 12, cfg.clip.num_patches + 1,
                             cfg.clip.num_heads, cfg.clip.head_dim, seed=1),
        "iv2": check_kernel(torch, fa, "internvideo2_bounded", 12,
                            cfg.video.seq_len, cfg.video.num_heads,
                            cfg.video.head_dim, bounded=True, seed=2),
        "prefill": check_kernel(torch, fa, "prefill_causal", 1, S_pre, heads,
                                cfg.llm.head_dim, causal=True, pads=(0,),
                                seed=3),
        "leftpad": check_kernel(torch, fa, "leftpad_causal_b2", 2, 1000,
                                heads, cfg.llm.head_dim, causal=True,
                                pads=(0, 237), expect_dead=True, seed=4),
    }
    check_kernel_edges(torch, fa)
    # attention time per request at the main path's shapes and counts
    req_ms = sum(res[k]["ms"] * n for k, n in per_req.items())
    req_plain_ms = sum(res[k]["plain_ms"] * n for k, n in per_req.items())
    log(f"[kernel] attention per request ({per_req}): kernel "
        f"{req_ms:.3f} ms, plain {req_plain_ms:.3f} ms")
    max_err = max(r["max_abs_err"] for r in res.values())

    # ---- 5. main path: three requests through the engine
    frames = synthetic_video(SEED, cfg.num_frames)
    expect = sum(per_req.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.FLASH_FWD.launches = 0
    per_request = []
    for mode, prompt in MODES:
        before = fa.FLASH_FWD.launches
        r = engine.run_frames(frames, duration, prompt, mode)
        n = fa.FLASH_FWD.launches - before
        t = engine.last_timings
        steps = max(t["new_tokens"] - 1, 1)
        log(f"[request] mode={mode} prompt_tokens={t['prompt_len']} "
            f"prefill_len={t['prompt_len'] - 1 + cfg.num_video_tokens} "
            f"new_tokens={t['new_tokens']}")
        log(f"[request]   text={r.text!r}")
        log(f"[request]   parsed={r.parsed!r} intervals={r.intervals}")
        log(f"[request]   preprocess_ms={t['preprocess'] * 1e3:.1f} "
            f"encode_ms={t['encode'] * 1e3:.1f} "
            f"prefill_ms={t['prefill'] * 1e3:.1f} "
            f"decode_ms={t['decode'] * 1e3:.1f} "
            f"decode_ms_per_token={t['decode'] * 1e3 / steps:.2f} "
            f"flash_launches={n} (expected {expect})")
        per_request.append(n)
    launches = fa.FLASH_FWD.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] flash_fwd launches: {per_request}, total {launches}; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    if per_request != [expect] * len(MODES):
        raise AssertionError(f"flash_fwd launched {per_request} times, "
                             f"expected {expect} per request")

    # outputs of the main path: right shapes, finite
    temporal, spatial = engine.preprocess_frames(frames)
    ids = engine.tokenize_prompt(engine.build_prompt(MODES[0][1], "grounding",
                                                     duration))
    with torch.inference_mode():
        feats = vlm.encode_video(
            params, cfg, torch.from_numpy(spatial[None]).cuda(),
            torch.from_numpy(temporal[None]).cuda())
        input_ids = torch.tensor([ids], device="cuda")
        embeds, _, m = vlm.splice_multimodal(
            input_ids, None, torch.ones_like(input_ids), feats,
            params["llm"]["embed"])
        cache = llm.KVCache.create(cfg.llm, 1, embeds.shape[1] + 128,
                                   device="cuda")
        logits, cache = llm.prefill(params["llm"], cfg.llm, embeds, m, cache)
    want_f = (1, cfg.num_video_tokens, cfg.llm.hidden_size)
    want_l = (1, cfg.llm.padded_vocab_size)
    good = (tuple(feats.shape) == want_f and tuple(logits.shape) == want_l
            and bool(torch.isfinite(feats).all())
            and bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(cache.k).all()))
    log(f"[main] video features {tuple(feats.shape)} (want {want_f}), "
        f"prefill logits {tuple(logits.shape)} (want {want_l}), finite: "
        f"{good}")
    if not good:
        raise AssertionError("main path outputs are malformed")

    kernels = {"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": req_ms, "plain_ms": req_plain_ms}]}
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
