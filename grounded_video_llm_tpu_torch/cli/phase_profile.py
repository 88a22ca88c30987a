"""Phase attribution on one GPU: where does the serving configuration's
device time go? (counterpart of scripts/phase_profile.py in the JAX package)

    python -m grounded_video_llm_tpu_torch.cli.phase_profile \\
        [--batch 6] [--stages internvideo2,clip,encode,prefill,decode] \\
        [--llm phi3.5|llama3] [--quantize int8_full|int8|bf16] [--out FILE]

Builds the full-width model (``vlm_config(llm, stage="inference")``) with
seeded random weights through cli/model_loading.build_params(quantize=):
``int8_full`` (the default; the JAX script's PHASE_QUANT_ENC=1, bench.py's
serving mode) builds the LLM in int8 marked w8a8 and quantizes both
encoders for W8A8; ``int8`` (PHASE_QUANT_ENC=0) a weight-only int8 LLM and
bf16 encoders; ``bf16`` the bf16 tree. It then runs each stage at the JAX
script's shapes, on seeded random inputs:

  internvideo2  the InternVideo2 trunk alone on B·num_segs clips
  clip          the CLIP ViT alone on B·num_segs frames at 336
  encode        vlm.encode_video of B videos (uint8 pixels normalized on
                the device, both encoders, fusion and projectors)
  prefill       llm.prefill of B rows of 63 + num_video_tokens tokens into
                a fresh cache of that length + 64 slots (int8 when the LLM
                is int8, as the JAX script's; bf16 otherwise)
  decode        DECODE_STEPS llm.decode_step calls from that prefill

Each stage runs once to warm up, then 3 times unprofiled (timed by
obs/profiler.PhaseTimer with a device barrier; the median is the stage's
wall time), then once under torch.profiler inside an obs/profiler.annotate
region. Per stage it prints the wall time with and without the profiler,
the device time (sum of kernel times), the device's idle share of the
unprofiled wall time (the profiler slows the host), the kernel count, the
device time by kernel family (flash attention, the port's int8 decode
products, GEMM/GEMV, elementwise and reductions, other) and the top
kernels. ``--out`` writes every kernel. ``build_stages`` builds the stages
on a tree a caller already holds (chip_smoke.py, the tests).
"""

from __future__ import annotations

import argparse
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import VLMConfig, vlm_config
from ..models import clip_vit, internvideo2, llm, vlm
from ..obs.profiler import PhaseTimer, annotate, sync
from ..ops.int8_matmul import Int8Embedding
from ..ops.preprocess import (INTERNVIDEO_MEAN, INTERNVIDEO_STD,
                              OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)
from ..serve.quantize import (quantize_clip_for_serving,
                              quantize_video_encoder_for_serving)
from .model_loading import build_params

SEED = 0
STAGES = ("internvideo2", "clip", "encode", "prefill", "decode")
DECODE_STEPS = 32
# the JAX script's prompt: 64 tokens, one of them the video slot
PROMPT_TOKENS = 64
CACHE_MARGIN = 64
FAMILIES = (
    ("flash_fwd", ("flash_fwd",)),
    ("int8_decode", ("int8_mm_kernel",)),
    ("int8_attention", ("attention_kernel", "scatter_kernel")),
    ("gemm", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")),
    ("elementwise", ("elementwise", "reduce", "copy", "softmax", "index",
                     "cat", "where")),
)


class Stage(NamedTuple):
    name: str           # the stage's name in STAGES
    label: str          # printed: the name with its shape
    fn: Callable        # one run of the stage → its output
    per: int            # units of work in one run (clips, rows, steps)
    probe: torch.Tensor  # a tensor on the stage's device (barriers)


def build_tree(cfg: VLMConfig, quantize: str, device,
               dtype=torch.bfloat16) -> dict:
    """The seeded serving tree of one --quantize mode."""
    if quantize not in ("int8_full", "int8", "bf16"):
        raise ValueError(f"quantize={quantize!r}: expected int8_full, int8 "
                         "or bf16")
    params = build_params(cfg, device, dtype, seed=SEED,
                          quantize=None if quantize == "bf16" else quantize)
    if quantize == "int8_full":
        params["video_encoder"] = quantize_video_encoder_for_serving(
            params["video_encoder"])
        params["clip"] = quantize_clip_for_serving(params["clip"])
    return params


def build_stages(params, cfg: VLMConfig, batch: int, stages=STAGES, *,
                 decode_steps: int = DECODE_STEPS) -> List[Stage]:
    """The stages of ``stages`` (in STAGES order) on the tree params, with
    their inputs made on the tree's device. The decode stage's prefill
    runs here, once. An int8 LLM prefills and decodes on the int8 cache."""
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        raise ValueError(f"unknown stages {unknown}; expected some of "
                         f"{STAGES}")
    lp = params["llm"]
    emb = lp["embed"]
    int8_llm = isinstance(emb, Int8Embedding)
    device = (emb.q if int8_llm else emb).device
    act = llm.embed_dtype(emb)
    enc = params["clip"]["embeddings"]["patch_kernel"].dtype
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    clips = batch * cfg.num_segs

    def pixels(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, generator=g,
                             device=device)

    out: List[Stage] = []
    if "internvideo2" in stages:
        tp = vlm._maybe_normalize(
            pixels(clips, cfg.num_frames_per_seg, 224, 224, 3),
            INTERNVIDEO_MEAN, INTERNVIDEO_STD, enc)
        out.append(Stage("internvideo2", f"internvideo2 {clips} clips",
                         lambda: internvideo2.features(
                             params["video_encoder"], cfg.video, tp),
                         clips, tp))
    if "clip" in stages:
        sp = vlm._maybe_normalize(pixels(clips, 336, 336, 3),
                                  OPENAI_DATASET_MEAN, OPENAI_DATASET_STD,
                                  enc)
        out.append(Stage("clip", f"clip {clips} frames",
                         lambda: clip_vit.features(params["clip"], cfg.clip,
                                                   sp), clips, sp))
    if "encode" in stages:
        sp_b = pixels(batch, cfg.num_segs, 336, 336, 3)
        tp_b = pixels(batch, cfg.num_frames, 224, 224, 3)
        out.append(Stage("encode", f"encode B={batch}",
                         lambda: vlm.encode_video(params, cfg, sp_b, tp_b),
                         batch, sp_b))
    if "prefill" in stages or "decode" in stages:
        S = PROMPT_TOKENS - 1 + cfg.num_video_tokens
        max_len = S + CACHE_MARGIN
        embeds = (torch.randn(batch, S, cfg.llm.hidden_size, generator=g,
                              device=device) * 0.1).to(act)
        mask = torch.ones(batch, S, dtype=torch.int32, device=device)

        def prefill():
            rcfg = llm.rank_config(lp, cfg.llm)
            cache = (llm.QuantKVCache.create(rcfg, batch, max_len,
                                             device=device) if int8_llm
                     else llm.KVCache.create(rcfg, batch, max_len,
                                             dtype=act, device=device))
            return llm.prefill(lp, cfg.llm, embeds, mask, cache)

        cache_kind = "int8" if int8_llm else str(act).replace("torch.", "")
        if "prefill" in stages:
            out.append(Stage("prefill", f"prefill B={batch} S={S} "
                             f"{cache_kind} cache", prefill, batch, embeds))
    if "decode" in stages:
        _, cache = prefill()
        valid0 = torch.zeros(batch, max_len, dtype=torch.bool, device=device)
        valid0[:, :S] = True
        pos0 = torch.full((batch,), S, dtype=torch.int32, device=device)
        tok = (torch.randn(batch, 1, cfg.llm.hidden_size, generator=g,
                           device=device) * 0.1).to(act)

        def decode():
            # every run rewrites the same slots from the same prefill
            valid, logits = valid0.clone(), None
            for i in range(decode_steps):
                logits, _, valid = llm.decode_step(lp, cfg.llm, tok, cache,
                                                   valid, pos0 + i)
            return logits

        out.append(Stage("decode", f"decode B={batch} {decode_steps} steps "
                         f"{cache_kind} cache", decode, decode_steps, tok))
    return out


def time_stages(stages: List[Stage], *, warm: int = 1,
                repeats: int = 3) -> List[float]:
    """Each stage's median wall time in ms over ``repeats`` unprofiled runs
    after ``warm`` runs (obs/profiler.PhaseTimer, a device barrier at the
    end of each run)."""
    walls = []
    for st in stages:
        for _ in range(warm):
            st.fn()
        sync(st.probe)
        runs = []
        for _ in range(repeats):
            timer = PhaseTimer()
            with timer.phase(st.name, barrier_on=st.probe):
                st.fn()
            runs.append(timer.totals[st.name] * 1e3)
        walls.append(float(np.median(runs)))
    return walls


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _device_entries(prof):
    """(name, calls, device µs) of every kernel the profiler saw."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us > 0:
            rows.append((e.key, e.count, us))
    return sorted(rows, key=lambda r: -r[2])


def profile_stage(st: Stage, wall: float, out_lines: list,
                  counters: Optional[dict] = None) -> dict:
    """Profile one run of a stage whose unprofiled time is wall ms, print
    its lines → {"device_ms", "kernels", "families", "rows", "launches"}
    (launches: each counter's launches in the profiled run, where the
    caller gives the kernels' wrappers by name)."""
    # CUDA activity alone: the kernels are what the lines read, and CPU ops
    # would triple the events the profiler processes (a 32-step decode at
    # B=6 launches ~48k kernels)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for k in (counters or {}).values():
        k.launches = 0
    sync(st.probe)
    timer = PhaseTimer()
    with torch.profiler.profile(activities=acts) as prof:
        with timer.phase(st.name, barrier_on=st.probe), annotate(st.label):
            st.fn()
    wall_prof = timer.totals[st.name] * 1e3
    launches = {n: k.launches for n, k in (counters or {}).items()}
    # the annotate region's own device span covers the kernels in it
    rows = [r for r in _device_entries(prof) if r[0] != st.label]
    if not rows:
        raise RuntimeError(f"{st.label}: the profiler recorded no device "
                           "time")
    dev_ms = sum(r[2] for r in rows) / 1e3
    kernels = sum(r[1] for r in rows)
    fams: dict = {}
    for key, _, us in rows:
        fams[_family(key)] = fams.get(_family(key), 0.0) + us / 1e3
    name, per = st.label, st.per
    print(f"[{name}] wall {wall:.3f} ms (profiled {wall_prof:.3f} ms), "
          f"device {dev_ms:.3f} ms, idle {1 - dev_ms / wall:.1%}, "
          f"{kernels} kernels; per unit of {per}: wall "
          f"{wall / per:.3f} ms, device {dev_ms / per:.3f} ms, "
          f"{kernels / per:.1f} kernels", flush=True)
    print(f"[{name}]   by family: " + ", ".join(
        f"{f} {ms:.3f} ms ({ms / dev_ms:.1%})"
        for f, ms in sorted(fams.items(), key=lambda kv: -kv[1])))
    for key, count, us in rows[:8]:
        print(f"[{name}]   {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
    if launches:
        print(f"[{name}]   launches {launches}")
    out_lines.append(f"== {name}: device {dev_ms:.3f} ms, wall {wall:.3f} "
                     f"ms, profiled wall {wall_prof:.3f} ms")
    out_lines += [f"{us / 1e3:10.4f} ms {count:7d}x  {_family(key):<14} "
                  f"{key}" for key, count, us in rows]
    return {"device_ms": dev_ms, "kernels": kernels, "families": fams,
            "rows": rows, "launches": launches, "wall_ms": wall,
            "profiled_wall_ms": wall_prof}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="comma-separated, of " + ", ".join(STAGES))
    ap.add_argument("--llm", default="phi3.5", choices=["phi3.5", "llama3"])
    ap.add_argument("--quantize", default="int8_full",
                    choices=["int8_full", "int8", "bf16"])
    ap.add_argument("--out", help="write every kernel of every stage here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("phase_profile: needs a CUDA device")

    cfg = vlm_config(args.llm, stage="inference")
    params = build_tree(cfg, args.quantize, "cuda")
    print(f"{torch.cuda.get_device_name(0)}: {args.llm} {args.quantize} "
          f"batch={args.batch}, {torch.cuda.memory_allocated() / 2**30:.2f}"
          " GiB of weights", flush=True)
    with torch.inference_mode():
        stages = build_stages(params, cfg, args.batch,
                              args.stages.split(","))
        # every unprofiled time is taken before the process first runs the
        # profiler
        walls = time_stages(stages)
        out_lines: list = [torch.cuda.get_device_name(0)]
        for st, wall in zip(stages, walls):
            profile_stage(st, wall, out_lines)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(out_lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
