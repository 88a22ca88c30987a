"""Phase attribution on one GPU: where does a request's device time go?
(counterpart of scripts/phase_profile.py in the JAX package)

    python -m grounded_video_llm_tpu_torch.cli.phase_profile [--out FILE]

Builds full-width Phi-3.5 bf16 with seeded random weights
(``vlm_config("phi3.5", stage="inference")``), serves one warm-up grounding
request on a seeded random 96-frame video, then runs each stage of that
request alone, unprofiled (median of 3) and then once under torch.profiler:

  encode   vlm.encode_video (CLIP + InternVideo2 + projectors)
  prefill  llm.prefill at the spliced length, into a fresh KV cache
  decode   the greedy decode loop of generate, DECODE_STEPS steps

Per stage it prints the wall time (host clock, device synchronised) with
and without the profiler, the device time (sum of kernel times), the
device's idle share of the unprofiled wall time (the profiler slows the
host), the kernel count, the device
time by kernel family (flash attention, GEMM/GEMV, elementwise and
reductions, other) and the top kernels. ``--out`` writes every kernel.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.config import GenerateConfig, vlm_config
from ..models import llm, vlm
from ..serve import generate
from ..serve.engine import InferenceEngine
from .model_loading import build_params, build_tokenizer

SEED = 0
DECODE_STEPS = 16
PROMPT = ("Give you a textual query: 'The female host wearing purple clothes "
          "is reporting news in the studio'. When does the described content "
          "occur in the video? Please return the start and end timestamps.")
FAMILIES = (
    ("flash_fwd", ("flash_fwd",)),
    ("gemm", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")),
    ("elementwise", ("elementwise", "reduce", "copy", "softmax", "index",
                     "cat", "where")),
)


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


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_stage(name: str, fn, per: int, wall: float,
                  out_lines: list) -> None:
    """Profile one run of fn; wall is its unprofiled time in ms."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_prof = _wall_ms(fn)
    rows = _device_entries(prof)
    if not rows:
        raise RuntimeError(f"{name}: the profiler recorded no device time")
    dev_ms = sum(r[2] for r in rows) / 1e3
    kernels = sum(r[1] for r in rows)
    fams: dict = {}
    for key, _, us in rows:
        fams[_family(key)] = fams.get(_family(key), 0.0) + us / 1e3
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
    out_lines.append(f"== {name}: device {dev_ms:.3f} ms, wall {wall:.3f} "
                     f"ms, profiled wall {wall_prof:.3f} ms")
    out_lines += [f"{us / 1e3:10.4f} ms {count:7d}x  {_family(key):<11} {key}"
                  for key, count, us in rows]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write every kernel of every stage here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_profile: needs a CUDA device")

    cfg = vlm_config("phi3.5", stage="inference")
    params = build_params(cfg, "cuda", torch.bfloat16, seed=SEED)
    engine = InferenceEngine(params, cfg, build_tokenizer(cfg),
                             GenerateConfig(max_new_tokens=32,
                                            do_sample=False), seed=SEED)
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (cfg.num_frames, 240, 320, 3), np.uint8)
    engine.run_frames(frames, 96.0, PROMPT, "grounding")          # warm-up

    temporal, spatial = engine.preprocess_frames(frames)
    ids = engine.tokenize_prompt(engine.build_prompt(PROMPT, "grounding",
                                                     96.0))
    with torch.inference_mode():
        sp = torch.from_numpy(spatial[None]).cuda()
        tp = torch.from_numpy(temporal[None]).cuda()
        feats = vlm.encode_video(params, cfg, sp, tp)
        input_ids = torch.tensor([ids], device="cuda")
        embeds, _, mask = vlm.splice_multimodal(
            input_ids, None, torch.ones_like(input_ids), feats,
            params["llm"]["embed"])
        S = embeds.shape[1]
        max_len = -(-(S + DECODE_STEPS + 1) // 128) * 128

        def prefill():
            cache = llm.KVCache.create(cfg.llm, 1, max_len, device="cuda")
            return llm.prefill(params["llm"], cfg.llm, embeds, mask, cache)

        logits, cache = prefill()
        valid0 = torch.zeros(1, max_len, dtype=torch.bool, device="cuda")
        valid0[:, :S] = True
        pos0 = mask.sum(dim=-1).to(torch.int32)

        def decode():
            # the prompt's slots stay valid; each run rewrites the same slots
            return generate._decode_loop(
                params, cfg, logits, cache, valid0, pos0, None,
                max_new_tokens=DECODE_STEPS + 1, temperature=0.0, top_p=None,
                do_sample=False, eos_token_id=-1, pad_token_id=0)

        stages = [("encode", lambda: vlm.encode_video(params, cfg, sp, tp), 1),
                  (f"prefill S={S}", prefill, 1),
                  (f"decode {DECODE_STEPS} steps", decode, DECODE_STEPS)]
        # every unprofiled time (median of 3 after a warm run) is taken
        # before the first profiler session of the process
        walls = []
        for _, fn, _ in stages:
            fn()
            walls.append(float(np.median([_wall_ms(fn) for _ in range(3)])))
        out_lines: list = [torch.cuda.get_device_name(0)]
        for (name, fn, per), wall in zip(stages, walls):
            profile_stage(name, fn, per, wall, out_lines)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(out_lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
