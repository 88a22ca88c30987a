"""Accuracy gate of the PyTorch port: the counterpart of the root eval.py,
with the same arguments plus --device.

It loads the reference checkpoints through cli/model_loading.build_params,
evaluates the requested benchmark through the serving engine
(serve/eval.py, serve/captioning.py) and prints the metric JSON on one line
(also written to --out). Without the weight files, and without
--allow_random_weights, it prints a "skipped" JSON and exits with code 2.

    python -m grounded_video_llm_tpu_torch.cli.eval --benchmark grounding \\
        --anno_format charades_sta --anno_path charades_sta_test.txt \\
        --video_root videos/ --pretrained_vision_proj_llm_path weights/phi/ \\
        --pretrained_video_path weights/internvideo2.pt \\
        --ckpt_path ckpt/sft_llava_next_video_phi3_mix_sft.pth \\
        --quantize int8_full --prefix_cache
    python -m grounded_video_llm_tpu_torch.cli.eval --debug_tiny \\
        --device cpu --allow_random_weights --anno_path anno.json \\
        --video_root videos/ --max_new_tokens 8

Annotation formats:
  json          — list of {video, query|question, start, end, ...} dicts
                  (serve/eval.py's schema; for captioning the
                  {video_id: {duration, timestamps, sentences}} dict)
  charades_sta  — the public "id start end##query" text format
  jsonl         — one native dict per line

It runs on one device (cuda by default). ``--quantize`` builds the LLM
directly in serving int8 (cli/model_loading.build_params), as the root
eval.py does, in the served tree and in the quantized leg of
``--quantize_ab``. ``run_benchmark`` takes an engine already built, so
other programs drive the same evaluation in-process.
``--static_scales`` needs the int8_full tree (``--quantize int8_full``, or
``--quantize_ab``, whose quantized leg defaults to it) and is refused when
the arguments are parsed otherwise; the root eval.py crashes in the A/B
and ignores the flag elsewhere.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--llm", default="phi3.5",
                   choices=["phi3.5", "llama3", "vicuna"])
    p.add_argument("--benchmark", default="grounding",
                   choices=["grounding", "gqa", "mc", "captioning"])
    p.add_argument("--anno_path", required=True)
    p.add_argument("--anno_format", default="json",
                   choices=["json", "jsonl", "charades_sta"])
    p.add_argument("--video_root", default="")
    p.add_argument("--pretrained_video_path", default="")
    p.add_argument("--pretrained_vision_proj_llm_path", default="")
    p.add_argument("--ckpt_path", default="")
    p.add_argument("--tokenizer_path", default="")
    p.add_argument("--quantize", default="",
                   choices=["", "int8", "int8_full"])
    p.add_argument("--quantize_ab", action="store_true",
                   help="instead of the benchmark, run the bf16-vs-quantized "
                        "accuracy A/B (logit KL + greedy token agreement) on "
                        "the first --ab_items eval items and enforce the "
                        "committed thresholds (serve/quant_ab.py); exits 1 "
                        "on failure")
    p.add_argument("--static_scales", action="store_true",
                   help="calibrate static W8A8 activation scales "
                        "(serve/calibrate.py, fc2+proj): on the first "
                        "request when serving, on the A/B items' own pixels "
                        "before the quant leg with --quantize_ab; needs the "
                        "int8_full tree")
    p.add_argument("--ab_items", type=int, default=4)
    p.add_argument("--ab_max_new_tokens", type=int, default=32)
    p.add_argument("--ab_max_kl", type=float, default=None)
    p.add_argument("--ab_min_top1", type=float, default=None)
    p.add_argument("--ab_min_greedy", type=float, default=None)
    p.add_argument("--max_items", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--num_frames", type=int, default=96)
    p.add_argument("--num_segs", type=int, default=12)
    p.add_argument("--prefix_cache", action="store_true",
                   help="also cache the shared prompt-head KV per video "
                        "(run_stream_prefix) on top of the feature cache")
    p.add_argument("--out", default="", help="also write metrics JSON here")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="skip the weights gate (synthetic smoke runs only)")
    p.add_argument("--debug_tiny", action="store_true",
                   help="micro model dims (CI smoke of the whole evaluation path)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu needs --debug_tiny in "
                        "practice)")
    args = p.parse_args(argv)
    if args.static_scales and quantize_mode(args) != "int8_full":
        p.error("--static_scales calibrates the W8A8 encoders of the "
                "int8_full tree: use it with --quantize int8_full (or with "
                "--quantize_ab and no other --quantize)")
    return args


def quantize_mode(args) -> str:
    """The tree the run serves or, with --quantize_ab, compares with bf16."""
    return args.quantize or ("int8_full" if args.quantize_ab else "")


def load_annotations(path: str, fmt: str):
    if fmt == "json":
        with open(path) as f:
            return json.load(f)
    if fmt == "jsonl":
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    # charades_sta: "VIDEOID START END##query sentence"
    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or "##" not in line:
                continue
            head, query = line.split("##", 1)
            vid, start, end = head.split()
            items.append({"video": vid + ".mp4", "query": query,
                          "start": float(start), "end": float(end)})
    return items


def weights_present(args) -> bool:
    """The gate: every weight source the reference load path uses
    (inference.py:137-162) must exist."""
    checks = [
        (args.ckpt_path, os.path.exists),
        (args.pretrained_video_path, os.path.exists),
        (args.pretrained_vision_proj_llm_path, os.path.isdir),
    ]
    return all(path and ok(path) for path, ok in checks)


def emit(result: dict, args) -> None:
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)


def _build(args, cfg, quantize=None):
    """The bf16 (fp32 with --debug_tiny) tree on --device, from the files
    that are given and seeded random otherwise; with quantize its LLM is
    built directly in serving int8 (cli/model_loading.build_params)."""
    import torch

    from .model_loading import build_params

    return build_params(
        cfg, torch.device(args.device),
        torch.float32 if args.debug_tiny else torch.bfloat16,
        weight_root=args.pretrained_vision_proj_llm_path or None,
        video_encoder_path=args.pretrained_video_path or None,
        stage_ckpt=args.ckpt_path or None, quantize=quantize)


def run_benchmark(engine, args) -> dict:
    """The benchmark of args on an engine already built → the result dict
    (benchmark, llm, quantize, n_items, metrics). The engine's own
    GenerateConfig and prefix_cache serve the requests."""
    from ..serve.captioning import eval_dense_captioning
    from ..serve.eval import eval_gqa, eval_grounding, eval_multiple_choice

    annos = load_annotations(args.anno_path, args.anno_format)
    runner = {"grounding": eval_grounding, "gqa": eval_gqa,
              "mc": eval_multiple_choice,
              # ActivityNet-Captions SODA_c/METEOR (reference README.md:31-34)
              # — annotations are the official {video_id: {duration,
              # timestamps, sentences}} val json (use --anno_format json)
              "captioning": eval_dense_captioning}[args.benchmark]
    metrics = runner(engine, annos, video_root=args.video_root,
                     max_items=args.max_items, batch_size=args.batch_size)
    return {
        "benchmark": args.benchmark,
        "llm": args.llm,
        "quantize": args.quantize or "bf16",
        "n_items": min(len(annos), args.max_items or len(annos)),
        "metrics": metrics,
    }


def run_quantize_ab(args, cfg) -> int:
    """bf16-vs-quantized accuracy A/B on the eval items (serve/quant_ab.py).
    Sequential memory protocol: the bf16 tree is built and its leg moved to
    the host first, then freed, then the quantized tree is built — needed
    where both trees do not fit the card together."""
    import gc

    import torch

    from ..serve import quant_ab
    from ..serve.calibrate import calibrate_and_apply
    from ..serve.engine import InferenceEngine
    from ..serve.quantize import (quantize_clip_for_serving,
                                  quantize_video_encoder_for_serving)
    from .model_loading import build_tokenizer

    quant = quantize_mode(args)
    tokenizer = build_tokenizer(cfg, args.tokenizer_path or None, expand=True)
    holder = {"p": _build(args, cfg)}
    engine = InferenceEngine(holder["p"], cfg, tokenizer,
                             device=torch.device(args.device))
    annos = load_annotations(args.anno_path, args.anno_format)
    items = annos[:args.ab_items]
    mode = {"grounding": "grounding", "gqa": "grounding",
            "mc": "qa", "captioning": "grounding"}[args.benchmark]
    ids, mask, spatial, temporal = quant_ab.prepare_ab_inputs(
        engine, items, args.video_root, mode)

    def free_bf16():
        engine.params = None
        holder.clear()
        gc.collect()
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()

    def build_quant():
        # the tree int8 / int8_full serves: the LLM built in int8, the W8A8
        # encoders for int8_full, then the static scales
        p2 = _build(args, cfg, quant)
        if quant == "int8_full":
            p2 = dict(p2, video_encoder=quantize_video_encoder_for_serving(
                p2["video_encoder"]), clip=quantize_clip_for_serving(
                    p2["clip"]))
        if args.static_scales:
            p2 = calibrate_and_apply(p2, cfg, [temporal])
        return p2

    thr = {}
    if args.ab_max_kl is not None:
        thr["max_kl"] = args.ab_max_kl
    if args.ab_min_top1 is not None:
        thr["min_top1"] = args.ab_min_top1
    if args.ab_min_greedy is not None:
        thr["min_greedy"] = args.ab_min_greedy
    report = quant_ab.run_quant_ab(
        holder["p"], build_quant, cfg, ids, mask, spatial, temporal,
        max_new_tokens=args.ab_max_new_tokens,
        eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id, free_bf16=free_bf16, **thr)
    emit({"mode": "quantize_ab", "llm": args.llm, "quantize": quant,
          "static_scales": bool(args.static_scales), "n_items": len(items),
          "report": report}, args)
    return 0 if report["pass"] else 1


def main(argv=None) -> int:
    args = parse_args(argv)
    if not weights_present(args) and not args.allow_random_weights:
        print(json.dumps({
            "status": "skipped",
            "reason": "reference checkpoints not present on disk",
            "required": {
                "ckpt_path": args.ckpt_path or "(unset)",
                "pretrained_video_path":
                    args.pretrained_video_path or "(unset)",
                "pretrained_vision_proj_llm_path":
                    args.pretrained_vision_proj_llm_path or "(unset)",
            }}))
        return 2

    import torch

    from ..core.config import GenerateConfig, micro_vlm_config, vlm_config
    from ..serve.engine import InferenceEngine
    from .model_loading import build_tokenizer

    cfg = (micro_vlm_config(args.llm) if args.debug_tiny
           else vlm_config(args.llm, stage="inference",
                           num_frames=args.num_frames,
                           num_segs=args.num_segs))
    if args.quantize_ab:
        return run_quantize_ab(args, cfg)
    tokenizer = build_tokenizer(cfg, args.tokenizer_path or None, expand=True)
    engine = InferenceEngine(
        _build(args, cfg, args.quantize or None), cfg, tokenizer,
        GenerateConfig(max_new_tokens=args.max_new_tokens, do_sample=False,
                       temperature=0.0),
        device=torch.device(args.device), quantize=args.quantize or None,
        prefix_cache=args.prefix_cache, static_scales=args.static_scales)
    emit(run_benchmark(engine, args), args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
