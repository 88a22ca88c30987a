"""Single-video inference CLI of the PyTorch port (the counterpart of the
root inference.py, with the same arguments plus --device).

Runs the three demo modes (grounding, video QA, referring) on one video
through serve/engine.InferenceEngine and prints the raw and parsed
generations:

    python -m grounded_video_llm_tpu_torch.cli.inference \\
        --video_path ./experiments/video0.mp4 --quantize int8_full \\
        --spec_draft_len 4 --no-do_sample
    python -m grounded_video_llm_tpu_torch.cli.inference --debug_tiny \\
        --device cpu --video_path clip.mp4 --max_new_tokens 8

It runs on one device (cuda by default; --debug_tiny on the CPU needs
--device cpu). --pretrained_vision_proj_llm_path (the weight dumps' dir),
--pretrained_video_path (the InternVideo2 .pt) and --ckpt_path (a stage
checkpoint) load through cli/model_loading.build_params; what they do not
give is seeded random at the config's width.
"""

from __future__ import annotations

import argparse
import random

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--model", type=str, default="llava_next_video",
                        choices=["llava_next_video"])
    parser.add_argument("--llm", type=str, default="phi3.5",
                        choices=["llama3", "vicuna", "phi3.5"])
    parser.add_argument("--stage", type=str, default="sft",
                        choices=["pretrain", "grounded", "sft"])
    parser.add_argument("--max_txt_len", type=int, default=2048)
    parser.add_argument("--num_temporal_tokens", type=int, default=300)
    parser.add_argument("--num_frames", type=int, default=96)
    parser.add_argument("--num_segs", type=int, default=12)
    parser.add_argument("--tokenizer_path", type=str, default="")
    parser.add_argument("--pretrained_video_path", type=str, default="")
    parser.add_argument("--pretrained_vision_proj_llm_path", type=str,
                        default="")
    parser.add_argument("--ckpt_path", type=str, default="")
    parser.add_argument("--prompt_grounding", type=str,
                        default="Give you a textual query: 'The female host "
                        "wearing purple clothes is reporting news in the "
                        "studio'. When does the described content occur in "
                        "the video? Please return the start and end "
                        "timestamps.")
    parser.add_argument("--prompt_videoqa", type=str,
                        default="Question: What does this TV news report "
                        "about?\nOptions:\n(A) thievery\n(B) community "
                        "violence incidents\n(C) fashion show\n(D) aging "
                        "population")
    parser.add_argument("--prompt_referring", type=str,
                        default="What is happening from 70 seconds to 80 "
                        "seconds?")
    parser.add_argument("--video_path", type=str,
                        default="./experiments/video0.mp4")
    parser.add_argument("--do_sample",
                        action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--num_beams", type=int, default=1)
    parser.add_argument("--quantize", type=str, default="",
                        choices=["", "int8", "int8_full"],
                        help="int8 serving: weight-only (int8) or + W8A8 "
                             "GEMMs and encoders (int8_full)")
    parser.add_argument("--max_new_tokens", type=int, default=2048)
    parser.add_argument("--spec_draft_len", type=int, default=0,
                        help="speculative decoding: verify this many n-gram "
                             "prompt-lookup drafts per pass (0 = off)")
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--debug_tiny", action="store_true",
                        help="micro model dims (pipeline smoke test)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to serve on (cpu needs "
                        "--debug_tiny in practice)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    random.seed(args.seed)
    np.random.seed(args.seed)

    from ..core.config import GenerateConfig, micro_vlm_config, vlm_config
    from ..serve.engine import InferenceEngine
    from .model_loading import build_params, build_tokenizer

    if args.debug_tiny:
        cfg = micro_vlm_config(args.llm)
    else:
        cfg = vlm_config(args.llm, stage="inference",
                         num_frames=args.num_frames, num_segs=args.num_segs,
                         max_txt_len=args.max_txt_len)
    device = torch.device(args.device)
    params = build_params(
        cfg, device, torch.float32 if args.debug_tiny else torch.bfloat16,
        seed=args.seed,
        weight_root=args.pretrained_vision_proj_llm_path or None,
        video_encoder_path=args.pretrained_video_path or None,
        stage_ckpt=args.ckpt_path or None)
    tokenizer = build_tokenizer(cfg, args.tokenizer_path or None)
    gen_cfg = GenerateConfig(max_new_tokens=args.max_new_tokens,
                             do_sample=args.do_sample,
                             temperature=args.temperature, top_p=args.top_p,
                             num_beams=args.num_beams,
                             spec_draft_len=args.spec_draft_len)
    engine = InferenceEngine(params, cfg, tokenizer, gen_cfg, seed=args.seed,
                             device=device, quantize=args.quantize or None)
    results = {}
    for mode, prompt in (("grounding", args.prompt_grounding),
                         ("qa", args.prompt_videoqa),
                         ("referring", args.prompt_referring)):
        res = engine.run(args.video_path, prompt, mode=mode)
        print(f"[{mode}] raw: {res.text}")
        print(f"[{mode}] parsed: {res.parsed}")
        results[mode] = res
    return results


if __name__ == "__main__":
    main()
