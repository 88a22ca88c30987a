"""Training CLI of the PyTorch port (the counterpart of the root train.py,
with the same arguments plus --device).

    python -m grounded_video_llm_tpu_torch.cli.train --stage grounded \\
        --dataset mix_grounded --anno_path data/mix_grounded.json \\
        --data_dir data/
    python -m grounded_video_llm_tpu_torch.cli.train --debug_tiny \\
        --device cpu --stage grounded --dataset mix_grounded \\
        --anno_path anno.json --data_dir videos/

It trains on one device (cuda by default; --debug_tiny on the CPU needs
--device cpu). --pretrained_vision_proj_llm_path (the weight dumps' dir),
--pretrained_video_path (the InternVideo2 .pt) and --pretrained_proj (an
earlier stage's checkpoint) load through cli/model_loading.build_params;
what they do not give is seeded random. After the final checkpoint the run
writes the reference-format export {save_dir}/{stage}_{model}_{llm}_
{dataset}.pth (the root train.py's name). Multi-GPU sharding is not ported
yet.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    parser.add_argument("--dataset", type=str, default="mix_sft",
                        choices=["mix_pretrain", "mix_grounded", "mix_sft"])
    parser.add_argument("--anno_path", type=str, required=True)
    parser.add_argument("--data_dir", type=str, default="")
    parser.add_argument("--stage", type=str, default="sft",
                        choices=["pretrain", "grounded", "sft"])
    parser.add_argument("--max_txt_len", type=int, default=2048)
    parser.add_argument("--num_temporal_tokens", type=int, default=300)
    parser.add_argument("--num_frames", type=int, default=96)
    parser.add_argument("--num_segs", type=int, default=12)
    parser.add_argument("--epoch", type=int, default=0,
                        help="override stage preset epochs if > 0")
    parser.add_argument("--global_batch_size", type=int, default=0,
                        help="override stage preset if > 0")
    parser.add_argument("--per_device_batch_size", type=int, default=0)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--resume_ckpt", type=str, default="")
    parser.add_argument("--save_dir", type=str, default="./experiments")
    parser.add_argument("--tokenizer_path", type=str, default="")
    parser.add_argument("--pretrained_video_path", type=str, default="")
    parser.add_argument("--pretrained_vision_proj_llm_path", type=str,
                        default="")
    parser.add_argument("--pretrained_proj", type=str, default="")
    parser.add_argument("--debug_tiny", action="store_true",
                        help="micro model dims (pipeline smoke test)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cpu needs "
                        "--debug_tiny in practice)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    random.seed(args.seed)
    np.random.seed(args.seed)

    from ..core.config import STAGE_PRESETS, micro_vlm_config, vlm_config
    from ..data.datasets import DATASETS
    from ..train.strategy import TrainingStrategy
    from .model_loading import build_params, build_tokenizer

    if args.debug_tiny:
        cfg = micro_vlm_config(args.llm)
        args.num_frames, args.num_segs = cfg.num_frames, cfg.num_segs
    else:
        cfg = vlm_config(args.llm, stage=args.stage,
                         num_frames=args.num_frames, num_segs=args.num_segs)
    device = torch.device(args.device)
    params = build_params(
        cfg, device, torch.float32 if args.debug_tiny else torch.bfloat16,
        seed=args.seed,
        weight_root=args.pretrained_vision_proj_llm_path or None,
        video_encoder_path=args.pretrained_video_path or None,
        stage_ckpt=args.pretrained_proj or None)
    tokenizer = build_tokenizer(cfg, args.tokenizer_path or None,
                                expand=STAGE_PRESETS[args.stage].expand_vocab)
    dataset = DATASETS[args.dataset](
        anno_path=args.anno_path, video_path=args.data_dir,
        num_frames=args.num_frames, num_segs=args.num_segs,
        num_temporal_tokens=args.num_temporal_tokens, llm=args.llm,
        seed=args.seed)

    over = {}
    if args.epoch:
        over["epochs"] = args.epoch
    if args.global_batch_size:
        over["global_batch_size"] = args.global_batch_size
    if args.per_device_batch_size:
        over["per_device_batch_size"] = args.per_device_batch_size
    if over:
        STAGE_PRESETS[args.stage] = dataclasses.replace(
            STAGE_PRESETS[args.stage], **over)

    strategy = TrainingStrategy(cfg, args.stage, params, tokenizer,
                                run_dir=args.save_dir,
                                n_train_examples=len(dataset),
                                seed=args.seed)
    strategy.run_training(dataset,
                          resume_from=args.resume_ckpt if args.resume
                          else None)
    path = strategy.save_checkpoint("final")
    strategy.export_reference_checkpoint(
        f"{args.save_dir}/{args.stage}_{args.model}_{args.llm}_"
        f"{args.dataset}.pth")
    return path


if __name__ == "__main__":
    main()
