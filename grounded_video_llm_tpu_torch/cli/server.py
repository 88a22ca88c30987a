"""HTTP serving CLI of the PyTorch port (the counterpart of the root
server.py, with the same arguments plus --device): the continuous-batching
API server of serve/server.py, an OpenAI-style JSON API with per-token SSE
streaming over the slot pool, feature-cached video encode at admission.

    python -m grounded_video_llm_tpu_torch.cli.server --llm phi3.5 \\
        --quantize int8_full --port 8321
    python -m grounded_video_llm_tpu_torch.cli.server --debug_tiny \\
        --device cpu --port 8321
    curl -s localhost:8321/v1/generate -d '{"video_path": "v.mp4",
         "prompt": "When does the dog jump?", "mode": "grounding"}'

It serves on one device (cuda by default; --debug_tiny on the CPU needs
--device cpu). The weight flags and --quantize go through
cli/model_loading.build_params as in cli/inference.py.
"""

from __future__ import annotations

import argparse
import random

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--llm", default="phi3.5",
                   choices=["llama3", "vicuna", "phi3.5"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--pool_size", type=int, default=4,
                   help="continuous-batching slots (device memory: each slot "
                        "carries a pool-length int8 KV cache)")
    p.add_argument("--prompt_len", type=int, default=256,
                   help="static text-prompt bucket (left-padded); must hold "
                        "the full rendered prompt through the <image> token "
                        "— the engine rejects prompts whose image slot "
                        "would truncate away")
    p.add_argument("--max_new_tokens", type=int, default=64,
                   help="pool token budget (per-request budgets may be "
                        "lower)")
    p.add_argument("--chunk", type=int, default=8,
                   help="decode chunk between admission checks (latency = "
                        "chunk x ms/token)")
    p.add_argument("--chunk_long", type=int, default=0,
                   help="adaptive tail chunk: when the queue is empty and "
                        "every in-flight request's remaining budget covers "
                        "it, decode in chunks of this size (amortizes "
                        "per-chunk dispatch over the straggler tail); 0 off")
    p.add_argument("--spec_draft_len", type=int, default=0)
    p.add_argument("--pipeline_chunks", action="store_true",
                   help="dispatch chunk k+1 before fetching chunk k's "
                        "tokens: the per-chunk host sync overlaps device "
                        "execution (retirement/admission lag one chunk)")
    p.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="build the pool's kernels at startup (default: on "
                        "when --chunk_long is set)")
    p.add_argument("--prefix_cache", action="store_true",
                   help="prefix-KV admission: repeated videos prefill only "
                        "their question chunk (the shared [system | video "
                        "tokens] head caches per video)")
    p.add_argument("--shared_prefix_pool", action="store_true",
                   help="cascade decode pool (requires --prefix_cache): the "
                        "pinned video prefix is stored once at batch dim 1 "
                        "and streamed once per token for all slots — the "
                        "decode DMA win for same-video request batches; "
                        "requests for a different video wait until the pool "
                        "drains, then the pool repins")
    p.add_argument("--num_frames", type=int, default=96)
    p.add_argument("--num_segs", type=int, default=12)
    p.add_argument("--tokenizer_path", default="")
    p.add_argument("--pretrained_video_path", default="")
    p.add_argument("--pretrained_vision_proj_llm_path", default="")
    p.add_argument("--ckpt_path", default="")
    p.add_argument("--quantize", default="",
                   choices=["", "int8", "int8_full"])
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--do_sample", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--feature_cache_size", type=int, default=8)
    p.add_argument("--debug_tiny", action="store_true",
                   help="micro model dims (smoke server)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cpu needs --debug_tiny "
                        "in practice)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    random.seed(args.seed)
    np.random.seed(args.seed)

    from ..core.config import GenerateConfig, micro_vlm_config, vlm_config
    from ..serve.engine import InferenceEngine
    from ..serve.server import ServingFrontend, serve_http
    from .model_loading import build_params, build_tokenizer

    if args.debug_tiny:
        cfg = micro_vlm_config(args.llm)
    else:
        cfg = vlm_config(args.llm, stage="inference",
                         num_frames=args.num_frames, num_segs=args.num_segs)
    device = torch.device(args.device)
    params = build_params(
        cfg, device, torch.float32 if args.debug_tiny else torch.bfloat16,
        seed=args.seed,
        weight_root=args.pretrained_vision_proj_llm_path or None,
        video_encoder_path=args.pretrained_video_path or None,
        stage_ckpt=args.ckpt_path or None, quantize=args.quantize or None)
    tokenizer = build_tokenizer(cfg, args.tokenizer_path or None)
    gen_cfg = GenerateConfig(max_new_tokens=args.max_new_tokens,
                             do_sample=args.do_sample,
                             temperature=args.temperature, top_p=args.top_p,
                             quantize_cache=True)
    engine = InferenceEngine(params, cfg, tokenizer, gen_cfg, seed=args.seed,
                             device=device, quantize=args.quantize or None,
                             feature_cache_size=args.feature_cache_size)
    frontend = ServingFrontend(
        engine, pool_size=args.pool_size, prompt_len=args.prompt_len,
        max_new_tokens=args.max_new_tokens, chunk=args.chunk,
        spec_draft_len=args.spec_draft_len, prefix_cache=args.prefix_cache,
        shared_prefix_pool=args.shared_prefix_pool,
        chunk_long=args.chunk_long, pipeline_chunks=args.pipeline_chunks,
        warmup=args.warmup)
    httpd = serve_http(frontend, args.host, args.port)
    print(f"serving {cfg.llm_name} on http://{args.host}:"
          f"{httpd.server_address[1]} (pool={args.pool_size}, prompt_len="
          f"{args.prompt_len}, max_new={args.max_new_tokens}, device="
          f"{device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        frontend.shutdown()
        httpd.server_close()


if __name__ == "__main__":
    main()
