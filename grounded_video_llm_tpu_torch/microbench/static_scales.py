"""Dynamic against static W8A8 activation scales on the full-width
InternVideo2 trunk, on the card (port of
scripts/microbench_static_scales.py):

  dynamic     the shipped W8A8 path: per-row dynamic activation scales on
              every leg
  static_fc2  a calibrated static scale on fc2 only
  static_f2p  fc2 and proj (serve/calibrate.DEFAULT_LEGS)
  static_all  all four legs (qkv, proj, fc1, fc2)

vlm_config("phi3.5", stage="inference")'s trunk (39 of 40 blocks run,
seeded random weights, serve/quantize's W8A8), CLIPS clips of 8 frames
(72: a batch of 6 videos), normal pixels × 0.5 drawn on the card. One
calibration pass (internvideo2.features_absmax) sets the scales; one
warm-up forward, then REPS rounds over the four trees in turn, each forward
timed on the host clock between two synchronisations. Prints one line per
forward and, last, the script's JSON summary (best seconds per forward,
ms per block and speed-up against dynamic) with the card beside it.

The JAX package's claim to check (serve/calibrate.py:4-7, measured on a
TPU v5e): fc2's dynamic quantization costs ~7 ms per block at this shape.

    python -m grounded_video_llm_tpu_torch.microbench.static_scales \
        [clips] [reps]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import torch

from ..core.config import vlm_config
from ..models import internvideo2
from ..serve import calibrate
from ..serve.quantize import quantize_video_encoder_for_serving
from .timing import card, require_cuda

VARIANTS = (("dynamic", None), ("static_fc2", ("fc2",)),
            ("static_f2p", ("fc2", "proj")), ("static_all", calibrate.LEGS))


def trees(params, calib):
    """{variant: encoder tree}; the dynamic tree is params itself."""
    return {name: params if legs is None
            else calibrate.apply_static_scales(params, calib, legs=legs)
            for name, legs in VARIANTS}


def summary(best: dict, clips: int, blocks: int, card_name: str) -> dict:
    base = best["dynamic"]
    return {
        "metric": "iv2_static_scales_sec_per_forward",
        "clips": clips,
        **{k: round(v, 4) for k, v in best.items()},
        "delta_ms_per_block": {
            k: round(1000 * (base - v) / blocks, 2)
            for k, v in best.items() if k != "dynamic"},
        "speedup": {k: round(base / v, 4) for k, v in best.items()
                    if k != "dynamic"},
        "card": card_name,
    }


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("clips", nargs="?", type=int, default=72)
    ap.add_argument("reps", nargs="?", type=int, default=3)
    args = ap.parse_args(argv)
    dev = require_cuda()
    name = card()
    vcfg = vlm_config("phi3.5", stage="inference").video
    print(f"[microbench static_scales] {torch.cuda.get_device_name(0)} "
          f"clips={args.clips} blocks={vcfg.num_blocks_used} "
          f"reps={args.reps}", flush=True)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    t0 = time.perf_counter()
    params = quantize_video_encoder_for_serving(internvideo2.init_params(
        vcfg, generator=g, device=dev, dtype=torch.bfloat16))
    clips = (torch.randn(args.clips, vcfg.num_frames, vcfg.image_size,
                         vcfg.image_size, 3, generator=g, device=dev)
             * 0.5).bfloat16()
    torch.cuda.synchronize()
    print(f"init+quantize: {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    def forward(tree):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            internvideo2.features(tree, vcfg, clips)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with torch.inference_mode():
        _, stats = internvideo2.features_absmax(params, vcfg, clips)
    calib = {leg: s.cpu().numpy() for leg, s in stats.items()}
    del stats
    print(f"calibration pass: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    variants = trees(params, calib)
    forward(variants["dynamic"])                       # warm-up
    results = {}
    for rep in range(args.reps):
        for vname, tree in variants.items():
            dt = forward(tree)
            results.setdefault(vname, []).append(dt)
            print(f"rep{rep} {vname:12s} {dt:.3f}s  [{name}]", flush=True)
    out = summary({k: min(v) for k, v in results.items()}, args.clips,
                  vcfg.num_blocks_used, name)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
