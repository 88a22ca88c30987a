"""InternVideo2 encoder attention on the card (port of
scripts/microbench_encoder_attn.py): kernel M2's softmax variants
(ops/flash_attention.flash_variant) on q/k/v [B, H, S, D], each beside one
PyTorch call computing attention (scaled_dot_product_attention) as the
yardstick:

  full                   exact softmax (online row max)
  nomax exp2 unroll2 pipe
                         the fixed-offset softmax the QK-RMSNorm allows
                         (offset 30); on the TPU these differed in
                         scheduling, here they are one kernel
  sumdot                 the same with the denominator summed from the bf16 p
  noexp                  p = s: what removing the exp could buy (wrong
                         math, right traffic)
  dh128                  the fixed-offset softmax with q/k/v zero-padded to
                         Dh = 128 (the price of 88-wide heads)
  nomax_S2048            the fixed-offset softmax at S = 2,048 (the price
                         of the ragged 2,049th key)
  mha_bshd_insitu        the serving entry: ops/attention.mha with
                         bounded_softmax=True (kernel K1) on the [B, S, H, D]
                         layout the trunk keeps

The TPU script's block_q sweep (208/232/256) tuned a Mosaic tile and has no
counterpart. Shapes: B clips of one video (12), S = 2,049, H = 16, Dh = 88.
TF/s counts the two products, 4·B·H·S²·Dh (at Dh = 88 for dh128 too, as the
script does).

    python -m grounded_video_llm_tpu_torch.microbench.encoder_attn [b_clips]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import mha
from ..ops.flash_attention import flash_variant
from .timing import card, device_ms, report, require_cuda

R = 40
S, H, DH = 2049, 16, 88
MODES = ("full", "nomax", "exp2", "unroll2", "pipe", "sumdot", "noexp")


def sdpa(q, k, v):
    return F.scaled_dot_product_attention(q, k, v)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("b_clips", nargs="?", type=int, default=12)
    ap.add_argument("--reps", type=int, default=R)
    args = ap.parse_args(argv)
    dev = require_cuda()
    name = card()
    B, reps = args.b_clips, args.reps
    print(f"[microbench encoder_attn] {torch.cuda.get_device_name(0)} "
          f"clips={B} S={S} H={H} Dh={DH} R={reps}", flush=True)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    q, k, v = ((torch.randn(B, H, S, DH, generator=g, device=dev) * 0.1)
               .bfloat16() for _ in range(3))
    flops = 4.0 * B * H * S * S * DH
    rows = []

    def run(label, fn, f=flops):
        rows.append(report(label, device_ms(fn, reps), name, flops=f))

    for mode in MODES:
        run(f"flash_{mode}", lambda m=mode: flash_variant(q, k, v, m))
    run("sdpa", lambda: sdpa(q, k, v))

    pad = (0, 128 - DH)
    qp, kp, vp = (F.pad(t, pad) for t in (q, k, v))
    run("flash_dh128", lambda: flash_variant(qp, kp, vp, "dh128"))
    run("sdpa_dh128", lambda: sdpa(qp, kp, vp))
    del qp, kp, vp

    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    run("mha_bshd_insitu", lambda: mha(qs, ks, vs, bounded_softmax=True))
    del qs, ks, vs

    q2, k2, v2 = (t[:, :, :2048].contiguous() for t in (q, k, v))
    flops2 = 4.0 * B * H * 2048 * 2048 * DH
    run("flash_nomax_S2048", lambda: flash_variant(q2, k2, v2, "nomax"),
        flops2)
    run("sdpa_S2048", lambda: sdpa(q2, k2, v2), flops2)
    return rows


if __name__ == "__main__":
    main()
