"""The flash-attention backward at the grounded training shape on the card
(port of scripts/microbench_flash_bwd_blocks.py):

  k2_fwd         kernel K2 (ops/flash_attention.flash_fwd, causal) alone
  k7_bwd         kernel K7 (flash_bwd): dq, dk, dv from the forward's lse,
                 delta = rowsum(o * do) included
  k2_k7_fwd_bwd  flash_mha forward and backward through autograd, as a
                 training step runs them (K2, then K7)
  sdpa_fwd       scaled_dot_product_attention(is_causal=True), the yardstick
  sdpa_fwd_bwd   the same forward and its backward (torch.autograd.grad)

Shape: Phi-3.5's grounded spliced sequence, [1, 7515, 32, 96] (B, S, H, D;
32 kv heads), causal, unit-normal q, k = v and do, as the script draws
them. The TPU script swept the Pallas kernels' block_q / block_k through
environment variables read at trace time; the port's kernels have no
block-size knobs, so there is no sweep. The summary's sdpa_bwd is
sdpa_fwd_bwd - sdpa_fwd; TF/s counts 4·D (forward) and 10·D (backward: five
products) flops per visible (query, key) pair and head.

    python -m grounded_video_llm_tpu_torch.microbench.flash_bwd [reps]
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_bwd, flash_fwd, flash_mha
from .timing import card, device_ms, report, require_cuda

R = 10
B, S, H, KV, D = 1, 7515, 32, 32, 96    # phi3.5 grounded spliced shape
# each variant and the passes it runs (for its flop count)
VARIANTS = {"k2_fwd": "fwd", "k7_bwd": "bwd", "k2_k7_fwd_bwd": "fwd_bwd",
            "sdpa_fwd": "fwd", "sdpa_fwd_bwd": "fwd_bwd"}


def inputs(b: int, s: int, h: int, kv: int, d: int, device, seed: int = 0):
    """(q, k, do): the script's unit normals (its k and v are one array)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=g, device=device).bfloat16()
    k = torch.randn(b, s, kv, d, generator=g, device=device).bfloat16()
    do = torch.randn(b, s, h, d, generator=g, device=device).bfloat16()
    return q, k, do


def variants(q, k, do) -> Dict[str, Callable[[], object]]:
    """The five variants on one set of inputs; v is k, as in the script."""
    v = k
    scale = q.shape[-1] ** -0.5
    o, lse = flash_fwd(q, k, v, None, scale, True)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd_bwd():
        out = flash_mha(*leaves, causal=True)
        return torch.autograd.grad(out, leaves, do)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    return {
        "k2_fwd": lambda: flash_fwd(q, k, v, None, scale, True),
        "k7_bwd": lambda: flash_bwd(q, k, v, None, o, lse, do, scale, True),
        "k2_k7_fwd_bwd": fwd_bwd,
        "sdpa_fwd": sdpa,
        "sdpa_fwd_bwd": lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                    dot),
    }


def summary(ms: Dict[str, float], card_name: str) -> dict:
    """The script's JSON line: milliseconds per layer and variant, and each
    variant's speed-up against the SDPA backward."""
    out = {k: round(v, 4) for k, v in ms.items()}
    out["sdpa_bwd"] = round(ms["sdpa_fwd_bwd"] - ms["sdpa_fwd"], 4)
    return {
        "metric": "flash_bwd_ms_per_layer",
        "shape": f"B{B}xS{S}xH{H}xD{D}",
        **out,
        "k7_vs_sdpa_bwd": round(out["sdpa_bwd"] / ms["k7_bwd"], 3),
        "card": card_name,
    }


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("reps", nargs="?", type=int, default=R)
    args = ap.parse_args(argv)
    dev = require_cuda()
    name = card()
    print(f"[microbench flash_bwd] {torch.cuda.get_device_name(0)} "
          f"B={B} S={S} H={H} KV={KV} D={D} causal R={args.reps}",
          flush=True)
    pairs = S * (S + 1) // 2 * B
    flops = {"fwd": 4.0 * D * pairs * H, "bwd": 10.0 * D * pairs * H}
    flops["fwd_bwd"] = flops["fwd"] + flops["bwd"]
    fns = variants(*inputs(B, S, H, KV, D, dev))
    rows = []
    for vname, fn in fns.items():
        rows.append(report(vname, device_ms(fn, args.reps), name,
                           flops=flops[VARIANTS[vname]]))
    print(json.dumps(summary({r["name"]: r["ms"] for r in rows}, name)),
          flush=True)
    return rows


if __name__ == "__main__":
    main()
