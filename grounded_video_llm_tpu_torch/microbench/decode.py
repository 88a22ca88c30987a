"""Decode-path components on the card (port of scripts/microbench_decode.py):

  gemv_bf16   x @ w with bf16 weights (twice the bytes)
  gemv_int8   the weight-only int8 GEMV the port ships (ops/int8_matmul,
              kernel K6's function)
  gemv_w8a8   the w8a8 int8 GEMV the port ships for int8_full decode (K3's
              w8a8 branch: per-row int8 x, __dp4a on the CUDA cores)
  gemv_i8i8   kernel M1 (ops/int8_gemm.i8i8_matmul): per-row int8 x, int8 x
              int8 on the tensor cores, fp32 rescale (the TPU prototype)
  attn_bf16   the port's decode_attention over a bf16 cache (twice the
              bytes; plain PyTorch, as the JAX package leaves it to XLA)
  attn_int8   kernel K4 (ops/decode_attention_int8) over the int8 cache

Shapes: the three Phi-3.5 projections at batch B (qkv 3072→9216, gate_up
3072→16384, down 8192→3072) and one layer's decode attention at L = 3,584
slots, 32 heads of 96. GB/s counts the resident bytes streamed (weights or
cache). Each launch reads the next of enough weight or cache copies to
pass the 50 MB L2, so the bytes come from device memory, as in a decode
step. The R launches are captured in one CUDA graph and its replay is
timed, so the host's launch cost is left out.

    python -m grounded_video_llm_tpu_torch.microbench.decode [batch]
"""

from __future__ import annotations

import argparse
import itertools
from typing import List, Optional

import torch

from ..ops.attention import decode_attention
from ..ops.decode_attention_int8 import decode_attention_int8, quantize_kv
from ..ops.int8_gemm import i8i8_matmul
from ..ops.int8_matmul import int8_matmul, quantize_weights_int8
from .timing import card, device_ms, report, require_cuda

R = 50
D_MODEL, QKV_OUT, I2, DOWN_IN = 3072, 9216, 16384, 8192
HKV, DH, L_CACHE = 32, 96, 3584
PROJECTIONS = ((D_MODEL, QKV_OUT, "qkv"), (D_MODEL, I2, "gate_up"),
               (DOWN_IN, D_MODEL, "down"))
L2_BYTES = 50 * 2 ** 20


def copies(nbytes: int) -> int:
    """Buffers to rotate over so that one pass reads more than the L2."""
    return max(2, -(-3 * L2_BYTES // nbytes))


def cycle(fn, n: int):
    """fn(i) over i = 0, 1, ..., n - 1, 0, ... one index per call."""
    it = itertools.cycle(range(n))
    return lambda: fn(next(it))


def gemv_variants(x, w, wq, ws):
    """Per-copy callables on stacked weights w [C, D, O] bf16, wq [C, D, O]
    int8, ws [C, O]."""
    return {
        "gemv_bf16": lambda i: x @ w[i],
        "gemv_int8": lambda i: int8_matmul(x, wq[i], ws[i]),
        "gemv_w8a8": lambda i: int8_matmul(x, wq[i], ws[i], w8a8=True),
        "gemv_i8i8": lambda i: i8i8_matmul(x, wq[i], ws[i]),
    }


def attention_variants(q, kc, vc, k8, ks, v8, vs, mask, kn, vn):
    """Per-copy callables: bf16 caches [C, B, L, Hkv, D]; int8 caches in the
    port layout [C, B, Hkv, L, D] with scales [C, B, Hkv, L]."""
    scale = q.shape[-1] ** -0.5
    return {
        "attn_bf16": lambda i: decode_attention(q, kc[i], vc[i], mask,
                                                k_new=kn, v_new=vn),
        "attn_int8": lambda i: decode_attention_int8(
            q, k8[i], ks[i], v8[i], vs[i], mask, kn, vn, scale=scale),
    }


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=6)
    ap.add_argument("--reps", type=int, default=R)
    args = ap.parse_args(argv)
    dev = require_cuda()
    name = card()
    B = args.batch
    print(f"[microbench decode] {torch.cuda.get_device_name(0)} batch={B} "
          f"R={args.reps}", flush=True)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []
    for d_in, d_out, tag in PROJECTIONS:
        C = copies(d_in * d_out)
        w = (torch.randn(C, d_in, d_out, generator=g, device=dev)
             * 0.02).bfloat16()
        wq, ws = quantize_weights_int8(w)
        x = (torch.randn(B, d_in, generator=g, device=dev) * 0.1).bfloat16()
        for vname, fn in gemv_variants(x, w, wq, ws).items():
            nbytes = d_in * d_out * (2 if vname == "gemv_bf16" else 1)
            ms = device_ms(cycle(fn, C), args.reps, graph=True)
            rows.append(report(f"{vname}_{tag}", ms, name, nbytes=nbytes))
        del w, wq, ws
        torch.cuda.empty_cache()

    cache_bf16 = 2 * 2 * B * L_CACHE * HKV * DH       # k and v
    C = copies(cache_bf16 // 2)
    q = (torch.randn(B, 1, HKV, DH, generator=g, device=dev) * 0.1).bfloat16()
    kc, vc = ((torch.randn(C, B, L_CACHE, HKV, DH, generator=g, device=dev)
               * 0.1).bfloat16() for _ in range(2))
    kn, vn = ((torch.randn(B, 1, HKV, DH, generator=g, device=dev)
               * 0.1).bfloat16() for _ in range(2))
    mask = torch.ones(B, L_CACHE, dtype=torch.bool, device=dev)
    k8, ks = quantize_kv(kc.transpose(2, 3))          # [C, B, Hkv, L, D]
    v8, vs = quantize_kv(vc.transpose(2, 3))
    k8, ks, v8, vs = (t.contiguous() for t in (k8, ks, v8, vs))
    for vname, fn in attention_variants(q, kc, vc, k8, ks, v8, vs, mask, kn,
                                        vn).items():
        nbytes = cache_bf16 if vname == "attn_bf16" else cache_bf16 // 2
        ms = device_ms(cycle(fn, C), args.reps, graph=True)
        rows.append(report(vname, ms, name, nbytes=nbytes))
    return rows


if __name__ == "__main__":
    main()
