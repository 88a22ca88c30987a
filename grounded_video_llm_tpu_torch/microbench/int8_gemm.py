"""int8 x int8 against bf16 GEMMs at the InternVideo2 encoder's shapes on the
card (port of scripts/microbench_int8_gemm.py):

  bf16          torch.matmul in bf16 (the bf16 encoder's GEMM)
  i8i8          torch._int_mm on pre-quantized operands → int32
  i8i8_rescale  + the fp32 rescale of the int32 output (per row × per column)
  i8i8_dynamic  the port's dynamic_int8_matmul: per-row activation
                quantization, torch._int_mm, rescale → bf16 (the serving
                path)
  m3_static     kernel M3 (ops/int8_gemm.int8_gemm): the int8 GEMM with the
                per-column rescale in its epilogue → bf16
  m3_dynamic    kernel M3d (int8_gemm_dynamic): the per-row quantization
                inside the GEMM program, from bf16 x → bf16

Shapes: the MLP's fc1 [M, 1408] x [1408, 6144] at M = 8,192 rows and the fc2
transpose [M, 6144] x [6144, 1408]. R back-to-back launches between CUDA
events after one warm-up.

    python -m grounded_video_llm_tpu_torch.microbench.int8_gemm [--reps R]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from ..ops.int8_gemm import int8_gemm, int8_gemm_dynamic
from ..ops.int8_matmul import dynamic_int8_matmul
from .timing import card, device_ms, report, require_cuda

R = 20
M, K, N = 8192, 1408, 6144
SHAPES = ((M, K, N), (M, N, K))          # fc1, the fc2 transpose


def variants(x, w, xq, wq, xs, ws) -> Dict[str, callable]:
    """The script's variants and the two kernels, on one shape's inputs."""
    return {
        "bf16": lambda: torch.matmul(x, w),
        "i8i8": lambda: torch._int_mm(xq, wq),
        "i8i8_rescale": lambda: torch._int_mm(xq, wq).float() * xs * ws,
        "i8i8_dynamic": lambda: dynamic_int8_matmul(x, wq, ws),
        "m3_static": lambda: int8_gemm(xq, wq, ws),
        "m3_dynamic": lambda: int8_gemm_dynamic(x, wq, ws),
    }


def inputs(m: int, k: int, n: int, device, seed: int = 0):
    """The script's operands, drawn on the device from a seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = (torch.randn(m, k, generator=g, device=device) * 0.1).bfloat16()
    w = (torch.randn(k, n, generator=g, device=device) * 0.02).bfloat16()
    xq = torch.randint(-127, 128, (m, k), generator=g, device=device,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=device,
                       dtype=torch.int8)
    xs = torch.randn(m, 1, generator=g, device=device).abs() * 1e-3 + 1e-4
    ws = torch.randn(n, generator=g, device=device).abs() * 1e-3 + 1e-4
    return x, w, xq, wq, xs, ws


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=R)
    args = ap.parse_args(argv)
    dev = require_cuda()
    name = card()
    print(f"[microbench int8_gemm] {torch.cuda.get_device_name(0)} "
          f"R={args.reps}", flush=True)
    rows = []
    for m, k, n in SHAPES:
        flops = 2.0 * m * k * n
        print(f"M={m} K={k} N={n}", flush=True)
        fns = variants(*inputs(m, k, n, dev))
        for vname, fn in fns.items():
            row = report(vname, device_ms(fn, args.reps), name, flops=flops)
            rows.append(dict(row, shape=(m, k, n)))
        del fns
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
