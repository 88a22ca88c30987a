"""One InternVideo2 block at the serving shape on the card (port of
scripts/microbench_iv2_block.py): CLIPS clips x 2,049 tokens x 1,408
(72: a batch of 6 videos), vlm_config("phi3.5", stage="inference")'s
InternVideo2-1B block 0 with seeded random weights.

Blocks (models/internvideo2._block, one call each, R back to back):
  block_bf16         dense bf16 weights
  block_w8a8         serve/quantize's W8A8 weights, unfused: rms_norm,
                     dynamic_int8_matmul (torch._int_mm), the epilogues
  block_w8a8_fused   the same weights through kernel K10
                     (ops/fused_block, GVLLM_FUSED_IV2=1 around the call)
  noattn_*           the three with attention stubbed (mha returns q): the
                     matmul side alone; the difference is attention's share
GEMM legs, for qkv, proj, fc1 and fc2 at M = CLIPS x 2,049 rows:
  dot_bf16           torch.matmul in bf16 (no quantization)
  dot_i8i8           torch._int_mm on rows quantized beforehand (the bare
                     int8 rate)
  w8a8               dynamic_int8_matmul: row quantization, the dot, the
                     fp32 rescale
  fused              K10 with the block's epilogue (qkv + qk_norm, fc1 +
                     GELU + bias, proj and fc2 + LayerScale + residual)

The script fed fc2's legs zeros; here fc2's input is a seeded normal x 0.5
(zeros make the row quantization trivial). The script's R chained calls in
one jit become R back-to-back launches between CUDA events after a warm-up.
TF/s counts 2·M·K·N per GEMM.

    python -m grounded_video_llm_tpu_torch.microbench.iv2_block [clips]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
from typing import Callable, Dict, List, Optional

import torch

from ..core.config import vlm_config
from ..models import internvideo2
from ..models.param_utils import layer_slice
from ..ops.fused_block import (fused_norm_quant_gemm,
                               fused_quant_gemm_ls_residual)
from ..ops.int8_matmul import dynamic_int8_matmul, quantize_rows
from ..serve.quantize import quantize_video_encoder_for_serving
from .timing import card, device_ms, report, require_cuda

R = 8
CLIPS = 72
BLOCKS = ("block_bf16", "block_w8a8", "block_w8a8_fused")
LEGS = ("qkv", "proj", "fc1", "fc2")


@contextlib.contextmanager
def fused(on: bool):
    """GVLLM_FUSED_IV2 set to on for the duration, restored after."""
    old = os.environ.get("GVLLM_FUSED_IV2")
    os.environ["GVLLM_FUSED_IV2"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["GVLLM_FUSED_IV2"]
        else:
            os.environ["GVLLM_FUSED_IV2"] = old


@contextlib.contextmanager
def no_attention():
    """internvideo2's mha stubbed to return q, as the script stubs it."""
    real = internvideo2.mha
    internvideo2.mha = lambda q, k, v, **kw: q
    try:
        yield
    finally:
        internvideo2.mha = real


def block_params(cfg, device, seed: int = 0):
    """(bf16 block, W8A8 block): block 0 of a one-block trunk."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = internvideo2.init_params(dataclasses.replace(cfg, depth=1),
                                      generator=g, device=device,
                                      dtype=torch.bfloat16)
    quant = quantize_video_encoder_for_serving(params)
    return layer_slice(params["blocks"], 0), layer_slice(quant["blocks"], 0)


def block_variants(x, bp, bq, cfg) -> Dict[str, Callable[[], object]]:
    """The three blocks; each sets the fused switch for its own call."""
    def run(p, on):
        def fn():
            with fused(on):
                return internvideo2._block(x, p, cfg)
        return fn
    return {"block_bf16": run(bp, False), "block_w8a8": run(bq, False),
            "block_w8a8_fused": run(bq, True)}


def leg_variants(x, h, bp, bq, cfg) -> Dict[str, Dict[str, Callable]]:
    """{leg: {variant: fn}} for the four GEMMs; x [M, D] feeds qkv, proj
    and fc1, h [M, mlp_hidden] feeds fc2."""
    eps = cfg.rms_eps
    qn = torch.stack([bp["q_norm_w"], bp["k_norm_w"]])
    dense = {"qkv": bp["qkv_kernel"], "proj": bp["proj"]["kernel"],
             "fc1": bp["fc1"]["kernel"], "fc2": bp["fc2"]["kernel"]}
    w8 = {"qkv": bq["qkv_kernel"], "proj": bq["proj"]["kernel"],
          "fc1": bq["fc1"]["kernel"], "fc2": bq["fc2"]["kernel"]}
    kernels = {
        "qkv": lambda: fused_norm_quant_gemm(
            x, bq["norm1_w"], w8["qkv"], eps=eps, epilogue="qk_norm",
            qk_norm_w=qn),
        "proj": lambda: fused_quant_gemm_ls_residual(
            x, w8["proj"], bq["proj"]["bias"], bq["ls1"], x),
        "fc1": lambda: fused_norm_quant_gemm(
            x, bq["norm2_w"], w8["fc1"], eps=eps, epilogue="gelu",
            bias=bq["fc1"]["bias"]),
        "fc2": lambda: fused_quant_gemm_ls_residual(
            h, w8["fc2"], bq["fc2"]["bias"], bq["ls2"], x),
    }
    out = {}
    for leg in LEGS:
        a = h if leg == "fc2" else x
        a8, _ = quantize_rows(a)
        out[leg] = {
            "dot_bf16": lambda a=a, w=dense[leg]: torch.matmul(a, w),
            "dot_i8i8": lambda a8=a8, w=w8[leg]: torch._int_mm(a8, w.q),
            "w8a8": lambda a=a, w=w8[leg]: dynamic_int8_matmul(a, w.q,
                                                               w.scale),
            "fused": kernels[leg],
        }
    return out


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("clips", nargs="?", type=int, default=CLIPS)
    args = ap.parse_args(argv)
    dev = require_cuda()
    name = card()
    cfg = vlm_config("phi3.5", stage="inference").video
    S = cfg.seq_len
    M, D, I = args.clips * S, cfg.embed_dim, cfg.mlp_hidden
    print(f"[microbench iv2_block] {torch.cuda.get_device_name(0)} "
          f"clips={args.clips} S={S} D={D} R={R}", flush=True)
    bp, bq = block_params(cfg, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    x = (torch.randn(args.clips, S, D, generator=g, device=dev)
         * 0.1).bfloat16()
    rows = []
    ms = {}
    for label, stub in (("block", contextlib.nullcontext),
                        ("noattn", no_attention)):
        with stub():
            for vname, fn in block_variants(x, bp, bq, cfg).items():
                vname = vname.replace("block", label, 1)
                ms[vname] = device_ms(fn, R)
                rows.append(report(vname, ms[vname], name))
    print(f"block speed-up w8a8 {ms['block_bf16'] / ms['block_w8a8']:.2f}x, "
          f"w8a8 fused {ms['block_bf16'] / ms['block_w8a8_fused']:.2f}x; "
          f"attention ~{ms['block_bf16'] - ms['noattn_bf16']:.2f} ms bf16 / "
          f"{ms['block_w8a8'] - ms['noattn_w8a8']:.2f} w8a8 / "
          f"{ms['block_w8a8_fused'] - ms['noattn_w8a8_fused']:.2f} fused "
          f"[{name}]", flush=True)
    x2 = x.reshape(M, D)
    h = (torch.randn(M, I, generator=g, device=dev) * 0.5).bfloat16()
    for leg, fns in leg_variants(x2, h, bp, bq, cfg).items():
        k, n = (I, D) if leg == "fc2" else (D, {"qkv": 3 * D, "proj": D,
                                               "fc1": I}[leg])
        print(f"{leg}: M={M} K={k} N={n}", flush=True)
        for vname, fn in fns.items():
            rows.append(dict(report(f"{vname}_{leg}", device_ms(fn, R),
                                    name, flops=2.0 * M * k * n), leg=leg))
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
