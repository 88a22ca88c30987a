"""Fused W8A8 InternVideo2-block GEMMs: K10 (csrc/fused_block.cu) and the
plain PyTorch versions (port of grounded_video_llm_tpu/ops/fused_block.py).

  fused_norm_quant_gemm          x → RMSNorm → per-row int8 quantization →
                                 int8 x int8 dot → fp32 rescale (+ bias) →
                                 epilogue "none", "gelu" (exact GELU through
                                 the rational erf) or "qk_norm" (the qkv
                                 projection: RMSNorm of the fp32 q and k
                                 thirds, v passes)
  fused_quant_gemm_ls_residual   x → per-row int8 quantization → dot →
                                 + bias → fp32 LayerScale → + residual

The math follows the JAX functions op by op: the RMSNorm result is
quantized in fp32 with no bf16 rounding in between (``_norm_quant``), the
dot is exact (int32 on the card, float64 in the plain version, both rounded
once to fp32), the rescale, bias, erf, qk-norm and LayerScale run in fp32,
and the output is rounded once to x's dtype. The unfused W8A8 block
(models/internvideo2._block) rounds the normed activations to bf16 before
quantizing them, so the two differ at int8 level.

The weights are ``Int8Weight``s of the encoder's serving quantization
(serve/quantize.quantize_video_encoder_for_serving). Those are W8A8 by
construction (ops/int8_matmul.matmul_any runs every encoder int8 weight
W8A8) and, as in the JAX tree, they carry no marker. The port has no
static activation scales, so the JAX path's gap, where the fused block
ignores a calibrated ``x_scale`` (ADVICE, int8_matmul.py:89), cannot arise
here: a weight that carries anything but values and scales cannot be built.

CPU tensors run the plain versions; CUDA tensors launch the kernels
(counted once per call in ``FUSED_NORM_QUANT_GEMM.launches`` and
``FUSED_QUANT_GEMM_LS_RESIDUAL.launches``) or raise. There is no fallback to
the unfused chain.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import CudaKernel
from .int8_matmul import Int8Weight, _exact_int8_dot, quantize_rows

EPILOGUES = {"none": 0, "gelu": 1, "qk_norm": 2}
# csrc/fused_block.cu: K in multiples of the weight transpose's 64-byte
# tile; output tiles of 256, 176 or 128 columns (N % 128 == 0 always fits);
# qk_norm runs each K-wide third as one cluster of at most 8 tiles
_BK, _BN = 64, 128
_QK_TILES, _MAX_CLUSTER = (256, 176, 128), 8

# gvllm_fused_norm_quant_gemm(x, norm_w, w, ws, bias, qn, out, x8, xs, wt,
#                             M, K, N, epilogue, eps, stream)
FUSED_NORM_QUANT_GEMM = CudaKernel(
    "fused_block.cu", "gvllm_fused_norm_quant_gemm",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float]
    + [ctypes.c_void_p])
# gvllm_fused_quant_gemm_ls_residual(x, w, ws, bias, ls, res, out, x8, xs,
#                                    wt, M, K, N, stream)
FUSED_QUANT_GEMM_LS_RESIDUAL = CudaKernel(
    "fused_block.cu", "gvllm_fused_quant_gemm_ls_residual",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def qk_norm_tile(D: int) -> Optional[int]:
    """The kernel's column tile for the qk_norm epilogue at width D: a
    K-wide third runs as one cluster of D / tile blocks, at most 8 (D =
    1,408: 8 x 176). None where no tile fits."""
    for bn in _QK_TILES:
        if D % bn == 0 and D // bn <= _MAX_CLUSTER:
            return bn
    return None


def erf_rational(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 rational erf (|error| <= 1.5e-7), the JAX
    kernel's ``_erf``."""
    s = torch.sign(x)
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t
             - 0.284496736) * t + 0.254829592) * t
    return s * (1.0 - poly * torch.exp(-ax * ax))


def norm_quant(x: torch.Tensor, norm_w: torch.Tensor, eps: float):
    """fp32 RMSNorm, then per-row int8 quantization of the fp32 result →
    (int8 [M, D], fp32 scales [M, 1])."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return quantize_rows(xf * torch.rsqrt(var + eps) * norm_w.float())


def _rescale(x8, xs, w: Int8Weight, bias):
    y = _exact_int8_dot(x8, w.q) * xs * w.scale
    return y + bias.float() if bias is not None else y


def fused_norm_quant_gemm_reference(x, norm_w, w: Int8Weight, *, eps: float,
                                    epilogue: str = "none", bias=None,
                                    qk_norm_w=None) -> torch.Tensor:
    """Plain version of K10's first function: x [..., D] → [..., O] in x's
    dtype."""
    D, O = x.shape[-1], w.q.shape[-1]
    x8, xs = norm_quant(x.reshape(-1, D), norm_w, eps)
    y = _rescale(x8, xs, w, bias)
    if epilogue == "gelu":
        y = 0.5 * y * (1.0 + erf_rational(y * 0.7071067811865476))
    elif epilogue == "qk_norm":
        parts = list(y.split(D, dim=-1))
        for i in range(2):
            var = (parts[i] * parts[i]).mean(dim=-1, keepdim=True)
            parts[i] = (parts[i] * torch.rsqrt(var + eps)
                        * qk_norm_w[i].float())
        y = torch.cat(parts, dim=-1)
    return y.to(x.dtype).reshape(*x.shape[:-1], O)


def fused_quant_gemm_ls_residual_reference(x, w: Int8Weight, bias, ls,
                                           residual) -> torch.Tensor:
    """Plain version of K10's second function: residual + ls * (quant(x) @
    w + bias), LayerScale in fp32 → x's dtype."""
    D, O = x.shape[-1], w.q.shape[-1]
    x8, xs = quantize_rows(x.reshape(-1, D))
    y = _rescale(x8, xs, w, bias) * ls.float()
    y = y + residual.reshape(-1, O).float()
    return y.to(x.dtype).reshape(*x.shape[:-1], O)


def _check_weight(name, w):
    if not isinstance(w, Int8Weight):
        raise TypeError(f"{name} takes an Int8Weight (the encoder's W8A8 "
                        f"serving weight), got {type(w).__name__}")
    if w.q.dtype != torch.int8 or w.scale.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes int8 values and fp32 scales, "
                        f"got {w.q.dtype} / {w.scale.dtype}")
    if w.q.dim() != 2 or w.scale.shape != w.q.shape[1:]:
        raise ValueError(f"{name} takes one layer's weight [D, O] with scales "
                         f"[O]; got {tuple(w.q.shape)} / "
                         f"{tuple(w.scale.shape)}")
    if not (w.q.is_contiguous() and w.scale.is_contiguous()):
        raise ValueError(f"{name} kernel takes a contiguous weight")


def _check_launch_args(name, x, w, vectors, residual=None, qk_norm=False):
    _check_weight(name, w)
    D, O = w.q.shape
    if qk_norm and qk_norm_tile(D) is None:
        raise ValueError(f"{name} kernel: qk_norm takes D = c x t with t in "
                         f"{_QK_TILES} and c <= {_MAX_CLUSTER}, got {D}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 x, got {x.dtype}")
    if x.shape[-1] != D or x.numel() == 0:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match the "
                         f"weight {tuple(w.q.shape)}")
    if D % _BK or O % _BN:
        raise ValueError(f"{name} kernel takes D % {_BK} == 0 and O % {_BN} "
                         f"== 0; got D={D}, O={O}")
    if x.numel() // D > 65535 * 128:
        raise ValueError(f"{name} kernel takes at most {65535 * 128} rows")
    for vname, v, n in vectors:
        if v is not None and tuple(v.shape) != (n,):
            raise ValueError(f"{name}: {vname} is {tuple(v.shape)}, expected "
                             f"({n},)")
    if residual is not None and (residual.dtype != torch.bfloat16
                                 or residual.shape[:-1] != x.shape[:-1]
                                 or residual.shape[-1] != O):
        raise ValueError(f"{name} kernel takes a bf16 residual "
                         f"{tuple(x.shape[:-1]) + (O,)}, got "
                         f"{residual.dtype} {tuple(residual.shape)}")
    tensors = [x, w.q, w.scale, residual] + [v for _, v, _ in vectors]
    if any(t is not None and t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all inputs must share a device")


def _vec(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float().contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and 16-byte aligned (the kernel reads 16 bytes a lane)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_norm_quant_gemm(x, norm_w, w: Int8Weight, *, eps: float,
                          epilogue: str = "none", bias=None,
                          qk_norm_w=None) -> torch.Tensor:
    """y = epilogue(rmsnorm(x, norm_w) @ w [+ bias]): x [..., D], w an
    Int8Weight [D, O] → [..., O] in x's dtype. "qk_norm" needs O == 3D
    and qk_norm_w [2, D]."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"fused_norm_quant_gemm: epilogue {epilogue!r}, "
                         f"expected one of {sorted(EPILOGUES)}")
    D = x.shape[-1]
    if epilogue == "qk_norm" and (qk_norm_w is None or w.q.shape[-1] != 3 * D
                                  or tuple(qk_norm_w.shape) != (2, D)):
        raise ValueError("fused_norm_quant_gemm: qk_norm needs O == 3D and "
                         "qk_norm_w [2, D]")
    if x.device.type == "cpu":
        return fused_norm_quant_gemm_reference(
            x, norm_w, w, eps=eps, epilogue=epilogue, bias=bias,
            qk_norm_w=qk_norm_w)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_norm_quant_gemm: no kernel for device "
                           f"{x.device}")
    O = w.q.shape[-1]
    _check_launch_args("fused_norm_quant_gemm", x, w,
                       [("norm_w", norm_w, D), ("bias", bias, O)],
                       qk_norm=epilogue == "qk_norm")
    x2 = _aligned(x.reshape(-1, D))
    M = x2.shape[0]
    out = torch.empty(M, O, dtype=x.dtype, device=x.device)
    x8 = torch.empty(M, D, dtype=torch.int8, device=x.device)
    xs = torch.empty(M, dtype=torch.float32, device=x.device)
    wt = torch.empty(O, D, dtype=torch.int8, device=x.device)
    nw, b = _aligned(_vec(norm_w)), _vec(bias)
    qn = _vec(qk_norm_w.reshape(-1)) if epilogue == "qk_norm" else None
    FUSED_NORM_QUANT_GEMM(
        x2.data_ptr(), nw.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(),
        _ptr(b), _ptr(qn), out.data_ptr(), x8.data_ptr(), xs.data_ptr(),
        wt.data_ptr(), M, D, O, EPILOGUES[epilogue], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    FUSED_NORM_QUANT_GEMM.launches += 1
    return out.reshape(*x.shape[:-1], O)


def fused_quant_gemm_ls_residual(x, w: Int8Weight, bias, ls,
                                 residual) -> torch.Tensor:
    """out = residual + ls * (quant(x) @ w + bias), LayerScale in fp32: x
    [..., D], w an Int8Weight [D, O], residual [..., O] → x's dtype."""
    if x.device.type == "cpu":
        return fused_quant_gemm_ls_residual_reference(x, w, bias, ls,
                                                      residual)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_quant_gemm_ls_residual: no kernel for "
                           f"device {x.device}")
    D, O = x.shape[-1], w.q.shape[-1]
    _check_launch_args("fused_quant_gemm_ls_residual", x, w,
                       [("bias", bias, O), ("ls", ls, O)], residual)
    if ls is None:
        raise ValueError("fused_quant_gemm_ls_residual: ls is required")
    x2 = _aligned(x.reshape(-1, D))
    r2 = residual.reshape(-1, O).contiguous()
    M = x2.shape[0]
    out = torch.empty(M, O, dtype=x.dtype, device=x.device)
    x8 = torch.empty(M, D, dtype=torch.int8, device=x.device)
    xs = torch.empty(M, dtype=torch.float32, device=x.device)
    wt = torch.empty(O, D, dtype=torch.int8, device=x.device)
    b, lsv = _vec(bias), _vec(ls)
    FUSED_QUANT_GEMM_LS_RESIDUAL(
        x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), _ptr(b),
        lsv.data_ptr(), r2.data_ptr(), out.data_ptr(), x8.data_ptr(),
        xs.data_ptr(), wt.data_ptr(), M, D, O,
        torch.cuda.current_stream(x.device).cuda_stream)
    FUSED_QUANT_GEMM_LS_RESIDUAL.launches += 1
    return out.reshape(*x.shape[:-1], O)
