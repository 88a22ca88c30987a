"""int8 weights for serving: quantization, the W8A8 matmul of the encoders
and prefill, and the decode kernel ``int8_matmul`` (K3 and K6 of the JAX
package) with its plain PyTorch version (port of
grounded_video_llm_tpu/ops/int8_matmul.py).

An int8 weight is an ``Int8Weight``: int8 values [..., D, O], symmetric
per-output-channel fp32 scales [..., O] (absmax / 127), the ``w8a8``
marker of the engine's "int8_full" mode and, for an encoder weight with
calibrated static activation scales (serve/calibrate.py), ``x_scale``
[...] (one fp32 scale per layer). Stacked [L, D, O] weights are sliced per
layer as views (``w_q[l]``), so the port has one entry point per kernel and
no layer-indexed twin.

JAX's K3 (``int8_matmul_layer``) and K6 (``int8_matmul``) compute the same
weight-only function; K3 adds a w8a8 branch. The port has one wrapper,
``int8_matmul(x, w_q, scale, w8a8=False)``, over the two C entries of
``csrc/int8_matmul.cu``: weight-only (``INT8_MATMUL``) and w8a8
(``INT8_GEMV``, K3's w8a8 branch), one launch a call, the launch plan
mirrored by ``int8_matmul_plan``. On CPU tensors the wrapper runs the plain
version; on CUDA tensors it launches the branch's kernel (counted in that
kernel's ``launches``) or raises.

The kernel reads the weights by TMA, which needs rows 16 bytes apart: an
int8 weight whose O is not a multiple of 16 (the lm_head's padded
vocabulary) is stored in rows of O rounded up to 16 bytes, and
``Int8Weight.q`` is the [..., D, O] view of them (``empty_int8_weight``;
the quantizer and the weight bridge make every int8 weight so).

The plain version has the kernels' roundings: weight-only sums bf16 x times
int8 w exactly in fp32, scales after the dot and rounds to x's dtype; w8a8
quantizes x per row and sums the int8 products exactly (float64 on the CPU:
the sums reach 127**2 * 8192, past fp32's 2**24), converts the sum to fp32,
then scales.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .cuda_build import CudaKernel

# x rows at or above this go through a full GEMM (dequantized weight-only or
# W8A8), below it through the int8 decode kernel — the JAX package's switch,
# kept for parity (models/llm._matmul_maybe_int8)
INT8_GEMM_MIN_ROWS = 256

# csrc/int8_matmul.cu's launch plan (make_plan), mirrored by
# int8_matmul_plan: columns a tile, weight rows a stage, x rows a pass,
# blocks a cluster, blocks an SM (of an H100's 132) and the shared memory a
# block aims at
_BO, _BK, _MP, _CMAX, _CPORT = 128, 64, 32, 16, 8
_TARGET_BLOCKS = 132 * 2
_SMEM_TARGET = 112 * 1024
_ALIGN = 1024           # a swizzled TMA box starts on 1,024 bytes
_XBOX = 128             # x columns a TMA box, w8a8
_OUT_PITCH = _BO + 4    # floats a row of a block's partial sums


class Int8Weight(NamedTuple):
    """A quantized dense weight."""
    q: torch.Tensor                     # int8 [..., D, O]
    scale: torch.Tensor                 # fp32 [..., O]
    w8a8: bool = False
    x_scale: Optional[torch.Tensor] = None   # fp32 [...], static W8A8

    def layer(self, i: int) -> "Int8Weight":
        return Int8Weight(self.q[i], self.scale[i], self.w8a8,
                          None if self.x_scale is None else self.x_scale[i])


class Int8Embedding(NamedTuple):
    """A quantized embedding table: one fp32 scale per row (token)."""
    q: torch.Tensor                     # int8 [V, D]
    scale: torch.Tensor                 # fp32 [V]


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] → (int8 [..., D], fp32 scales [..., 1]): symmetric absmax
    per row, round half to even, clipped to ±127. absmax / 127 is a true
    division on every device, as the kernels and the JAX package compute
    it (PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, one ulp off for some rows)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = (amax / amax.new_full((), 127.0)).clamp_min(1e-8)
    return torch.round(xf / xs).clamp_(-127, 127).to(torch.int8), xs


def empty_int8_weight(shape, device=None) -> torch.Tensor:
    """An uninitialised int8 weight [..., D, O] whose rows start a multiple
    of 16 bytes apart, as the decode kernel's TMA reads them: where O % 16
    != 0, the [..., :O] view of [..., D, O rounded up to 16] (the pad bytes
    are never read); else a contiguous tensor."""
    *lead, D, O = shape
    pitch = -(-O // 16) * 16
    return torch.empty(*lead, D, pitch, dtype=torch.int8,
                       device=device)[..., :O]


def _quantize_2d(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Quantize w [D, O] into q (int8 [D, O]); return the scales."""
    wf = w.float()
    scale = (wf.abs().amax(dim=-2) / 127.0).clamp_min(1e-8)
    q.copy_(torch.round(wf / scale[None, :]).clamp_(-127, 127))
    return scale


def quantize_weights_int8(w: torch.Tensor,
                          out: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [.., D, O] → (int8 values, fp32 scales [.., O]); symmetric absmax
    per output channel. A stacked weight is quantized one leading slice at
    a time (the scales are per slice), so no fp32 copy of the whole stack
    is made. The values are stored as ``empty_int8_weight`` lays them out,
    or written into ``out`` (int8, w's shape; a slice of a larger buffer),
    which is returned."""
    if out is not None and (out.shape != w.shape
                            or out.dtype != torch.int8):
        raise ValueError(f"quantize_weights_int8: out is {out.dtype}"
                         f"{tuple(out.shape)}, expected int8"
                         f"{tuple(w.shape)}")
    q = empty_int8_weight(w.shape, w.device) if out is None else out
    if w.dim() == 2:
        return q, _quantize_2d(w, q)
    lead = w.shape[:-2]
    flat = w.reshape(-1, *w.shape[-2:])
    q_flat = q.view(-1, *w.shape[-2:])
    scale = torch.empty(flat.shape[0], w.shape[-1], dtype=torch.float32,
                        device=w.device)
    for i in range(flat.shape[0]):
        scale[i] = _quantize_2d(flat[i], q_flat[i])
    return q, scale.reshape(*lead, w.shape[-1])


def _exact_int8_dot(x8: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 sum → fp32 (each sum rounded once, as the int32 →
    fp32 conversion rounds it). float64 holds every such sum exactly."""
    return (x8.double() @ w_q.double()).float()


def _int8_dot(x8: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 x8 [..., D] @ w_q [D, O], exact, → fp32 [..., O]: torch._int_mm
    on CUDA, the float64 product on the CPU."""
    lead = x8.shape[:-1]
    x8 = x8.reshape(-1, x8.shape[-1])
    if x8.device.type == "cuda":
        rows = x8.shape[0]
        if rows <= 16:          # _int_mm takes more than 16 rows
            x8 = torch.cat([x8, x8.new_zeros(17 - rows, x8.shape[1])])
        y = torch._int_mm(x8, w_q)[:rows].float()
    else:
        y = _exact_int8_dot(x8, w_q)
    return y.reshape(*lead, w_q.shape[-1])


def dynamic_int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                        w_scale: torch.Tensor) -> torch.Tensor:
    """W8A8 matmul: per-row dynamic activation int8, an exact int8 x int8
    dot, fp32 rescale → x's dtype. x [..., D], w_q [D, O], w_scale [O].

    The encoders and prefill (rows >= 256) use it, compute-bound GEMMs the
    JAX package leaves to XLA; on CUDA the dot is torch._int_mm, on the CPU
    the exact float64 product."""
    x8, xs = quantize_rows(x)
    return (_int8_dot(x8, w_q) * xs * w_scale).to(x.dtype)


def static_int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor,
                       x_scale: torch.Tensor) -> torch.Tensor:
    """W8A8 matmul with a calibrated static activation scale (a scalar, from
    serve/calibrate.py) in place of the per-row absmax: x8 = clamp(rint(x /
    max(x_scale, 1e-8)), ±127), an exact int8 dot, (dot * xs * w_scale) →
    x's dtype. Inputs past the calibrated range saturate at ±127. The dot
    goes where dynamic_int8_matmul's goes (torch._int_mm on CUDA)."""
    xs = x_scale.float().clamp_min(1e-8)
    x8 = torch.round(x.float() / xs).clamp_(-127, 127).to(torch.int8)
    return (_int8_dot(x8, w_q) * xs * w_scale).to(x.dtype)


def matmul_any(x: torch.Tensor, kernel) -> torch.Tensor:
    """x @ kernel for a dense weight or a W8A8 ``Int8Weight`` (the encoders'
    serving quantization); an ``x_scale`` selects the static-scale
    matmul."""
    if isinstance(kernel, Int8Weight):
        if kernel.x_scale is not None:
            return static_int8_matmul(x, kernel.q, kernel.scale,
                                      kernel.x_scale)
        return dynamic_int8_matmul(x, kernel.q, kernel.scale)
    return x @ kernel


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          scale: torch.Tensor, w8a8: bool = False
                          ) -> torch.Tensor:
    """Weight-only: (x @ w_q) summed in fp32, times the scales, in x's
    dtype. w8a8: x quantized per row, an exact int8 dot, (dot * xs) *
    scale."""
    if not w8a8:
        return ((x.float() @ w_q.float()) * scale).to(x.dtype)
    x8, xs = quantize_rows(x)
    return (_exact_int8_dot(x8, w_q) * xs * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

# gvllm_int8_gemv (w8a8) and gvllm_int8_matmul (weight-only): (x, w, ldw,
# scale, y, M, D, O, stream) -> cudaError_t; ldw is w's row pitch in bytes
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
INT8_GEMV = CudaKernel("int8_matmul.cu", "gvllm_int8_gemv", _ARGTYPES)
INT8_MATMUL = CudaKernel("int8_matmul.cu", "gvllm_int8_matmul", _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class Int8MatmulPlan(NamedTuple):
    """One launch of csrc/int8_matmul.cu: grid (tiles * cluster, passes)."""
    rows: int               # x rows a pass, padded: 8, 16 or 32 (NP)
    passes: int             # ceil(M / 32): each reads the weights once
    tiles: int              # 128-column tiles
    cluster: int            # blocks splitting D (C), summed in rank order
    stages_per_block: int   # 64-row stages of a block's slice (spb)
    stages: int             # the ring's stages
    smem: int               # dynamic shared memory a block, bytes


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def int8_matmul_plan(M: int, D: int, O: int,
                     w8a8: bool) -> Optional[Int8MatmulPlan]:
    """The launch plan of csrc/int8_matmul.cu (make_plan) for x [M, D] and
    a [D, O] weight, or None where the kernel cannot take the shape: D % 8
    != 0, w8a8 with O % 16 != 0, or a w8a8 slice of x (bf16 and int8) that
    leaves no room for two stages in any cluster of up to 16 blocks.
    Clusters of about 264 / (tiles * passes) blocks (one wave, two blocks an
    SM), at most 8 unless shared memory needs more, no more than D's 64-row
    stages; a block's slice of spb stages, as many of them in its ring as
    fit in 112 KB."""
    if M < 1 or D < 8 or D % 8 or O < 1 or (w8a8 and O % 16):
        return None
    NP = 8 if M <= 8 else 16 if M <= 16 else _MP
    passes, tiles = -(-M // _MP), -(-O // _BO)
    stage = _BK * _BO + (0 if w8a8 else NP * 128)
    kst = -(-D // _BK)
    top = min(kst, _CMAX)
    c0 = min(max(min(_TARGET_BLOCKS // (tiles * passes), _CPORT), 1), top)
    for c in range(c0, top + 1):
        spb = -(-kst // c)
        C = -(-kst // spb)
        xb = NP * _round_up(spb * _BK, _XBOX) * 2 if w8a8 else 0
        x8 = _round_up(NP * (spb * _BK + 32), 128) if w8a8 else 0
        stat = ((_CMAX + 1) * _MP + _BO) * 4
        n = min((_SMEM_TARGET - _ALIGN - xb - x8 - stat) // (stage + 16), spb)
        if n < min(spb, 2):
            continue
        out = NP * _OUT_PITCH * 4
        ring = n * stage if n * stage > out else _round_up(out, 128)
        return Int8MatmulPlan(NP, passes, tiles, C, spb, n,
                              _ALIGN + ring + xb + x8 + stat + 16 * n + 16)
    return None


def _check_launch_args(name, x, w_q, scale, w8a8=False):
    if x.device != w_q.device or x.device != scale.device:
        raise ValueError(f"{name}: x, w_q and scale must share a device")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 x, got {x.dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes int8 w_q and fp32 scales, got "
                        f"{w_q.dtype} / {scale.dtype}")
    if x.dim() != 2 or w_q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"{name} kernel takes x [M, D], w_q [D, O], scale "
                         f"[O]; got {tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    M, D = x.shape
    O = w_q.shape[1]
    if w_q.shape[0] != D or scale.shape[0] != O:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)} and scale {tuple(scale.shape)} "
                         "do not match")
    if w_q.stride(1) != 1 or w_q.stride(0) % 16 or w_q.data_ptr() % 16:
        raise ValueError(f"{name} kernel takes w_q rows 16-byte aligned "
                         "(stride (pitch, 1), pitch % 16 == 0: store a "
                         "ragged O with empty_int8_weight); got strides "
                         f"{w_q.stride()}")
    if not scale.is_contiguous():
        raise ValueError(f"{name} kernel takes contiguous scales")
    if w8a8 and O % 16:
        raise ValueError(f"{name} w8a8 kernel takes O % 16 == 0, got {O}")
    if int8_matmul_plan(M, D, O, w8a8) is None:
        raise ValueError(f"{name} kernel has no launch plan for M={M}, "
                         f"D={D}, O={O}{' (w8a8)' if w8a8 else ''}: it takes "
                         "M >= 1, D % 8 == 0 and, w8a8, a slice of x that "
                         "fits beside two stages in a cluster of 16")


def _launch(x, w_q, scale, w8a8, kernel=None):
    """One launch of the branch's kernel; ``kernel`` names another binding
    of the same C entry, whose counter then takes the launch."""
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    M, D = x.shape
    O = w_q.shape[1]
    y = torch.empty(M, O, dtype=x.dtype, device=x.device)
    kernel = kernel or (INT8_GEMV if w8a8 else INT8_MATMUL)
    kernel(x.data_ptr(), w_q.data_ptr(), w_q.stride(0), scale.data_ptr(),
           y.data_ptr(), M, D, O,
           torch.cuda.current_stream(x.device).cuda_stream)
    kernel.launches += 1
    return y


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                w8a8: bool = False) -> torch.Tensor:
    """x [M, D] @ w_q [D, O] × scale [O] → [M, O] in x's dtype, for any M
    below the GEMM switch and any O (the lm_head's ragged vocabulary
    included, its rows 16-byte aligned: ``empty_int8_weight``):
    weight-only, or w8a8 (x quantized per row, O % 16 == 0). CPU tensors
    run the plain version; CUDA tensors launch the branch's kernel, once,
    or raise."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale, w8a8)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_matmul: no kernel for device {x.device}")
    _check_launch_args("int8_matmul", x, w_q, scale, w8a8)
    return _launch(x, w_q, scale, w8a8)
