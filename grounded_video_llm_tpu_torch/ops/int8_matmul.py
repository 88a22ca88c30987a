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
``int8_matmul(x, w_q, scale, w8a8=False)``, over two kernels of
``csrc/int8_matmul.cu``: weight-only (``INT8_MATMUL``) and w8a8
(``INT8_GEMV``, K3's w8a8 branch). On CPU tensors the wrapper runs the plain
version; on CUDA tensors it launches the branch's kernel (counted in that
kernel's ``launches``) or raises.

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

_BLOCK_O = 128          # output columns per block in csrc/int8_matmul.cu
_QUAD_LANES = 32        # 4-row groups walked in parallel by one block


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


def _quantize_2d(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    wf = w.float()
    scale = (wf.abs().amax(dim=-2) / 127.0).clamp_min(1e-8)
    q = torch.round(wf / scale[None, :]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def quantize_weights_int8(w: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [.., D, O] → (int8 values, fp32 scales [.., O]); symmetric absmax
    per output channel. A stacked weight is quantized one leading slice at
    a time (the scales are per slice), so no fp32 copy of the whole stack
    is made."""
    if w.dim() == 2:
        return _quantize_2d(w)
    lead = w.shape[:-2]
    flat = w.reshape(-1, *w.shape[-2:])
    q = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(flat.shape[0], w.shape[-1], dtype=torch.float32,
                        device=w.device)
    for i in range(flat.shape[0]):
        q[i], scale[i] = _quantize_2d(flat[i])
    return q.reshape(w.shape), scale.reshape(*lead, w.shape[-1])


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

# w8a8: gvllm_int8_gemv(x, w, scale, y, x8, xs, part, M, D, O, nsplit,
#                       stream) -> cudaError_t
INT8_GEMV = CudaKernel(
    "int8_matmul.cu", "gvllm_int8_gemv",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# weight-only: gvllm_int8_matmul(x, w, scale, y, part, M, D, O, nsplit,
#                                stream)
INT8_MATMUL = CudaKernel(
    "int8_matmul.cu", "gvllm_int8_matmul",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _m_tile(M: int) -> int:
    return 1 if M <= 1 else 2 if M <= 2 else 4 if M <= 4 else 6 if M <= 6 \
        else 8


def _splits(M: int, D: int, O: int, sms: int) -> int:
    """Split the D rows over enough blocks for two per SM; each split keeps
    at least one pass of the block's 32 four-row groups."""
    tiles = -(-O // _BLOCK_O) * -(-M // _m_tile(M))
    want = -(-2 * sms // tiles)
    return max(1, min(want, (D // 4) // _QUAD_LANES))


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
    if w_q.shape[0] != D or scale.shape[0] != w_q.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)} and scale {tuple(scale.shape)} "
                         "do not match")
    if M == 0 or D % 4:
        raise ValueError(f"{name} kernel takes M >= 1 and D % 4 == 0; got "
                         f"M={M}, D={D}")
    if not (w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous w_q and scale")
    if w8a8 and w_q.shape[1] % 16:
        raise ValueError(f"{name} w8a8 kernel takes O % 16 == 0, got "
                         f"{w_q.shape[1]}")


def _launch(x, w_q, scale, w8a8):
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    M, D = x.shape
    O = w_q.shape[1]
    nsplit = _splits(M, D, O, _sm_count(x.device.index or 0))
    y = torch.empty(M, O, dtype=x.dtype, device=x.device)
    part = torch.empty(nsplit, M, O, dtype=torch.int32 if w8a8
                       else torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if w8a8:
        x8 = torch.empty(M, D, dtype=torch.int8, device=x.device)
        xs = torch.empty(M, dtype=torch.float32, device=x.device)
        INT8_GEMV(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                  y.data_ptr(), x8.data_ptr(), xs.data_ptr(),
                  part.data_ptr(), M, D, O, nsplit, stream)
        INT8_GEMV.launches += 1
    else:
        INT8_MATMUL(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                    y.data_ptr(), part.data_ptr(), M, D, O, nsplit, stream)
        INT8_MATMUL.launches += 1
    return y


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                w8a8: bool = False) -> torch.Tensor:
    """x [M, D] @ w_q [D, O] × scale [O] → [M, O] in x's dtype, for any M
    below the GEMM switch and any O (the lm_head's ragged vocabulary
    included): weight-only, or w8a8 (x quantized per row, O % 16 == 0).
    CPU tensors run the plain version; CUDA tensors launch the branch's
    kernel or raise."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale, w8a8)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_matmul: no kernel for device {x.device}")
    _check_launch_args("int8_matmul", x, w_q, scale, w8a8)
    return _launch(x, w_q, scale, w8a8)
