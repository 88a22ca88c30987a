"""int8 x int8 GEMMs of the port's microbenchmarks (kernels M1, M3 and M3d,
csrc/int8_gemm.cu) with their plain PyTorch versions.

  int8_gemm(x8, w, s)          M3, scripts/microbench_int8_gemm.py:128
                               (`_pl_kernel`): pre-quantized int8 x [M, K]
                               @ int8 w [K, N] → int32 → fp32 × s[N] → bf16
  int8_gemm_dynamic(x, w, s)   M3d, the same script's :165
                               (`_pl_dyn_kernel`): bf16 x quantized per row,
                               then the same product; the function of
                               dynamic_int8_matmul with bf16 output
  i8i8_matmul(x, w, s)         M1, scripts/microbench_decode.py:85
                               (`i8i8_matmul`): the decode-shaped W8A8 GEMV,
                               x [M <= 16, K], on the int8 tensor cores,
                               served on K3's w8a8 kernel

M3 and M3d run the port's one int8 GEMM for large M (csrc/int8_wgmma.cuh,
which K10 in ops/fused_block runs too): the weight transposed K-major into
scratch, M3d's rows quantized into scratch, then int8 wgmma fed by TMA
(``int8_gemm_plan`` mirrors the launch). The transposed weight is made
again in every call, never cached.

M1 computes what the script's docstring says: per-row int8 quantization,
an int8 x int8 dot, then float(dot) * xs * s → bf16. The TPU prototype
multiplies every output by a zeros placeholder (`:69-70`, `:90`, `:97`) and
returns zeros; the port does not reproduce that fault. That is the function
of K3's w8a8 branch (ops/int8_matmul.int8_matmul(w8a8=True)) in the same
rounding order, so M1 launches that kernel (csrc/int8_matmul.cu,
``gvllm_int8_gemv``: one launch a call, the weights streamed by TMA, int8
mma.sync) through a binding of its own, ``I8I8_GEMV``, whose ``launches``
count M1's calls apart from K3's.

CPU tensors run the plain version; CUDA tensors launch the kernel (counted
in its ``launches``) or raise. The plain versions sum the int8 products
exactly (float64: 1,408 products of 127**2 pass fp32's 2**24) and round as
the kernels do.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import int8_matmul as mm
from .cuda_build import CudaKernel
from .fused_block import output_tile
from .int8_matmul import _ARGTYPES, _exact_int8_dot, quantize_rows

# csrc/int8_wgmma.cuh: K in multiples of the weight transpose's 64-byte
# tile; 128-row output tiles, the K steps of 128 bytes in a 4-stage ring
GEMM_BK, GEMM_BM, GEMM_STEP, GEMM_STAGES = 64, 128, 128, 4
GEMM_MAX_ROW_BLOCKS = 65535     # the grid's y dimension
GEMV_ROWS = 16                  # M1's rows: the microbenchmark's m tile

# gvllm_int8_gemm(x8, w, s, y, wt, M, K, N, stream) -> cudaError_t
INT8_GEMM = CudaKernel("int8_gemm.cu", "gvllm_int8_gemm",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
# gvllm_int8_gemm_dynamic(x, w, s, y, x8, xs, wt, M, K, N, stream)
INT8_GEMM_DYNAMIC = CudaKernel("int8_gemm.cu", "gvllm_int8_gemm_dynamic",
                               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                               + [ctypes.c_void_p])
# M1 on K3's w8a8 entry: gvllm_int8_gemv(x, w, ldw, scale, y, M, D, O,
# stream) of csrc/int8_matmul.cu, bound again so M1 keeps its own counter
I8I8_GEMV = CudaKernel("int8_matmul.cu", "gvllm_int8_gemv", _ARGTYPES)


class Int8GemmPlan(NamedTuple):
    """One call of M3 (2 device kernels) or M3d (3) on csrc/int8_wgmma.cuh."""
    tile_n: int                 # output tile width BN: 256, 176 or 128
    grid: Tuple[int, int]       # the GEMM's (N / BN, ceil(M / 128))
    smem: int                   # the GEMM's dynamic shared memory, bytes
    scratch: int                # wt [N, K] (+ M3d's x8 [M, K], xs [M]), bytes
    kernels: int                # device kernels a call


def int8_gemm_plan(M: int, K: int, N: int,
                   dynamic: bool) -> Optional[Int8GemmPlan]:
    """The launch of M3 (dynamic=False) or M3d on x [M, K] and w [K, N]
    (csrc/int8_gemm.cu over int8_wgmma.cuh's Tiles and launch_gemm), or
    None where the kernels cannot take the shape: K not a positive multiple
    of 64, N no multiple of 128, or more than 65,535 row blocks of 128."""
    bn = output_tile(N)
    rows = -(-M // GEMM_BM)
    if M < 1 or K < GEMM_BK or K % GEMM_BK or bn is None \
            or rows > GEMM_MAX_ROW_BLOCKS:
        return None
    smem = GEMM_STAGES * (GEMM_BM + bn) * GEMM_STEP + 128 + GEMM_BM * 4 + 1024
    scratch = N * K + ((M * K + 4 * M) if dynamic else 0)
    return Int8GemmPlan(bn, (N // bn, rows), smem, scratch,
                        3 if dynamic else 2)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def int8_gemm_reference(x8: torch.Tensor, w: torch.Tensor,
                        s: torch.Tensor) -> torch.Tensor:
    """(exact x8 @ w) as fp32, times s, → bf16."""
    return (_exact_int8_dot(x8, w) * s).to(torch.bfloat16)


def int8_gemm_dynamic_reference(x: torch.Tensor, w: torch.Tensor,
                                s: torch.Tensor) -> torch.Tensor:
    """Per-row quantization of x, (exact dot * xs) * s → x's dtype."""
    x8, xs = quantize_rows(x)
    return (_exact_int8_dot(x8, w) * xs * s).to(x.dtype)


i8i8_matmul_reference = int8_gemm_dynamic_reference


# ---------------------------------------------------------------------------
# Launch checks
# ---------------------------------------------------------------------------


def _check_common(name, x, w, s, x_dtype):
    if x.device != w.device or x.device != s.device:
        raise ValueError(f"{name}: x, w and s must share a device")
    if x.dtype != x_dtype:
        raise TypeError(f"{name} kernel takes {x_dtype} x, got {x.dtype}")
    if w.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes int8 w and fp32 s, got "
                        f"{w.dtype} / {s.dtype}")
    if x.dim() != 2 or w.dim() != 2 or s.dim() != 1:
        raise ValueError(f"{name} kernel takes x [M, K], w [K, N], s [N]; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(s.shape)}")
    if w.shape[0] != x.shape[1] or s.shape[0] != w.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"and s {tuple(s.shape)} do not match")
    if not (x.is_contiguous() and w.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous x, w and s")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name} kernel takes 16-byte aligned x and w")


def _check_gemm_args(name, x, w, s, x_dtype):
    _check_common(name, x, w, s, x_dtype)
    M, K = x.shape
    N = w.shape[1]
    if int8_gemm_plan(M, K, N, x_dtype == torch.bfloat16) is None:
        raise ValueError(f"{name} kernel takes 1 <= M <= "
                         f"{GEMM_MAX_ROW_BLOCKS * GEMM_BM}, K % {GEMM_BK} == "
                         f"0 and N % 128 == 0; got M={M}, K={K}, N={N}")


def _check_gemv_args(x, w, s):
    """What K3's w8a8 launch refuses, then M1's own contract: M <= 16 and
    K % 32 == 0."""
    mm._check_launch_args("i8i8_matmul", x, w, s, True)
    M, K = x.shape
    if not 1 <= M <= GEMV_ROWS:
        raise ValueError(f"i8i8_matmul kernel takes 1 <= M <= {GEMV_ROWS} "
                         f"rows (one m16 tile), got {M}")
    if K % 32:
        raise ValueError(f"i8i8_matmul kernel takes K % 32 == 0, got {K}")


def _no_kernel(name, device):
    return RuntimeError(f"{name}: no kernel for device {device}")


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _gemm(kernel, name, x, w, s, x_dtype):
    _check_gemm_args(name, x, w, s, x_dtype)
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    wt = torch.empty(N, K, dtype=torch.int8, device=dev)
    rows = ()
    if x_dtype == torch.bfloat16:
        x8 = torch.empty(M, K, dtype=torch.int8, device=dev)
        xs = torch.empty(M, dtype=torch.float32, device=dev)
        rows = (x8.data_ptr(), xs.data_ptr())
    kernel(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), *rows,
           wt.data_ptr(), M, K, N, torch.cuda.current_stream(dev).cuda_stream)
    kernel.launches += 1
    return y


def int8_gemm(x8: torch.Tensor, w: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """M3: int8 x8 [M, K] @ int8 w [K, N] × s [N] → bf16 [M, N]. CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    if x8.device.type == "cpu":
        return int8_gemm_reference(x8, w, s)
    if x8.device.type != "cuda":
        raise _no_kernel("int8_gemm", x8.device)
    return _gemm(INT8_GEMM, "int8_gemm", x8, w, s, torch.int8)


def int8_gemm_dynamic(x: torch.Tensor, w: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """M3d: bf16 x [M, K], quantized per row, @ int8 w [K, N] × s [N] →
    bf16 [M, N]."""
    if x.device.type == "cpu":
        return int8_gemm_dynamic_reference(x, w, s)
    if x.device.type != "cuda":
        raise _no_kernel("int8_gemm_dynamic", x.device)
    return _gemm(INT8_GEMM_DYNAMIC, "int8_gemm_dynamic", x, w, s,
                 torch.bfloat16)


def i8i8_matmul(x: torch.Tensor, w: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """M1: bf16 x [M <= 16, K] → per-row int8 → int8 x int8 tensor-core
    GEMV → float(dot) * xs * s → bf16 [M, N] (N % 16 == 0), one launch of
    K3's w8a8 kernel."""
    if x.device.type == "cpu":
        return i8i8_matmul_reference(x, w, s)
    if x.device.type != "cuda":
        raise _no_kernel("i8i8_matmul", x.device)
    _check_gemv_args(x, w, s)
    return mm._launch(x, w, s, True, kernel=I8I8_GEMV)
