"""int8 x int8 GEMMs of the port's microbenchmarks (kernels M1, M3 and M3d,
csrc/int8_gemm.cu) with their plain PyTorch versions.

  int8_gemm(x8, w, s)          M3, scripts/microbench_int8_gemm.py:128
                               (`_pl_kernel`): pre-quantized int8 x [M, K]
                               @ int8 w [K, N] → int32 → fp32 × s[N] → bf16
  int8_gemm_dynamic(x, w, s)   M3d, the same script's :165
                               (`_pl_dyn_kernel`): bf16 x quantized per row
                               inside the GEMM program (for K <= 1,792 once
                               per block into shared memory); the function
                               of dynamic_int8_matmul with bf16 output
  i8i8_matmul(x, w, s)         M1, scripts/microbench_decode.py:85
                               (`i8i8_matmul`): the decode-shaped W8A8 GEMV,
                               x [M <= 16, K], on the int8 tensor cores

M1 computes what the script's docstring says: per-row int8 quantization,
an int8 x int8 dot, then float(dot) * xs * s → bf16. The TPU prototype
multiplies every output by a zeros placeholder (`:69-70`, `:90`, `:97`) and
returns zeros; the port does not reproduce that fault.

CPU tensors run the plain version; CUDA tensors launch the kernel (counted
in its ``launches``) or raise. The plain versions sum the int8 products
exactly (float64: 1,408 products of 127**2 pass fp32's 2**24) and round as
the kernels do.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel
from .int8_matmul import _exact_int8_dot, _sm_count, quantize_rows

GEMM_BK, GEMM_BN = 64, 128      # K step and column tile of the M3 kernels
GEMM_BM = 128                   # rows per block (M3, M3d with K > RES_KMAX)
RES_BM, RES_KMAX = 64, 1792     # M3d with its int8 rows resident in shared
                                # memory: rows per block, largest K
GEMV_ROWS = 16                  # M1's m tile
GEMV_BN = 128                   # M1's columns per block

# gvllm_int8_gemm(x8, w, s, y, M, K, N, stream) -> cudaError_t
INT8_GEMM = CudaKernel("int8_gemm.cu", "gvllm_int8_gemm",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
# gvllm_int8_gemm_dynamic(x, w, s, y, M, K, N, stream)
INT8_GEMM_DYNAMIC = CudaKernel("int8_gemm.cu", "gvllm_int8_gemm_dynamic",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                               + [ctypes.c_void_p])
# gvllm_i8i8_gemv(x, w, s, y, x8, xs, part, M, K, N, kc, stream)
I8I8_GEMV = CudaKernel("int8_gemm.cu", "gvllm_i8i8_gemv",
                       [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])


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
    bm = (RES_BM if x_dtype == torch.bfloat16 and K <= RES_KMAX
          else GEMM_BM)
    if M < 1 or K % GEMM_BK or N % GEMM_BN or -(-M // bm) > 65535:
        raise ValueError(f"{name} kernel takes 1 <= M <= {65535 * bm}, "
                         f"K % {GEMM_BK} == 0 and N % {GEMM_BN} == 0; got "
                         f"M={M}, K={K}, N={N}")


def _check_gemv_args(x, w, s):
    _check_common("i8i8_matmul", x, w, s, torch.bfloat16)
    M, K = x.shape
    N = w.shape[1]
    if not 1 <= M <= GEMV_ROWS:
        raise ValueError(f"i8i8_matmul kernel takes 1 <= M <= {GEMV_ROWS} "
                         f"rows (one m16 tile), got {M}")
    if K % 32 or N % 16:
        raise ValueError(f"i8i8_matmul kernel takes K % 32 == 0 and "
                         f"N % 16 == 0, got K={K}, N={N}")


def _no_kernel(name, device):
    return RuntimeError(f"{name}: no kernel for device {device}")


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _gemm(kernel, name, x, w, s, x_dtype):
    _check_gemm_args(name, x, w, s, x_dtype)
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    kernel(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), M, K, N,
           torch.cuda.current_stream(x.device).cuda_stream)
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
    """M3d: bf16 x [M, K], quantized per row inside the GEMM, @ int8 w
    [K, N] × s [N] → bf16 [M, N]."""
    if x.device.type == "cpu":
        return int8_gemm_dynamic_reference(x, w, s)
    if x.device.type != "cuda":
        raise _no_kernel("int8_gemm_dynamic", x.device)
    return _gemm(INT8_GEMM_DYNAMIC, "int8_gemm_dynamic", x, w, s,
                 torch.bfloat16)


def gemv_chunk(K: int, N: int, sms: int) -> int:
    """M1's K chunk per split (a multiple of 128): enough blocks for about
    four per SM over ceil(N / 128) column blocks."""
    col_blocks = -(-N // GEMV_BN)
    nsplit = max(1, -(-4 * sms // col_blocks))
    per_split = -(-K // nsplit)
    return -(-per_split // 128) * 128


def i8i8_matmul(x: torch.Tensor, w: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """M1: bf16 x [M <= 16, K] → per-row int8 → int8 x int8 tensor-core
    GEMV → float(dot) * xs * s → bf16 [M, N] (N % 16 == 0)."""
    if x.device.type == "cpu":
        return i8i8_matmul_reference(x, w, s)
    if x.device.type != "cuda":
        raise _no_kernel("i8i8_matmul", x.device)
    _check_gemv_args(x, w, s)
    M, K = x.shape
    N = w.shape[1]
    kc = gemv_chunk(K, N, _sm_count(x.device.index or 0))
    nsplit = -(-K // kc)
    dev = x.device
    y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    x8 = torch.empty(GEMV_ROWS, K, dtype=torch.int8, device=dev)
    xs = torch.empty(GEMV_ROWS, dtype=torch.float32, device=dev)
    part = torch.empty(nsplit, GEMV_ROWS, N, dtype=torch.int32, device=dev)
    I8I8_GEMV(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
              x8.data_ptr(), xs.data_ptr(), part.data_ptr(), M, K, N, kc,
              torch.cuda.current_stream(dev).cuda_stream)
    I8I8_GEMV.launches += 1
    return y
