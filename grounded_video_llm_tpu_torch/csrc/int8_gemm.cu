// int8 x int8 GEMMs of the port's microbenchmarks, Hopper (sm_90a).
//
// M3  gvllm_int8_gemm          replaces scripts/microbench_int8_gemm.py:128
//     (`_pl_kernel` :120): x8 [M,K] int8 (quantized beforehand) @ w [K,N]
//     int8 -> exact int32 -> float(acc) * s[n] -> bf16.
// M3d gvllm_int8_gemm_dynamic  replaces the same script's :165
//     (`_pl_dyn_kernel` :154): x [M,K] bf16 quantized per row inside the
//     GEMM program, xs = max(absmax / 127, 1e-8), x8 = clamp(rint(x / xs),
//     +-127); y = float(acc) * xs * s[n] -> bf16 (dynamic_int8_matmul's
//     function and rounding order).
// M1, the third microbenchmark GEMM (scripts/microbench_decode.py:85,
// `i8i8_matmul`, `_i8i8_kernel` :64: the decode-shaped x [M<=16,K] bf16
// quantized per row as above, int8 x int8 on the tensor cores, y =
// float(acc) * xs * s[n] -> bf16), has no code here: it is the function of
// K3's w8a8 branch in the same rounding order, so ops/int8_gemm.i8i8_matmul
// launches gvllm_int8_gemv of int8_matmul.cu (one launch a call, the
// weights streamed by TMA, int8 mma.sync).
//
// What bounds them on an H100. M3/M3d at the encoder shapes (M 8192, K
// 1408, N 6144 and the transpose) do 2MKN = 142 GOP against ~70 MB of
// bytes: ~2,000 operations per byte, far above the int8 ridge (~590), so
// the int8 tensor-core rate (1,979 TOP/s) is the limit.
//
// Design. M3 and M3d run the port's one int8 GEMM for large M
// (int8_wgmma.cuh, which K10 runs too): int8 wgmma on 128 x BN tiles fed
// by a TMA producer warpgroup through a 4-stage ring, a TMA-store
// epilogue. M3 is two launches: the weight transposed K-major into scratch
// wt [N, K] (wgmma takes 8-bit operands K-major only), then the GEMM on x8
// with the EPI_STATIC epilogue (no row scale). M3d is three: the rows
// kernel quantizes x into scratch x8 [M, K] and xs [M] (no norm), then
// the transpose and the GEMM with the plain epilogue, K10's ls_residual
// function without bias, LayerScale or residual. One route serves every K.
// Chosen by measurement (PERF.md): the mma.sync GEMM these entries
// ran before (a 128 x 128 tile of 8 warps, global loads staged through
// registers, each weight tile transposed with byte permutes in every block,
// M3d's rows quantized inside the GEMM) reached 14% (M3) and 4-10% (M3d)
// of the int8 bound at the encoder shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_wgmma.cuh"

// M3: x8 [M,K] int8, w [K,N] int8, s [N] fp32 -> y [M,N] bf16. Scratch
// from the caller: wt [N,K] int8 (the weight, K-major). K % 64 == 0,
// N % 128 == 0, M <= 65,535 * 128.
extern "C" int gvllm_int8_gemm(const void* x8, const void* w, const void* s,
                               void* y, void* wt, int M, int K, int N,
                               void* stream) {
  if (!shapes_ok(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_transpose(w, static_cast<int8_t*>(wt), K, N, st);
  if (err) return err;
  Args a{nullptr, static_cast<const float*>(s), nullptr, nullptr, nullptr,
         nullptr, static_cast<bf16*>(y), M, N, K, 0.f};
  return launch_gemm<EPI_STATIC>(a, static_cast<const int8_t*>(x8),
                                 static_cast<const int8_t*>(wt), st);
}

// M3d: x [M,K] bf16 quantized per row, w, s -> y [M,N] bf16. Scratch from
// the caller: x8 [M,K] int8, xs [M] fp32, wt [N,K] int8. Shapes as M3's.
extern "C" int gvllm_int8_gemm_dynamic(const void* x, const void* w,
                                       const void* s, void* y, void* x8,
                                       void* xs, void* wt, int M, int K,
                                       int N, void* stream) {
  if (!shapes_ok(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_rows(x, nullptr, static_cast<int8_t*>(x8),
                        static_cast<float*>(xs), M, K, 0.f, st);
  if (err) return err;
  err = launch_transpose(w, static_cast<int8_t*>(wt), K, N, st);
  if (err) return err;
  Args a{static_cast<const float*>(xs), static_cast<const float*>(s), nullptr,
         nullptr, nullptr, nullptr, static_cast<bf16*>(y), M, N, K, 0.f};
  return launch_gemm<EPI_NONE>(a, static_cast<const int8_t*>(x8),
                               static_cast<const int8_t*>(wt), st);
}
