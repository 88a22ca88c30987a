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
// M1  gvllm_i8i8_gemv          replaces scripts/microbench_decode.py:85
//     (`i8i8_matmul`, `_i8i8_kernel` :64): the decode-shaped x [M<=16,K]
//     bf16, quantized per row as above, then int8 x int8 on the tensor cores
//     with the rows padded to one 16-row m tile; y = float(acc) * xs * s[n]
//     -> bf16. This is the function the script's docstring names; the TPU
//     prototype multiplies its output by a zero placeholder and returns
//     zeros, a fault of the reference the port does not reproduce.
//
// What bounds them on an H100. M3/M3d at the encoder shapes (M 8192, K
// 1408, N 6144 and the transpose) do 2MKN = 142 GOP against ~70 MB of
// bytes: ~2,000 operations per byte, far above the int8 ridge (~590), so
// the int8 tensor-core rate (1,979 TOP/s) is the limit. M1 reads each
// weight byte once for at most 16 rows: ~32 operations per byte, so the
// weight stream at 3.35 TB/s is the limit.
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
// M1: three launches. A warp per row quantizes x into a 16-row int8
// scratch (rows >= M are zero) and its scales; the GEMV splits K over
// blocks (grid.y) so the skinny N of the down projection still fills the
// card, each block of 4 warps owns 128 columns and its K chunk of the int8
// rows in shared memory, each warp 32 columns: per k32 step it loads its
// 32 x 32 weight bytes as 4 x 4 blocks (a full 32-byte sector per 8
// lanes), transposes them through a small per-warp shared buffer into B
// fragments, and runs four m16n8k32 products; the int32 partial sums go to
// scratch, and a last kernel adds the splits in order (exact in int32) and
// rescales. All three are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_wgmma.cuh"

namespace {

// ---- M1 ----
constexpr int GV_THREADS = 256;       // quantize and finish kernels
constexpr int GV_ROWS = 16;           // one m16 tile
constexpr int GV_WARPS = 4;
constexpr int GV_BN = 32 * GV_WARPS;  // columns per block
constexpr int GV_LDB = 9;             // per-warp B stage: [32 cols][8 + 1]

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// r[j] holds 4 column bytes of row j; t[c] gets the 4 row bytes of column c
__device__ __forceinline__ void transpose4x4(const uint32_t* r, uint32_t* t) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// ---------------------------------------------------------------------------
// M1: quantize rows, split-K tensor-core GEMV, sum and rescale
// ---------------------------------------------------------------------------

// one warp per row of the 16-row tile; rows >= M are written as zeros
__global__ void __launch_bounds__(GV_THREADS)
gv_quant_kernel(const bf16* __restrict__ x, int8_t* __restrict__ x8,
                float* __restrict__ xs, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (GV_THREADS / 32) + (threadIdx.x >> 5);
  if (m >= GV_ROWS) return;
  int8_t* out = x8 + (size_t)m * K;
  if (m >= M) {
    for (int k = lane; k < K; k += 32) out[k] = 0;
    if (lane == 0) xs[m] = 1.f;
    return;
  }
  const bf16* xr = x + (size_t)m * K;
  float amax = 0.f;
  for (int k = lane; k < K; k += 32)
    amax = fmaxf(amax, fabsf(__bfloat162float(xr[k])));
  amax = warp_max(amax);
  const float s = fmaxf(amax / 127.f, 1e-8f);
  for (int k = lane; k < K; k += 32)
    out[k] = (int8_t)(int)fminf(
        fmaxf(rintf(__bfloat162float(xr[k]) / s), -127.f), 127.f);
  if (lane == 0) xs[m] = s;
}

// grid (ceil(N / 128), nsplit); block 4 warps; split y takes k in
// [y * kc, min(K, (y + 1) * kc)); part [nsplit, 16, N] int32
__global__ void __launch_bounds__(GV_WARPS * 32)
gv_gemv_kernel(const int8_t* __restrict__ x8, const int8_t* __restrict__ w,
               int* __restrict__ part, int M, int K, int N, int kc) {
  extern __shared__ __align__(16) unsigned char gv_smem[];
  const int lda = kc + 16;                             // bytes; kc % 128 == 0
  int8_t* sA = reinterpret_cast<int8_t*>(gv_smem);     // [16][lda]
  uint32_t* sB = reinterpret_cast<uint32_t*>(gv_smem + GV_ROWS * lda) +
                 (threadIdx.x >> 5) * (32 * GV_LDB);   // this warp's stage

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int kb = blockIdx.y * kc;
  const int klen = min(kc, K - kb);
  const int nw = blockIdx.x * GV_BN + warp * 32;       // this warp's columns

  // the 16 int8 rows of this K chunk into shared memory
  for (int c = threadIdx.x; c < GV_ROWS * (klen / 16); c += GV_WARPS * 32) {
    const int r = c / (klen / 16), col = (c % (klen / 16)) * 16;
    *reinterpret_cast<uint4*>(sA + r * lda + col) =
        *reinterpret_cast<const uint4*>(x8 + (size_t)r * K + kb + col);
  }
  __syncthreads();

  // lane L loads the 4 x 4 blocks (column group L & 7, row groups
  // (L >> 3) and (L >> 3) + 4) of each k32 x 32 step
  const int cg = lane & 7;
  const bool col_live = nw + cg * 4 < N;
  uint32_t cur[2][4], nxt[2][4];
  auto load = [&](uint32_t (&dst)[2][4], int k) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kg = (lane >> 3) + 4 * i;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          w + (size_t)(kb + k + kg * 4) * N + nw + cg * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dst[i][r] = col_live ? __ldg(src + (size_t)r * (N / 4)) : 0u;
    }
  };

  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  const uint32_t* sA32 = reinterpret_cast<const uint32_t*>(sA);
  const int ldaw = lda / 4;
  load(cur, 0);
  for (int k = 0; k < klen; k += 32) {
    if (k + 32 < klen) load(nxt, k + 32);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kg = (lane >> 3) + 4 * i;
      uint32_t t[4];
      transpose4x4(cur[i], t);
#pragma unroll
      for (int c = 0; c < 4; ++c) sB[(cg * 4 + c) * GV_LDB + kg] = t[c];
    }
    __syncwarp();
    uint32_t a[4];
    const int kw = k / 4;
    a[0] = sA32[g * ldaw + kw + tig];
    a[1] = sA32[(g + 8) * ldaw + kw + tig];
    a[2] = sA32[g * ldaw + kw + 4 + tig];
    a[3] = sA32[(g + 8) * ldaw + kw + 4 + tig];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[2];
      b[0] = sB[(8 * j + g) * GV_LDB + tig];
      b[1] = sB[(8 * j + g) * GV_LDB + 4 + tig];
      mma_s8(acc[j], a, b);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) cur[i][r] = nxt[i][r];
  }

  // acc[j][2h + e]: row g + 8h, column nw + 8j + 2 tig + e
  int* out = part + (size_t)blockIdx.y * GV_ROWS * N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = nw + 8 * j + 2 * tig;
    if (n >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = g + 8 * h;
      if (m < M)
        *reinterpret_cast<int2*>(out + (size_t)m * N + n) =
            make_int2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(GV_THREADS)
gv_finish_kernel(const int* __restrict__ part, const float* __restrict__ xs,
                 const float* __restrict__ ws, bf16* __restrict__ y, int M,
                 int N, int nsplit) {
  const int i = blockIdx.x * GV_THREADS + threadIdx.x;
  if (i >= M * N) return;
  const int m = i / N, n = i % N;
  int acc = 0;
  for (int s = 0; s < nsplit; ++s) acc += part[((size_t)s * GV_ROWS + m) * N + n];
  y[i] = __float2bfloat16_rn((float)acc * xs[m] * ws[n]);
}

}  // namespace

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

// M1: x [M<=16,K] bf16, w [K,N] int8, s [N] fp32 -> y [M,N] bf16. Scratch
// from the caller: x8 [16,K] int8, xs [16] fp32, part [ceil(K/kc),16,N]
// int32. K % 32 == 0, N % 16 == 0, kc % 128 == 0.
extern "C" int gvllm_i8i8_gemv(const void* x, const void* w, const void* s,
                               void* y, void* x8, void* xs, void* part, int M,
                               int K, int N, int kc, void* stream) {
  if (M < 1 || M > GV_ROWS || K < 32 || K % 32 || N < 16 || N % 16 ||
      kc < 128 || kc % 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nsplit = (K + kc - 1) / kc;
  gv_quant_kernel<<<GV_ROWS / (GV_THREADS / 32), GV_THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(x8),
      static_cast<float*>(xs), M, K);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int smem = GV_ROWS * (kc + 16) + GV_WARPS * 32 * GV_LDB * 4;
  err = (int)cudaFuncSetAttribute(
      gv_gemv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  dim3 grid((N + GV_BN - 1) / GV_BN, nsplit);
  gv_gemv_kernel<<<grid, GV_WARPS * 32, smem, st>>>(
      static_cast<const int8_t*>(x8), static_cast<const int8_t*>(w),
      static_cast<int*>(part), M, K, N, kc);
  err = (int)cudaGetLastError();
  if (err) return err;
  gv_finish_kernel<<<(M * N + GV_THREADS - 1) / GV_THREADS, GV_THREADS, 0,
                     st>>>(
      static_cast<const int*>(part), static_cast<const float*>(xs),
      static_cast<const float*>(s), static_cast<bf16*>(y), M, N, nsplit);
  return (int)cudaGetLastError();
}
