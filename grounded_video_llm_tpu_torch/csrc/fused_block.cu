// Fused W8A8 InternVideo2-block GEMMs, Hopper (sm_90a): int8 wgmma and TMA.
//
// K10: replaces grounded_video_llm_tpu/ops/fused_block.py
//   fused_norm_quant_gemm        (`_nqg_kernel`)  -> gvllm_fused_norm_quant_gemm
//   fused_quant_gemm_ls_residual (`_qglr_kernel`) -> gvllm_fused_quant_gemm_ls_residual
//
// Contract (x [M,K] bf16, w [K,N] int8 row-major, ws [N] fp32, all fp32
// vectors below):
//   rows:  h = x * (1 / sqrt(mean(x^2) + eps)) * norm_w in fp32 (the norm is
//          skipped for the ls_residual entry), then per row
//          s = max(absmax(h) / 127, 1e-8), x8 = clamp(rint(h / s), -127, 127)
//          with no bf16 rounding in between;
//   dot:   acc = x8 @ w exactly in int32; y = float(acc) * s * ws[n] (+ bias);
//   epilogue "none": y; "gelu": 0.5 y (1 + erf(y / sqrt 2)) with the
//          Abramowitz-Stegun rational erf of the JAX kernel; "qk_norm"
//          (N = 3K): each K-wide q and k third of the fp32 row y is RMS
//          normalised, y * (1 / sqrt(mean(y^2) + eps)) * qn[third], the v
//          third passes; ls_residual: y * ls[n] + residual[m, n];
//   output bf16.
//
// What bounds it on an H100: the int8 tensor-core rate (1,979 TOP/s) for
// qkv, fc1 and fc2 at path D's 147,528 rows; proj (K = N = 1,408) is close
// to the byte bound. wgmma is the only instruction that reaches the
// tensor cores' full int8 rate.
//
// Design. Three launches per call, all on the caller's stream:
//  1. rows: a warp (K <= 2,048) or a block (any longer K) per row writes
//     the int8 row and its fp32 scale (x8, xs scratch), the row held in
//     registers up to K = 6,144 so device memory is read once. The TPU
//     kernel keeps a quantized row tile in VMEM across the N blocks; here
//     the GEMM's A operand arrives by TMA, so the rows are written once and
//     read by every column block. Chosen by measurement: a GEMM that
//     quantized its block's 128 rows into resident shared memory (K =
//     1,408) was bit-equal and 4.3-8.5x slower at qkv, fc1 and proj, since
//     every column block redoes its rows' work before its first product
//     and 227 KB of shared memory leaves no room to overlap it (PERF.md).
//  2. the weight, K-major: wgmma takes 8-bit operands from shared memory
//     only K-major (the transpose bit exists for 16-bit types), and the
//     weight is stored [K, N] with N contiguous. A transpose kernel writes
//     wt [N, K] into scratch, 64 x 64-byte tiles through shared memory:
//     K * N bytes read and written per call (0.05 GB per block of four
//     GEMMs at IV2-1B's widths), so the unfused route and the static
//     scales keep reading the [K, N] weight they read today and no second
//     copy is held.
//  3. the GEMM, one 384-thread block per SM: warpgroup 2 is the producer
//     (one thread issues TMA loads of 128 x 128-byte x8 tiles and BN x
//     128-byte wt tiles, 128-byte swizzle, into a ring of four stages paced
//     by full and empty mbarriers; setmaxnreg.dec 24); warpgroups 0 and 1
//     are the consumers (setmaxnreg.inc 240), 64 rows each, running wgmma
//     m64nBNk32 s8 x s8 -> s32 with both operands K-major from shared
//     memory, one commit group per stage and one group kept in flight, the
//     accumulators in registers. The block's output tile is 128 x BN, BN
//     by the epilogue's width: 256 where N % 256 == 0 (fc1's 6,144), else
//     176 (IV2-1B's 1,408 and 4,224 = 8 and 24 x 176), else 128.
//     TMA zero-fills rows past M and columns past K. The epilogue writes
//     the bf16 tile into the idle ring and one TMA store moves it out
//     (dropping rows past M): scattered 4-byte stores from registers cost
//     2-17% more at every GEMM (PERF.md).
//  qk_norm without recomputing the GEMM: the sum of squares of a K-wide
//  fp32 third is needed before any rounding. The q and k thirds are cut
//  into CL column tiles of BN (K = CL * BN; 8 x 176 at K = 1,408) that run
//  as one thread-block cluster of CL blocks. Each block writes its rows'
//  partial sums of y^2 (its BN columns) to shared memory; after a cluster
//  barrier every block reads the CL partials of its rows through
//  distributed shared memory (mapa + ld.shared::cluster) in rank order,
//  so all CL blocks add the same numbers in the same order, normalises and
//  stores; a second cluster barrier keeps every block's shared memory
//  alive until the others have read it. The GEMM runs once.
//
// Trouble spots handled on purpose:
//  * An mbarrier parity error hangs the card: a wait that never ends traps
//    after 2^28 polls; every load issued is waited on before the block
//    exits.
//  * The ls_residual epilogue loads every residual before its first store:
//    out may alias res as far as the compiler knows, so it would not move a
//    load above a store, and each load's latency would serialize (proj
//    1.53 -> 1.12 ms at path D's rows, NVIDIA H100 80GB HBM3, 700 W).
//  * float(acc) rounds an int32 sum above 2^24 once to fp32, as the plain
//    version's float64 dot rounded once does.
//
// Measured and not kept (PERF.md): a persistent GEMM (one block or cluster
// per SM walking the tiles, the next tile's loads issued during the
// epilogue) was 5-14% slower at every GEMM and spilled at the 256-column
// tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROW_THREADS = 256;      // rows kernel: a warp per row
constexpr int BM = 128;               // GEMM rows per block (2 x 64)
constexpr int BK = 128;               // bytes of K per stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER = CONSUMERS * 128;
constexpr int TR = 64;                // transpose tile, bytes a side
constexpr int MAX_CLUSTER = 8;        // portable cluster size

enum Epilogue { EPI_NONE = 0, EPI_GELU = 1, EPI_QK_NORM = 2, EPI_LS_RES = 3 };

template <int BN>
struct Tiles {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE = A_BYTES + B_BYTES;   // multiples of 1,024
  static constexpr int BAR_OFF = STAGES * STAGE;    // full[S], empty[S]
  static constexpr int PART_OFF = BAR_OFF + 128;    // qk_norm partials [BM]
  static constexpr int SMEM = PART_OFF + BM * 4 + 1024;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ---------------------------------------------------------------------------
// rows: (RMSNorm) + per-row int8 quantisation, one warp per row
// ---------------------------------------------------------------------------

// 8 bf16 (16 bytes) -> 8 floats
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// h = x * r * norm_w for the 8 columns of vector c (no norm: h = x)
__device__ __forceinline__ void normed8(const uint4& v, const float* norm_w,
                                        int c, float r, float (&f)[8]) {
  unpack8(v, f);
  if (norm_w != nullptr) {
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(norm_w) + 2 * c);
    const float4 w1 =
        __ldg(reinterpret_cast<const float4*>(norm_w) + 2 * c + 1);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = f[i] * r * w[i];
  }
}

// 8 values quantised with scale s, packed as 8 int8
__device__ __forceinline__ uint2 quant8(const float (&f)[8], float s) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qv = (int)fminf(fmaxf(rintf(f[i] / s), -127.f), 127.f);
    w[i / 4] |= ((uint32_t)qv & 0xffu) << (8 * (i % 4));
  }
  return make_uint2(w[0], w[1]);
}

// K % 8 == 0, K <= 256 * VPL: a warp per row, each lane keeps its VPL
// 16-byte vectors (8 columns each) in registers, so the row is read from
// device memory once for the sum of squares, the absmax and the rounding
template <int VPL>
__global__ void __launch_bounds__(ROW_THREADS)
row_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ norm_w,
                 int8_t* __restrict__ x8, float* __restrict__ xs, int M, int K,
                 float eps) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
  if (m >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)m * K);
  const int K8 = K / 8;
  uint4 v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < K8 ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
  }
  float r = 1.f;
  if (norm_w != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      float f[8];
      unpack8(v[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss = fmaf(f[e], f[e], ss);
    }
    ss = warp_sum(ss);
    r = 1.f / sqrtf(ss / (float)K + eps);
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < K8) {
      float f[8];
      normed8(v[i], norm_w, c, r, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
  }
  amax = warp_max(amax);
  const float s = fmaxf(amax / 127.f, 1e-8f);
  uint2* out = reinterpret_cast<uint2*>(x8 + (size_t)m * K);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < K8) {
      float f[8];
      normed8(v[i], norm_w, c, r, f);
      out[c] = quant8(f, s);
    }
  }
  if (lane == 0) xs[m] = s;
}

// the sum of v over the block's 8 warps, every thread adding the warps'
// partials in the same order (red: 8 floats of shared memory)
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < ROW_THREADS / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < ROW_THREADS / 32; ++w) t = fmaxf(t, red[w]);
  __syncthreads();
  return t;
}

// any K % 8 == 0: a block per row, each thread keeping its first VPT
// 16-byte vectors in registers (all of a row up to K = 2,048 * VPT), so
// long rows need few registers a thread and many rows are in flight (a
// warp per row would hold 96 registers of data at K = 6,144); columns past
// those are read again in each pass, from the L1 or L2 cache after the first
template <int VPT>
__global__ void __launch_bounds__(ROW_THREADS)
row_quant_block_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ norm_w,
                       int8_t* __restrict__ x8, float* __restrict__ xs, int M,
                       int K, float eps) {
  __shared__ float red[ROW_THREADS / 32];
  const int m = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)m * K);
  const int K8 = K / 8;
  const int c_rest = threadIdx.x + ROW_THREADS * VPT;  // first vector re-read
  uint4 v[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + ROW_THREADS * i;
    v[i] = c < K8 ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
  }
  float r = 1.f;
  if (norm_w != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      float f[8];
      unpack8(v[i], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss = fmaf(f[e], f[e], ss);
    }
    for (int c = c_rest; c < K8; c += ROW_THREADS) {
      float f[8];
      unpack8(xr[c], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss = fmaf(f[e], f[e], ss);
    }
    r = 1.f / sqrtf(block_sum(ss, red) / (float)K + eps);
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + ROW_THREADS * i;
    if (c < K8) {
      float f[8];
      normed8(v[i], norm_w, c, r, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
  }
  for (int c = c_rest; c < K8; c += ROW_THREADS) {
    float f[8];
    normed8(xr[c], norm_w, c, r, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
  const float s = fmaxf(block_max(amax, red) / 127.f, 1e-8f);
  uint2* out = reinterpret_cast<uint2*>(x8 + (size_t)m * K);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + ROW_THREADS * i;
    if (c < K8) {
      float f[8];
      normed8(v[i], norm_w, c, r, f);
      out[c] = quant8(f, s);
    }
  }
  for (int c = c_rest; c < K8; c += ROW_THREADS) {
    float f[8];
    normed8(xr[c], norm_w, c, r, f);
    out[c] = quant8(f, s);
  }
  if (threadIdx.x == 0) xs[m] = s;
}

// ---------------------------------------------------------------------------
// the weight, K-major: wt [N, K] = w [K, N]^T, one 64 x 64-byte tile a block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
transpose_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt, int K,
                 int N) {
  __shared__ uint32_t tile[TR][TR / 4 + 1];   // [k][n / 4], padded
  const int k0 = blockIdx.y * TR, n0 = blockIdx.x * TR;
  const int t = threadIdx.x;
  {
    // 64 rows of k, 64 bytes of n each: a thread loads 16 bytes
    const int k = t / 4, c = (t % 4) * 16;
    const uint4 v =
        *reinterpret_cast<const uint4*>(w + (size_t)(k0 + k) * N + n0 + c);
    tile[k][c / 4 + 0] = v.x;
    tile[k][c / 4 + 1] = v.y;
    tile[k][c / 4 + 2] = v.z;
    tile[k][c / 4 + 3] = v.w;
  }
  __syncthreads();
  // a thread writes 16 bytes of one output row n: k = c .. c + 15
  const int n = t / 4, c = (t % 4) * 16;
  uint32_t out[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t src = tile[c + 4 * q + i][n / 4];
      word |= ((src >> (8 * (n % 4))) & 0xffu) << (8 * i);
    }
    out[q] = word;
  }
  *reinterpret_cast<uint4*>(wt + (size_t)(n0 + n) * K + k0 + c) =
      make_uint4(out[0], out[1], out[2], out[3]);
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the barrier's phase of parity `parity` has completed; traps
// after 2^28 polls (a pipeline fault) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// box of a 2-D tensor map (K, rows) at column c, row r into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows, 128-byte
// swizzle: stride 1,024 bytes between 8-row groups; buffers start on
// 1,024-byte boundaries
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// the 256 threads of the two consumer warpgroups (barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// all threads of every block of the cluster (release / acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a float in the shared memory of the cluster's block `rank`, at the offset
// `addr` has in this block's
__device__ __forceinline__ float ld_cluster(uint32_t addr, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

// D[64 x 128] (+)= A[64 x 32] B[32 x 128], s8 x s8 -> s32: A and B from
// shared memory, both K-major, 128-byte swizzle; 64 accumulators a thread;
// scale_d 0 overwrites D
template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 176] (+)= A[64 x 32] B[32 x 176], s8 x s8 -> s32: A and B from
// shared memory, both K-major, 128-byte swizzle; 88 accumulators a thread;
// scale_d 0 overwrites D
template <>
__device__ __forceinline__ void wgmma_s8<176>(int (&d)[88], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87"
      "}, %88, %89, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 256] (+)= A[64 x 32] B[32 x 256], s8 x s8 -> s32: A and B from
// shared memory, both K-major, 128-byte swizzle; 128 accumulators a thread;
// scale_d 0 overwrites D
template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// the GEMM with its epilogues
// ---------------------------------------------------------------------------

__device__ __forceinline__ float exp2f_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct Args {
  const float* xs;                     // [M] row scales
  const float* ws;                     // [N]
  const float* bias;                   // [N] or null
  const float* ls;                     // [N] (ls_residual)
  const bf16* res;                     // [M, N] (ls_residual)
  const float* qn;                     // [2, K] (qk_norm)
  bf16* out;                           // [M, N]
  int M, N, K;
  float eps;
};

// the JAX kernel's rational erf; the reciprocal and the exp run on the SFU
// (rcp.approx, ex2.approx: a few ulp, far inside the kernel's bar)
__device__ __forceinline__ float erf_rational(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = __fdividef(1.f, 1.f + 0.3275911f * ax);
  const float poly = ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t
                       - 0.284496736f) * t + 0.254829592f) * t;
  return s * (1.f - poly * exp2f_approx(-ax * ax * 1.4426950408889634f));
}

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_c, const Args p) {
  typedef Tiles<BN> T;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + T::BAR_OFF;
  const uint32_t part = base + T::PART_OFF;   // [BM] floats
  float* const spart =
      reinterpret_cast<float*>(smem_raw + (base - raw) + T::PART_OFF);
  auto sa = [&](int s) { return base + s * T::STAGE; };
  auto sb = [&](int s) { return base + s * T::STAGE + T::A_BYTES; };
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = (p.K + BK - 1) / BK;
  // qk_norm: the q and k thirds are normalised (the block's cluster is one
  // third); the v third passes, and so does every block of other epilogues
  const int third = EPI == EPI_QK_NORM ? n0 / p.K : 2;
  const bool norm = third < 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == PRODUCER) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), T::STAGE);
        tma_load(sa(s), &map_a, full(s), kt * BK, m0);
        tma_load(sb(s), &map_b, full(s), kt * BK, n0);
      }
    }
    __syncwarp();
    if (norm) {            // the cluster's two barriers count every thread
      cluster_sync();
      cluster_sync();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int r = lane >> 2;   // accumulator row in the warp's 16
    const int t4 = lane & 3;   // column pair in each 8-column group
    const int rloc = 64 * wg + 16 * warp + r;   // rows rloc, rloc + 8

    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full(s), (kt / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8<BN>(acc, desc128(sa(s) + wg * 64 * BK + kk * 32),
                     desc128(sb(s) + kk * 32), kt > 0 || kk > 0);
      wgmma_commit();
      // the previous stage's products retired: hand its buffers back
      wgmma_wait<1>();
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty((kt - 1) % STAGES));
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: acc[4j + 2h + e] is row rloc + 8h, column n0 + 8j + 2 t4 + e
    float xs[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + rloc + 8 * h;
      live[h] = m < p.M;
      xs[h] = live[h] ? p.xs[m] : 0.f;
    }
    float y[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + 2 * t4 + e;
        const float wsn = p.ws[n];
        const float bn = p.bias != nullptr ? p.bias[n] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = (float)acc[4 * j + 2 * h + e] * xs[h] * wsn;
          if (p.bias != nullptr) v = v + bn;
          if (EPI == EPI_GELU)
            v = 0.5f * v * (1.f + erf_rational(v * 0.7071067811865476f));
          y[4 * j + 2 * h + e] = v;
        }
      }
    }
    if (EPI == EPI_QK_NORM && norm) {
      // this block's share of each row's sum of squares, in a fixed order
      float ss[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ss[h] = fmaf(y[4 * j + 2 * h], y[4 * j + 2 * h], ss[h]);
          ss[h] = fmaf(y[4 * j + 2 * h + 1], y[4 * j + 2 * h + 1], ss[h]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
        if (t4 == 0) spart[rloc + 8 * h] = ss[h];
      }
      cluster_sync();
      // every block of the cluster adds the same partials in rank order
      const int cl = p.K / BN;
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tot = 0.f;
        for (int rank = 0; rank < cl; ++rank)
          tot += ld_cluster(part + 4u * (rloc + 8 * h), rank);
        inv[h] = 1.f / sqrtf(tot / (float)p.K + p.eps);
      }
      cluster_sync();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float qn = p.qn[n0 + 8 * j + 2 * t4 + e];  // [2, K] row-major
#pragma unroll
          for (int h = 0; h < 2; ++h)
            y[4 * j + 2 * h + e] = y[4 * j + 2 * h + e] * inv[h] * qn;
        }
    }
    if (EPI == EPI_LS_RES) {
      // y * ls + residual; every residual load is issued before the first
      // store (out may alias res as far as the compiler knows, so it would
      // not move a load above a store)
      uint32_t rv[BN / 4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          rv[2 * j + h] =
              live[h] ? __ldg(reinterpret_cast<const unsigned int*>(
                            p.res + (size_t)(m0 + rloc + 8 * h) * p.N + n0 +
                            8 * j + 2 * t4))
                      : 0u;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t4;
        const float l0 = p.ls[n], l1 = p.ls[n + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          y[4 * j + 2 * h] = fmaf(y[4 * j + 2 * h], l0,
                                  __uint_as_float(rv[2 * j + h] << 16));
          y[4 * j + 2 * h + 1] =
              fmaf(y[4 * j + 2 * h + 1], l1,
                   __uint_as_float(rv[2 * j + h] & 0xffff0000u));
        }
      }
    }
    // the bf16 tile through shared memory (the ring, idle once both
    // consumer warpgroups' products retired) and out with one TMA store,
    // which drops the rows past M
    consumers_sync();
    unsigned char* const ctile = smem_raw + (base - raw);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            ctile + ((rloc + 8 * h) * BN + 8 * j + 2 * t4) * 2) =
            __floats2bfloat162_rn(y[4 * j + 2 * h], y[4 * j + 2 * h + 1]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
    if (threadIdx.x == 0) {
      asm volatile(
          "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
          " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(&map_c)),
          "r"(base), "r"(n0), "r"(m0)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// an int8 matrix [rows, K] (K contiguous) as a 2-D map read in boxes of
// 128 bytes of K x box_rows rows, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int K, int rows,
              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the bf16 output [rows, N] as a 2-D map written in boxes of BN x BM
bool make_out_map(CUtensorMap* map, void* ptr, int N, int rows, int bn) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {(cuuint32_t)bn, (cuuint32_t)BM};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the output tile width for N columns (0: none fits)
int tile_n(int N) {
  return N % 256 == 0 ? 256 : N % 176 == 0 ? 176 : N % 128 == 0 ? 128 : 0;
}

// qk_norm: a third of K columns as a cluster of K / BN blocks
int tile_qk(int K) {
  const int widths[3] = {256, 176, 128};
  for (int bn : widths)
    if (K % bn == 0 && K / bn <= MAX_CLUSTER) return bn;
  return 0;
}

template <int BN, int EPI>
int launch_gemm_bn(const Args& a, const int8_t* x8, const int8_t* wt,
                   int cluster, cudaStream_t st) {
  CUtensorMap ma, mb, mc;
  if (!make_map(&ma, x8, a.K, a.M, BM) || !make_map(&mb, wt, a.K, a.N, BN) ||
      !make_out_map(&mc, a.out, a.N, a.M, BN))
    return (int)cudaErrorInvalidValue;
  auto kern = gemm_kernel<BN, EPI>;
  const int smem = Tiles<BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.N / BN, (a.M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, ma, mb, mc, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int EPI>
int launch_gemm(const Args& a, const int8_t* x8, const int8_t* wt,
                cudaStream_t st) {
  const int bn = EPI == EPI_QK_NORM ? tile_qk(a.K) : tile_n(a.N);
  const int cluster = EPI == EPI_QK_NORM ? a.K / bn : 1;
  switch (bn) {
    case 256: return launch_gemm_bn<256, EPI>(a, x8, wt, cluster, st);
    case 176: return launch_gemm_bn<176, EPI>(a, x8, wt, cluster, st);
    case 128: return launch_gemm_bn<128, EPI>(a, x8, wt, cluster, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the rows kernel: rows in registers, a warp per row where a lane's share
// fits 8 vectors (K <= 2,048: IV2-1B's 1,408), else a block per row (all
// of a row in registers up to K = 6,144, IV2-1B's mlp width)
int launch_rows(const void* x, const float* norm_w, int8_t* x8, float* xs,
                int M, int K, float eps, cudaStream_t st) {
  const int rows_per_block = ROW_THREADS / 32;
  const bf16* xb = static_cast<const bf16*>(x);
  if (K <= 256 * 8)
    row_quant_kernel<8><<<(M + rows_per_block - 1) / rows_per_block,
                          ROW_THREADS, 0, st>>>(xb, norm_w, x8, xs, M, K, eps);
  else
    row_quant_block_kernel<3><<<M, ROW_THREADS, 0, st>>>(xb, norm_w, x8, xs,
                                                         M, K, eps);
  return (int)cudaGetLastError();
}

int launch_transpose(const void* w, int8_t* wt, int K, int N,
                     cudaStream_t st) {
  transpose_kernel<<<dim3(N / TR, K / TR), 256, 0, st>>>(
      static_cast<const int8_t*>(w), wt, K, N);
  return (int)cudaGetLastError();
}

bool shapes_ok(int M, int K, int N) {
  return M >= 1 && K >= TR && K % TR == 0 && tile_n(N) != 0 &&
         (M + BM - 1) / BM <= 65535;
}

}  // namespace

// x [M,K] bf16, norm_w [K] fp32, w [K,N] int8, ws [N] fp32, bias [N] fp32 or
// null, qn [2,K] fp32 (qk_norm) -> out [M,N] bf16. Scratch from the caller:
// x8 [M,K] int8, xs [M] fp32, wt [N,K] int8 (the weight, K-major). epilogue:
// 0 none, 1 gelu, 2 qk_norm (N == 3K, K a cluster of at most 8 tiles of
// 256, 176 or 128 columns). K % 64 == 0, N % 128 == 0.
extern "C" int gvllm_fused_norm_quant_gemm(
    const void* x, const void* norm_w, const void* w, const void* ws,
    const void* bias, const void* qn, void* out, void* x8, void* xs,
    void* wt, int M, int K, int N, int epilogue, float eps, void* stream) {
  if (!shapes_ok(M, K, N) || epilogue < 0 || epilogue > 2 ||
      (epilogue == 2 && (N != 3 * K || tile_qk(K) == 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_rows(x, static_cast<const float*>(norm_w),
                        static_cast<int8_t*>(x8), static_cast<float*>(xs), M, K,
                        eps, st);
  if (err) return err;
  err = launch_transpose(w, static_cast<int8_t*>(wt), K, N, st);
  if (err) return err;
  Args a{static_cast<const float*>(xs), static_cast<const float*>(ws),
         static_cast<const float*>(bias), nullptr, nullptr,
         static_cast<const float*>(qn), static_cast<bf16*>(out), M, N, K, eps};
  const int8_t* x8p = static_cast<const int8_t*>(x8);
  const int8_t* wtp = static_cast<const int8_t*>(wt);
  if (epilogue == 0) return launch_gemm<EPI_NONE>(a, x8p, wtp, st);
  if (epilogue == 1) return launch_gemm<EPI_GELU>(a, x8p, wtp, st);
  return launch_gemm<EPI_QK_NORM>(a, x8p, wtp, st);
}

// x [M,K] bf16, w [K,N] int8, ws [N], bias [N], ls [N] fp32, res [M,N] bf16
// -> out [M,N] bf16 = res + ls * (quant(x) @ w * ws + bias). Scratch x8, xs,
// wt as above.
extern "C" int gvllm_fused_quant_gemm_ls_residual(
    const void* x, const void* w, const void* ws, const void* bias,
    const void* ls, const void* res, void* out, void* x8, void* xs, void* wt,
    int M, int K, int N, void* stream) {
  if (!shapes_ok(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_rows(x, nullptr, static_cast<int8_t*>(x8),
                        static_cast<float*>(xs), M, K, 0.f, st);
  if (err) return err;
  err = launch_transpose(w, static_cast<int8_t*>(wt), K, N, st);
  if (err) return err;
  Args a{static_cast<const float*>(xs), static_cast<const float*>(ws),
         static_cast<const float*>(bias), static_cast<const float*>(ls),
         static_cast<const bf16*>(res), nullptr, static_cast<bf16*>(out), M, N,
         K, 0.f};
  return launch_gemm<EPI_LS_RES>(a, static_cast<const int8_t*>(x8),
                                 static_cast<const int8_t*>(wt), st);
}
