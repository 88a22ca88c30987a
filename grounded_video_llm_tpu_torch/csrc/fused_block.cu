// Fused W8A8 InternVideo2-block GEMMs, Hopper (sm_90a).
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
// qkv, fc1 and fc2 at one video (M = 24,588 rows); proj (K = N = 1,408) is
// close to the byte bound.
//
// Design. The TPU kernel normalises and quantises an x row tile once and
// keeps it in VMEM across the N blocks; an int8 [bm, 6144] tile for fc2 does
// not fit a block's shared memory here, so a first kernel (a warp per row)
// writes the int8 rows and their fp32 scales, and the GEMM reads them. The
// GEMM is a plain tiled int8 mma.sync.m16n8k32 kernel: a 128 x 128 output
// tile per block of 8 warps (warp tile 64 x 32), K in steps of 64 through
// shared memory, the next step's global loads in registers while the tensor
// cores run. The weight is [K, N] with N contiguous, but the mma B operand
// wants 4 consecutive k of one column per register: each thread loads a
// 4 x 4 byte block and transposes it with __byte_perm on the way to shared
// memory. qk_norm needs the sum of squares of a whole 1,408-wide fp32 third
// before any rounding, and a block owns 128 columns: a first GEMM pass over
// the q and k columns writes per-(row, 128-column tile) partial sums of the
// fp32 y, and the second pass, which recomputes the same int32 sums, adds
// the partials of its third in a fixed order and normalises. That spends
// two thirds of a qkv GEMM more, and needs no fp32 copy of the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;          // shared row stride in bytes (80)
constexpr int LDW = LDS / 4;          // the same in 4-byte words (20)

enum Epilogue { EPI_NONE = 0, EPI_GELU = 1, EPI_QK_SSQ = 2, EPI_QK_NORM = 3,
                EPI_LS_RES = 4 };

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

__global__ void __launch_bounds__(THREADS)
row_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ norm_w,
                 int8_t* __restrict__ x8, float* __restrict__ xs, int M, int K,
                 float eps) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (m >= M) return;
  const bf16* xr = x + (size_t)m * K;
  float r = 1.f;
  if (norm_w != nullptr) {
    float ss = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float v = __bfloat162float(xr[k]);
      ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    r = 1.f / sqrtf(ss / (float)K + eps);
  }
  float amax = 0.f;
  for (int k = lane; k < K; k += 32) {
    float h = __bfloat162float(xr[k]);
    if (norm_w != nullptr) h = h * r * norm_w[k];
    amax = fmaxf(amax, fabsf(h));
  }
  amax = warp_max(amax);
  const float s = fmaxf(amax / 127.f, 1e-8f);
  for (int k = lane; k < K; k += 32) {
    float h = __bfloat162float(xr[k]);
    if (norm_w != nullptr) h = h * r * norm_w[k];
    const float qv = fminf(fmaxf(rintf(h / s), -127.f), 127.f);
    x8[(size_t)m * K + k] = (int8_t)qv;
  }
  if (lane == 0) xs[m] = s;
}

// ---------------------------------------------------------------------------
// the GEMM with its epilogues
// ---------------------------------------------------------------------------

struct Args {
  const int8_t* x8; const float* xs;
  const int8_t* w; const float* ws;
  const float* bias;                   // [N] or null
  const float* ls;                     // [N] (ls_residual)
  const bf16* res;                     // [M, N] (ls_residual)
  const float* qn;                     // [2, K] (qk_norm)
  float* ssq;                          // [M, 2K / BN] partial sums (qk_norm)
  bf16* out;                           // [M, N]
  int M, N, K;
  float eps;
};

__device__ __forceinline__ float erf_rational(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * ax);
  const float poly = ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t
                       - 0.284496736f) * t + 0.254829592f) * t;
  return s * (1.f - poly * expf(-ax * ax));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int EPI>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(Args p) {
  __shared__ __align__(16) int8_t As[BM * LDS];      // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * LDS];      // [n][k] (transposed)
  __shared__ float red[4][BM];                       // qk sums, per warp_n

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int warp_m = warp >> 2, warp_n = warp & 3;   // 2 x 4 warps
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = p.M, N = p.N, K = p.K;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  // global -> registers: A two 16-byte chunks; B two 4 x 4 byte blocks
  // (lanes of a warp: 8 column words x 4 row groups, 32-byte segments)
  uint4 a_reg[2];
  uint32_t b_reg[2][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;             // 512 chunks
      const int row = c >> 2, col = (c & 3) * 16;
      const int m = m0 + row;
      a_reg[i] = m < M ? *reinterpret_cast<const uint4*>(
                             p.x8 + (size_t)m * K + k0 + col)
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = warp * 64 + i * 32 + lane;     // 512 blocks
      const int kg = (blk >> 7) * 4 + ((lane >> 3) & 3);   // 0..15
      const int ng = ((blk >> 5) & 3) * 8 + (lane & 7);    // 0..31
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          p.w + (size_t)(k0 + kg * 4) * N + n0 + ng * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) b_reg[i][r] = __ldg(src + (size_t)r * (N / 4));
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 2, col = (c & 3) * 16;
      *reinterpret_cast<uint4*>(As + row * LDS + col) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = warp * 64 + i * 32 + lane;
      const int kg = (blk >> 7) * 4 + ((lane >> 3) & 3);
      const int ng = ((blk >> 5) & 3) * 8 + (lane & 7);
      const uint32_t* r = b_reg[i];
      // r[j] holds columns ng*4 .. +3 of row kg*4 + j; transpose to
      // t[c] = rows kg*4 .. +3 of column ng*4 + c
      const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
      uint32_t* dst = reinterpret_cast<uint32_t*>(Bs) + (ng * 4) * LDW + kg;
      dst[0 * LDW] = __byte_perm(lo01, lo23, 0x5410);
      dst[1 * LDW] = __byte_perm(lo01, lo23, 0x7632);
      dst[2 * LDW] = __byte_perm(hi01, hi23, 0x5410);
      dst[3 * LDW] = __byte_perm(hi01, hi23, 0x7632);
    }
  };

  const uint32_t* As32 = reinterpret_cast<const uint32_t*>(As);
  const uint32_t* Bs32 = reinterpret_cast<const uint32_t*>(Bs);
  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK / 4; kk += 8) {        // two k32 steps (words)
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r0 = warp_m * 64 + mt * 16 + g;
        a[mt][0] = As32[r0 * LDW + kk + tig];
        a[mt][1] = As32[(r0 + 8) * LDW + kk + tig];
        a[mt][2] = As32[r0 * LDW + kk + 4 + tig];
        a[mt][3] = As32[(r0 + 8) * LDW + kk + 4 + tig];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = warp_n * 32 + nt * 8 + g;
        b[nt][0] = Bs32[n * LDW + kk + tig];
        b[nt][1] = Bs32[n * LDW + kk + 4 + tig];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }

  // epilogue: acc[mt][nt][2h + e] is row r = warp_m*64 + mt*16 + g + 8h,
  // column n = warp_n*32 + nt*8 + 2*tig + e of the block's tile
  const int third = n0 / K;                     // qk_norm: 0 q, 1 k, 2 v
  const int tiles = K / BN;                     // 128-column tiles per third
  float ssq_part[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) ssq_part[mt][0] = ssq_part[mt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rloc = warp_m * 64 + mt * 16 + g + 8 * h;
      const int m = m0 + rloc;
      const bool live = m < M;
      const float xs = live ? p.xs[m] : 0.f;
      float inv = 1.f;
      if (EPI == EPI_QK_NORM && third < 2 && live) {
        const float* part = p.ssq + (size_t)m * (2 * tiles) + third * tiles;
        float tot = 0.f;
        for (int t = 0; t < tiles; ++t) tot += part[t];
        inv = 1.f / sqrtf(tot / (float)K + p.eps);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + warp_n * 32 + nt * 8 + 2 * tig;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = (float)acc[mt][nt][2 * h + e] * xs * p.ws[n + e];
          if (p.bias != nullptr) v = v + p.bias[n + e];
          if (EPI == EPI_GELU) v = 0.5f * v * (1.f + erf_rational(v * 0.7071067811865476f));
          if (EPI == EPI_QK_NORM && third < 2)
            v = v * inv * p.qn[n + e];           // qn [2, K] row-major
          if (EPI == EPI_LS_RES)
            v = v * p.ls[n + e]
                + (live ? __bfloat162float(p.res[(size_t)m * N + n + e]) : 0.f);
          y[e] = v;
        }
        if (EPI == EPI_QK_SSQ) {
          ssq_part[mt][h] = fmaf(y[0], y[0], ssq_part[mt][h]);
          ssq_part[mt][h] = fmaf(y[1], y[1], ssq_part[mt][h]);
        } else if (live) {
          __nv_bfloat162 o;
          o.x = __float2bfloat16_rn(y[0]);
          o.y = __float2bfloat16_rn(y[1]);
          *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)m * N + n) = o;
        }
      }
    }
  }
  if (EPI == EPI_QK_SSQ) {
    // the 4 lanes of a row group hold its 32 columns of this warp: add them,
    // then the 4 warps along n, in a fixed order
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = ssq_part[mt][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tig == 0) red[warp_n][warp_m * 64 + mt * 16 + g + 8 * h] = v;
      }
    __syncthreads();
    if (tid < BM && m0 + tid < M)
      p.ssq[(size_t)(m0 + tid) * (2 * tiles) + blockIdx.x] =
          red[0][tid] + red[1][tid] + red[2][tid] + red[3][tid];
  }
}

template <int EPI>
int launch_gemm(const Args& a, int n_cols, cudaStream_t st) {
  dim3 grid(n_cols / BN, (a.M + BM - 1) / BM);
  gemm_kernel<EPI><<<grid, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

int launch_rows(const void* x, const float* norm_w, int8_t* x8, float* xs,
                int M, int K, float eps, cudaStream_t st) {
  const int rows_per_block = THREADS / 32;
  row_quant_kernel<<<(M + rows_per_block - 1) / rows_per_block, THREADS, 0,
                     st>>>(static_cast<const bf16*>(x), norm_w, x8, xs, M, K,
                           eps);
  return (int)cudaGetLastError();
}

bool shapes_ok(int M, int K, int N) {
  return M >= 1 && K >= BK && K % BK == 0 && N >= BN && N % BN == 0 &&
         (M + BM - 1) / BM <= 65535;
}

}  // namespace

// x [M,K] bf16, norm_w [K] fp32, w [K,N] int8, ws [N] fp32, bias [N] fp32 or
// null, qn [2,K] fp32 (qk_norm) -> out [M,N] bf16. Scratch from the caller:
// x8 [M,K] int8, xs [M] fp32, ssq [M, 2K/128] fp32 (qk_norm). epilogue:
// 0 none, 1 gelu, 2 qk_norm (N == 3K, K % 128 == 0).
extern "C" int gvllm_fused_norm_quant_gemm(
    const void* x, const void* norm_w, const void* w, const void* ws,
    const void* bias, const void* qn, void* out, void* x8, void* xs,
    void* ssq, int M, int K, int N, int epilogue, float eps, void* stream) {
  if (!shapes_ok(M, K, N) || epilogue < 0 || epilogue > 2 ||
      (epilogue == 2 && (N != 3 * K || K % BN)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_rows(x, static_cast<const float*>(norm_w),
                        static_cast<int8_t*>(x8), static_cast<float*>(xs), M, K,
                        eps, st);
  if (err) return err;
  Args a{static_cast<const int8_t*>(x8), static_cast<const float*>(xs),
         static_cast<const int8_t*>(w), static_cast<const float*>(ws),
         static_cast<const float*>(bias), nullptr, nullptr,
         static_cast<const float*>(qn), static_cast<float*>(ssq),
         static_cast<bf16*>(out), M, N, K, eps};
  if (epilogue == 0) return launch_gemm<EPI_NONE>(a, N, st);
  if (epilogue == 1) return launch_gemm<EPI_GELU>(a, N, st);
  err = launch_gemm<EPI_QK_SSQ>(a, 2 * K, st);     // the q and k columns
  if (err) return err;
  return launch_gemm<EPI_QK_NORM>(a, N, st);
}

// x [M,K] bf16, w [K,N] int8, ws [N], bias [N], ls [N] fp32, res [M,N] bf16
// -> out [M,N] bf16 = res + ls * (quant(x) @ w * ws + bias). Scratch x8, xs.
extern "C" int gvllm_fused_quant_gemm_ls_residual(
    const void* x, const void* w, const void* ws, const void* bias,
    const void* ls, const void* res, void* out, void* x8, void* xs, int M,
    int K, int N, void* stream) {
  if (!shapes_ok(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_rows(x, nullptr, static_cast<int8_t*>(x8),
                        static_cast<float*>(xs), M, K, 0.f, st);
  if (err) return err;
  Args a{static_cast<const int8_t*>(x8), static_cast<const float*>(xs),
         static_cast<const int8_t*>(w), static_cast<const float*>(ws),
         static_cast<const float*>(bias), static_cast<const float*>(ls),
         static_cast<const bf16*>(res), nullptr, nullptr,
         static_cast<bf16*>(out), M, N, K, 0.f};
  return launch_gemm<EPI_LS_RES>(a, N, st);
}
