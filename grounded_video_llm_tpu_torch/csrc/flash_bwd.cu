// Flash-attention backward for Hopper (sm_90a), bf16 in and out, fp32 math.
//
// Replaces grounded_video_llm_tpu/ops/flash_attention.py:_flash_bwd (its two
// Pallas kernels: _bwd_dq_kernel, launched at :515, and _bwd_dkv_kernel,
// launched at :534), with the same contract: from q / do [B,Sq,H,D], k / v
// [B,Sk,Hkv,D] (GQA: q head h reads kv head h / (H/Hkv)), an optional
// additive fp32 key bias [B,Sk], the forward's row logsumexp lse [B,H,Sq] and
// delta = rowsum(o * do) [B,H,Sq] (fp32, computed by the caller as XLA does
// outside the Pallas kernels), it writes dq [B,Sq,H,D] and dk, dv
// [B,Sk,Hkv,D] in bf16. The softmax is replayed from lse, never recomputed:
//   P  = exp(s * scale + bias - lse), s masked to -FLT_MAX outside the causal
//        or window extent (qpos = row + q_offset),
//   dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dQ = dS K,  dK = sum over the GQA group of dS^T Q,  dV = the same of
//        P^T dO.
// P and dS are rounded to bf16 for the products they feed, where the Pallas
// kernels cast them; every product accumulates in fp32. The bias gets no
// gradient (it is a mask).
//
// Design (a first version that is right; speed is later work). Two kernels,
// the JAX schedule, both deterministic and free of atomics:
//  * dq kernel: one block of 4 warps per (batch, q head, 64-row q tile),
//    each warp 16 rows. 64-key K/V tiles stream through shared memory; the
//    block skips the k tiles wholly above the diagonal or below the window.
//    dq stays in fp32 registers. Three products per tile: Q K^T, dO V^T,
//    dS K.
//  * dkv kernel: one block per (batch, kv head, 64-key tile), each warp 16
//    keys, computing the transposed tiles S^T = K Q^T and dP^T = V dO^T so
//    that P^T and dS^T sit in registers in the A-operand layout. It loops
//    over the G q heads of the group and over the q tiles that can see this
//    k tile; dk and dv stay in fp32 registers across the whole group. Four
//    products per tile: K Q^T, V dO^T, P^T dO, dS^T Q.
// All products run on the tensor cores as mma.sync m16n8k16 bf16 -> fp32, as
// in flash_fwd.cu.
//
// What bounds it on an H100. The backward needs five products over the
// visible (q, key) pairs (10 * D flops per pair and head) against reading q,
// k, v, do, lse, delta once and writing dq, dk, dv once: at the training
// shape ([1, 7515, 32, 96], causal) that is 8.7e11 flops against ~0.37 GB,
// about 2,300 flops per byte, far above the bf16 ridge (~295): the tensor
// cores bound it (0.88 ms at 989 TFLOP/s). This schedule does seven
// products (Q K^T and dO V^T in both kernels), 1.4x the least work, to keep
// both kernels free of atomics. What it does not do yet: wgmma, TMA,
// ldmatrix, overlapping the next tile's loads with the current tile's math.
//
// Trouble spots handled on purpose:
//  * Dead rows (lse = +inf: no valid key in the forward) and rows past Sq:
//    the replay computes exp2(fma(x, log2e, -inf)) = exp2(-inf) = 0 for any
//    finite or -FLT_MAX score, so they contribute exactly 0 and their dq is
//    exactly 0; nothing computes inf - inf or inf * 0.
//  * Ragged Sq and Sk: rows and keys past the end are zero-filled in shared
//    memory (garbage could be NaN, and 0 * NaN = NaN) and masked; rows past
//    Sq get lse = +inf, delta = 0.
//  * D = 88 pads the contraction to 96 with zero columns; padded output
//    columns are never stored.
//  * The dkv kernel's q-tile range under causal + q_offset + window:
//    row r sees key k iff k <= r + q_offset and r + q_offset - k < window,
//    so a k tile [k0, k0 + 64) is seen by rows from k0 - q_offset to
//    k0 + 63 + window - q_offset - 1 (64-bit arithmetic, clamped).
//  * Shared memory is 53-70 KB per block (four 64-row tiles), above the
//    48 KB default: the launch raises cudaFuncAttributeMaxDynamicSharedMemorySize.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

// The mma / packing / tile-load helpers repeat flash_fwd.cu's: each source
// is built (and hashed for the build cache, ops/cuda_build.py) on its own.
typedef __nv_bfloat16 bf16;

constexpr int BM = 64;              // q rows per tile
constexpr int BN = 64;              // keys per tile
constexpr int WARPS = 4;            // 16 rows (dq) or 16 keys (dkv) each
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -FLT_MAX;  // masked score (JAX NEG_INF)
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct HeadDim {
  static constexpr int DP = (D + 15) / 16 * 16;  // contraction padded to k16
  static constexpr int LD = DP + 8;              // +8: conflict-free fragments
  static constexpr int KSTEPS = DP / 16;
  static constexpr int NT = DP / 8;              // n8 tiles of a [16, DP] sum
};

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_pair(const bf16* lo, const bf16* hi) {
  uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ROWS x D bf16 from global (row stride gstride elements) into shared memory
// (row stride LD), 16 bytes per thread per step. Rows >= valid_rows and
// columns D..DP-1 are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          int64_t gstride, int valid_rows) {
  constexpr int DP = HeadDim<D>::DP;
  constexpr int LD = HeadDim<D>::LD;
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows && c < D) {
      val = *reinterpret_cast<const uint4*>(g + (int64_t)r * gstride + c);
    }
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

// c[j] (16 x 64) = A (16 rows of sA, k = the head dim) times B^T, B the 64
// rows of sB (k = the head dim): Q K^T, dO V^T, K Q^T or V dO^T.
template <int D>
__device__ __forceinline__ void rows_times_rows(float (&c)[BN / 8][4],
                                                const bf16* sA,
                                                const bf16* sB, int g,
                                                int t4) {
  constexpr int LD = HeadDim<D>::LD;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HeadDim<D>::KSTEPS; ++kk) {
    const bf16* ap = sA + kk * 16 + t4 * 2;
    uint32_t a[4];
    a[0] = ld32(ap + g * LD);
    a[1] = ld32(ap + (g + 8) * LD);
    a[2] = ld32(ap + g * LD + 8);
    a[3] = ld32(ap + (g + 8) * LD + 8);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const bf16* bp = sB + (j * 8 + g) * LD + kk * 16 + t4 * 2;
      mma_16816(c[j], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc (16 x DP) += P (16 x 64, fp32 accumulators rounded to bf16 here) times
// M, the 64 rows of sM (k = those rows, n = the head dim): dS K, P^T dO,
// dS^T Q.
template <int D>
__device__ __forceinline__ void acc_times_rows(float (&acc)[HeadDim<D>::NT][4],
                                               const float (&p)[BN / 8][4],
                                               const bf16* sM, int g, int t4) {
  constexpr int LD = HeadDim<D>::LD;
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    a[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    a[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    a[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int n = 0; n < HeadDim<D>::NT; ++n) {
      const bf16* mp = sM + (16 * kc + t4 * 2) * LD + n * 8 + g;
      mma_16816(acc[n], a, pack_pair(mp, mp + LD),
                pack_pair(mp + 8 * LD, mp + 9 * LD));
    }
  }
}

__device__ __forceinline__ bool visible(int64_t qpos, int key, int window) {
  return key <= qpos && (window <= 0 || qpos - key < window);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const bf16* __restrict__ dout, bf16* __restrict__ dq,
                    int Sq, int Sk, int H, int Hkv, float scale, int window,
                    int q_offset) {
  constexpr int LD = HeadDim<D>::LD;
  constexpr int NT = HeadDim<D>::NT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + BM * LD;
  bf16* sK = sdO + BM * LD;
  bf16* sV = sK + BN * LD;

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t qbase = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;
  const bf16* kg = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const bf16* vg = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const float* bg = bias ? bias + (int64_t)b * Sk : nullptr;

  load_tile<D, BM>(sQ, q + qbase, q_stride, Sq - q0);
  load_tile<D, BM>(sdO, dout + qbase, q_stride, Sq - q0);

  // rows g and g + 8 of this warp: lse in the log2 domain, delta
  const int row0 = q0 + warp * 16 + g;
  float lse2[2], dlt[2];
  int64_t qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const int64_t idx = ((int64_t)b * H + h) * Sq + row;
    lse2[r] = row < Sq ? lse[idx] * LOG2E : __int_as_float(0x7f800000);
    dlt[r] = row < Sq ? delta[idx] : 0.f;
    qpos[r] = (int64_t)q_offset + row;
  }

  int t_begin = 0;
  int t_end = (Sk + BN - 1) / BN;
  if (CAUSAL) {
    const int64_t hi = min((int64_t)q_offset + q0 + BM, (int64_t)Sk);
    t_end = hi <= 0 ? 0 : (int)((hi + BN - 1) / BN);
    if (window > 0) {
      const int64_t lo = (int64_t)q_offset + q0 - window + 1;
      if (lo > 0) t_begin = (int)min(lo / BN, (int64_t)t_end);
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const bf16* sQw = sQ + warp * 16 * LD;
  const bf16* sdOw = sdO + warp * 16 * LD;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // Q/dO stored (first tile); K/V no longer read
    load_tile<D, BN>(sK, kg + (int64_t)k0 * kv_stride, kv_stride, Sk - k0);
    load_tile<D, BN>(sV, vg + (int64_t)k0 * kv_stride, kv_stride, Sk - k0);
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
    rows_times_rows<D>(s, sQw, sK, g, t4);
    rows_times_rows<D>(dp, sdOw, sV, g, t4);

    // P replayed from lse, then dS = P (dP - delta) scale, in place of s
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t4 * 2 + (e & 1);
        const int r = e >> 1;
        bool keep = key < Sk;
        if (CAUSAL) keep = keep && visible(qpos[r], key, window);
        float x = s[j][e] * scale;
        if (bg != nullptr && key < Sk) x += bg[key];
        x = keep ? x : NEG_INF;
        const float p = exp2f(fmaf(x, LOG2E, -lse2[r]));
        s[j][e] = p * (dp[j][e] - dlt[r]) * scale;
      }
    }
    acc_times_rows<D>(acc, s, sK, g, t4);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    bf16* out = dq + ((int64_t)b * Sq + row) * q_stride + (int64_t)h * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + t4 * 2;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(out + col) =
            pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const bf16* __restrict__ dout, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                     float scale, int window, int q_offset) {
  constexpr int LD = HeadDim<D>::LD;
  constexpr int NT = HeadDim<D>::NT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;
  bf16* sdO = sQ + BM * LD;
  float* sL = reinterpret_cast<float*>(sdO + BM * LD);  // lse * log2e
  float* sD = sL + BM;                                  // delta

  const int k0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t kvbase = ((int64_t)b * Sk + k0) * kv_stride + (int64_t)hk * D;
  load_tile<D, BN>(sK, k + kvbase, kv_stride, Sk - k0);
  load_tile<D, BN>(sV, v + kvbase, kv_stride, Sk - k0);

  // keys g and g + 8 of this warp (rows of the transposed tiles)
  int key[2];
  float kb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + warp * 16 + g + 8 * r;
    kb[r] = (bias != nullptr && key[r] < Sk) ? bias[(int64_t)b * Sk + key[r]]
                                             : 0.f;
  }

  // the q tiles whose rows can see a key of this tile
  const int nq = (Sq + BM - 1) / BM;
  int jq_start = 0, jq_end = nq;
  if (CAUSAL) {
    const int64_t first = max((int64_t)k0 - q_offset, (int64_t)0);
    jq_start = (int)min(first / BM, (int64_t)nq);
    if (window > 0) {
      const int64_t last = (int64_t)k0 + BN - 1 + window - q_offset - 1;
      jq_end = last < 0 ? 0 : (int)min(last / BM + 1, (int64_t)nq);
    }
    if (jq_end < jq_start) jq_end = jq_start;
  }

  float acc_dk[NT][4], acc_dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc_dk[n][0] = acc_dk[n][1] = acc_dk[n][2] = acc_dk[n][3] = 0.f;
    acc_dv[n][0] = acc_dv[n][1] = acc_dv[n][2] = acc_dv[n][3] = 0.f;
  }

  const bf16* sKw = sK + warp * 16 * LD;
  const bf16* sVw = sV + warp * 16 * LD;
  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    for (int jq = jq_start; jq < jq_end; ++jq) {
      const int q0 = jq * BM;
      const int64_t qbase = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D, BM>(sQ, q + qbase, q_stride, Sq - q0);
      load_tile<D, BM>(sdO, dout + qbase, q_stride, Sq - q0);
      for (int i = threadIdx.x; i < BM; i += THREADS) {
        const int row = q0 + i;
        const int64_t idx = ((int64_t)b * H + h) * Sq + row;
        sL[i] = row < Sq ? lse[idx] * LOG2E : __int_as_float(0x7f800000);
        sD[i] = row < Sq ? delta[idx] : 0.f;
      }
      __syncthreads();

      float s[BM / 8][4], dp[BM / 8][4];
      rows_times_rows<D>(s, sKw, sQ, g, t4);    // S^T: 16 keys x 64 rows
      rows_times_rows<D>(dp, sVw, sdO, g, t4);  // dP^T

#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = j * 8 + t4 * 2 + (e & 1);
          const int r = e >> 1;
          bool keep = key[r] < Sk;
          if (CAUSAL) {
            keep = keep && visible((int64_t)q_offset + q0 + rl, key[r], window);
          }
          float x = s[j][e] * scale;
          if (bias != nullptr) x += kb[r];
          x = keep ? x : NEG_INF;
          const float p = exp2f(fmaf(x, LOG2E, -sL[rl]));
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sD[rl]) * scale;
        }
      }
      acc_times_rows<D>(acc_dv, s, sdO, g, t4);   // dV += P^T dO
      acc_times_rows<D>(acc_dk, dp, sQ, g, t4);   // dK += dS^T Q
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= Sk) continue;
    const int64_t base =
        ((int64_t)b * Sk + key[r]) * kv_stride + (int64_t)hk * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + t4 * 2;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(dk + base + col) =
            pack_bf16(acc_dk[n][2 * r], acc_dk[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + base + col) =
            pack_bf16(acc_dv[n][2 * r], acc_dv[n][2 * r + 1]);
      }
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const float* bias, const float* lse, const float* delta,
                   const bf16* dout, bf16* dq, bf16* dk, bf16* dv, int B,
                   int Sq, int Sk, int H, int Hkv, float scale, int window,
                   int q_offset, cudaStream_t stream) {
  const int smem = (2 * BM + 2 * BN) * HeadDim<D>::LD * (int)sizeof(bf16);
  const int smem_kv = smem + 2 * BM * (int)sizeof(float);
  auto kdq = flash_bwd_dq_kernel<D, CAUSAL>;
  auto kkv = flash_bwd_dkv_kernel<D, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  kdq<<<dim3((Sq + BM - 1) / BM, H, B), THREADS, smem, stream>>>(
      q, k, v, bias, lse, delta, dout, dq, Sq, Sk, H, Hkv, scale, window,
      q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<dim3((Sk + BN - 1) / BN, Hkv, B), THREADS, smem_kv, stream>>>(
      q, k, v, bias, lse, delta, dout, dk, dv, Sq, Sk, H, Hkv, scale, window,
      q_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const bf16* q, const bf16* k, const bf16* v,
                     const float* bias, const float* lse, const float* delta,
                     const bf16* dout, bf16* dq, bf16* dk, bf16* dv, int B,
                     int Sq, int Sk, int H, int Hkv, float scale, int causal,
                     int window, int q_offset, cudaStream_t stream) {
  if (causal) {
    return launch<D, true>(q, k, v, bias, lse, delta, dout, dq, dk, dv, B,
                           Sq, Sk, H, Hkv, scale, window, q_offset, stream);
  }
  return launch<D, false>(q, k, v, bias, lse, delta, dout, dq, dk, dv, B, Sq,
                          Sk, H, Hkv, scale, 0, q_offset, stream);
}

}  // namespace

// Plain C entry for ctypes: launches the dq kernel, then the dk/dv kernel, on
// `stream`. Returns a cudaError_t (0 on success); an unsupported head dim
// returns cudaErrorInvalidValue without launching. window <= 0 means no
// sliding window (causal only); bias may be null.
extern "C" int gvllm_flash_bwd(const void* q, const void* k, const void* v,
                               const void* bias, const void* lse,
                               const void* delta, const void* dout, void* dq,
                               void* dk, void* dv, int B, int Sq, int Sk,
                               int H, int Hkv, int D, float scale, int causal,
                               int window, int q_offset, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const float* bp = static_cast<const float*>(bias);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  const bf16* op = static_cast<const bf16*>(dout);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch<64>(qp, kp, vp, bp, lp, dp, op, dqp, dkp, dvp, B, Sq,
                          Sk, H, Hkv, scale, causal, window, q_offset, st);
    case 88:
      return dispatch<88>(qp, kp, vp, bp, lp, dp, op, dqp, dkp, dvp, B, Sq,
                          Sk, H, Hkv, scale, causal, window, q_offset, st);
    case 96:
      return dispatch<96>(qp, kp, vp, bp, lp, dp, op, dqp, dkp, dvp, B, Sq,
                          Sk, H, Hkv, scale, causal, window, q_offset, st);
    case 128:
      return dispatch<128>(qp, kp, vp, bp, lp, dp, op, dqp, dkp, dvp, B, Sq,
                           Sk, H, Hkv, scale, causal, window, q_offset, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
