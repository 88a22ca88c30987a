// int8-weight matrix products for the decode path, Hopper (sm_90a):
//
//   gvllm_int8_matmul  weight-only, any M < 256, any O (the int8 lm_head's
//                      O = 32,366 included). Replaces
//                      grounded_video_llm_tpu/ops/int8_matmul.py int8_matmul
//                      (K6, `_mm_kernel`) and the weight-only branch of
//                      int8_matmul_layer (K3), the same function.
//   gvllm_int8_gemv    w8a8: replaces the w8a8 branch of int8_matmul_layer
//                      (K3, its inner `kernel`): the four decoder projections
//                      per layer per decode step on the int8 KV-cache path
//                      under the int8_full marker.
//
// Contract: y[M,O] (bf16) from x[M,D] bf16, w[D,O] int8 row-major and
// per-output-channel fp32 scales s[O].
//   weight-only: y = (sum_d x[m,d] * w[d,o]) * s[o], fp32 sum (every product
//                of a bf16 and an int8 is exact in fp32), then rounded to bf16;
//   w8a8:        per row xs = max(absmax(x[m,:]) / 127, 1e-8),
//                x8 = clip(rint(x / xs), -127, 127) (round half to even, as
//                jnp.round), an exact int32 dot, then
//                (float(dot) * xs) * s[o] rounded to bf16.
//
// What bounds it on an H100. Decode has M = batch <= 8 rows, so each weight
// byte is used M times: ~2M operations per byte against the card's ~590
// int8 (or ~295 bf16) operations per byte at the ridge. The weight stream is
// the limit: 3.35 TB/s, e.g. 15 us for the 50.3 MB gate_up matrix.
//
// Design. One thread owns 16 consecutive output columns (one 16-byte load per
// weight row, coalesced across the 8 threads that cover a block's 128
// columns) and walks rows four at a time ("quads"). A block of 8 warps puts
// 32 quad-lanes on one 128-column tile; the D rows are further split across
// gridDim.y blocks (split-K) so that even the 3072-wide outputs give a few
// hundred blocks. Each block reduces its quad-lanes with warp shuffles and
// shared memory and writes an fp32 (weight-only) or int32 (w8a8) partial;
// a second kernel sums the partials in split order (deterministic), scales
// and rounds. Rows beyond M inside an M tile are zero and never stored.
//   weight-only: int8 -> fp32 by byte permute plus one subtraction (exact),
//                then fp32 FMAs;
//   w8a8:        a first kernel quantizes the rows of x; each 4x4 byte block
//                of weights is transposed in registers (byte permutes) so
//                that one dp4a takes four rows of one column.
// Not done yet (later work): tensor-core mma with swapped operands, cp.async
// or TMA pipelining, a single-pass split-K reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 16;                       // output columns per thread
constexpr int COL_THREADS = 8;                 // threads across a tile
constexpr int BLOCK_O = COLS * COL_THREADS;    // 128 columns per block
constexpr int QUAD_LANES = THREADS / COL_THREADS;  // 32

// the 4 int8 bytes of `biased` are b + 128 (the word XOR 0x80808080)
__device__ __forceinline__ float i8_to_f32(uint32_t biased, int byte) {
  uint32_t bits = __byte_perm(biased, 0x4B000000u, 0x7540 + byte);
  return __uint_as_float(bits) - 8388736.0f;   // 2^23 + 128
}

__device__ __forceinline__ float bf16_lo(uint32_t two) {
  return __uint_as_float(two << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t two) {
  return __uint_as_float(two & 0xFFFF0000u);
}

// rows d..d+3, columns col0..col0+15 of w into wq[row][word]
template <bool VEC>
__device__ __forceinline__ void load_quad(const int8_t* __restrict__ w,
                                          int d, int col0, int O,
                                          uint32_t wq[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int8_t* row = w + (size_t)(d + r) * O;
    if (VEC) {
      if (col0 < O) {
        int4 v = __ldg(reinterpret_cast<const int4*>(row + col0));
        wq[r][0] = (uint32_t)v.x;
        wq[r][1] = (uint32_t)v.y;
        wq[r][2] = (uint32_t)v.z;
        wq[r][3] = (uint32_t)v.w;
      } else {
        wq[r][0] = wq[r][1] = wq[r][2] = wq[r][3] = 0u;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t word = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = col0 + 4 * j + b;
          uint32_t byte = col < O ? (uint32_t)(uint8_t)__ldg(row + col) : 0u;
          word |= byte << (8 * b);
        }
        wq[r][j] = word;
      }
    }
  }
}

// Sum acc over the 4 quad-lanes of each warp, then over the warps; write the
// block's partial sums for its (split, M tile, column tile).
template <int MT, typename T>
__device__ __forceinline__ void reduce_store(T acc[MT][COLS], T* __restrict__ part,
                                             int M, int O, int m0) {
  __shared__ T red[WARPS][MT][BLOCK_O];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, ct = lane & 7;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      T v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  }
  if (lane < COL_THREADS) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) red[warp][m][ct * COLS + c] = acc[m][c];
    }
  }
  __syncthreads();
  for (int i = tid; i < MT * BLOCK_O; i += THREADS) {
    const int m = i / BLOCK_O, c = i % BLOCK_O;
    T s = 0;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) s += red[wp][m][c];
    const int row = m0 + m, col = blockIdx.x * BLOCK_O + c;
    if (row < M && col < O)
      part[((size_t)blockIdx.y * M + row) * O + col] = s;
  }
}

struct Range {
  int begin, end;   // quads of 4 rows
};

__device__ __forceinline__ Range split_range(int D, int nsplit) {
  const int quads = D >> 2;
  const int per = (quads + nsplit - 1) / nsplit;
  Range r;
  r.begin = blockIdx.y * per;
  r.end = min(r.begin + per, quads);
  return r;
}

// weight-only: fp32 partials part[split][M][O]
template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
gemv_wo_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
               float* __restrict__ part, int M, int D, int O, int nsplit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = lane & 7, ql = warp * 4 + (lane >> 3);
  const int col0 = blockIdx.x * BLOCK_O + ct * COLS;
  const int m0 = blockIdx.z * MT;
  const Range rg = split_range(D, nsplit);
  float acc[MT][COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;

  for (int qd = rg.begin + ql; qd < rg.end; qd += QUAD_LANES) {
    const int d = qd * 4;
    uint32_t wq[4][4];
    load_quad<VEC>(w, d, col0, O, wq);
    uint2 xp[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      xp[m] = make_uint2(0u, 0u);
      if (m0 + m < M)
        xp[m] = __ldg(reinterpret_cast<const uint2*>(x + (size_t)(m0 + m) * D + d));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t biased = wq[r][j] ^ 0x80808080u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float wf = i8_to_f32(biased, b);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const uint32_t two = (r < 2) ? xp[m].x : xp[m].y;
            const float xv = (r & 1) ? bf16_hi(two) : bf16_lo(two);
            acc[m][4 * j + b] = fmaf(xv, wf, acc[m][4 * j + b]);
          }
        }
      }
    }
  }
  reduce_store<MT, float>(acc, part, M, O, m0);
}

// w8a8: x8 [M][D] int8 from quant_rows_kernel; int32 partials
template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
gemv_w8a8_kernel(const int8_t* __restrict__ x8, const int8_t* __restrict__ w,
                 int* __restrict__ part, int M, int D, int O, int nsplit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = lane & 7, ql = warp * 4 + (lane >> 3);
  const int col0 = blockIdx.x * BLOCK_O + ct * COLS;
  const int m0 = blockIdx.z * MT;
  const Range rg = split_range(D, nsplit);
  int acc[MT][COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0;

  for (int qd = rg.begin + ql; qd < rg.end; qd += QUAD_LANES) {
    const int d = qd * 4;
    uint32_t wq[4][4];
    load_quad<VEC>(w, d, col0, O, wq);
    int xw[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      xw[m] = (m0 + m < M)
                  ? __ldg(reinterpret_cast<const int*>(x8 + (size_t)(m0 + m) * D + d))
                  : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // 4x4 byte transpose: rows d..d+3 of columns 4j..4j+3 -> one word per
      // column with row d+r in byte r
      const uint32_t t0 = __byte_perm(wq[0][j], wq[1][j], 0x5140);
      const uint32_t t1 = __byte_perm(wq[2][j], wq[3][j], 0x5140);
      const uint32_t t2 = __byte_perm(wq[0][j], wq[1][j], 0x7362);
      const uint32_t t3 = __byte_perm(wq[2][j], wq[3][j], 0x7362);
      int colw[4];
      colw[0] = (int)__byte_perm(t0, t1, 0x5410);
      colw[1] = (int)__byte_perm(t0, t1, 0x7632);
      colw[2] = (int)__byte_perm(t2, t3, 0x5410);
      colw[3] = (int)__byte_perm(t2, t3, 0x7632);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < MT; ++m)
          acc[m][4 * j + k] = __dp4a(colw[k], xw[m], acc[m][4 * j + k]);
    }
  }
  reduce_store<MT, int>(acc, part, M, O, m0);
}

// one block per row of x: xs[row] and x8[row][:]
__global__ void __launch_bounds__(THREADS)
quant_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ x8,
                  float* __restrict__ xs, int D) {
  __shared__ float red[WARPS];
  const bf16* xr = x + (size_t)blockIdx.x * D;
  float amax = 0.f;
  for (int d = threadIdx.x; d < D; d += THREADS)
    amax = fmaxf(amax, fabsf(__bfloat162float(xr[d])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) amax = fmaxf(amax, red[i]);
  const float s = fmaxf(amax / 127.0f, 1e-8f);
  int8_t* out = x8 + (size_t)blockIdx.x * D;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float v = rintf(__bfloat162float(xr[d]) / s);
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    out[d] = (int8_t)v;
  }
  if (threadIdx.x == 0) xs[blockIdx.x] = s;
}

__global__ void finish_wo_kernel(const float* __restrict__ part,
                                 const float* __restrict__ scale,
                                 bf16* __restrict__ y, int M, int O,
                                 int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * O) return;
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * M * O + i];
  y[i] = __float2bfloat16_rn(s * scale[i % O]);
}

__global__ void finish_w8a8_kernel(const int* __restrict__ part,
                                   const float* __restrict__ xs,
                                   const float* __restrict__ scale,
                                   bf16* __restrict__ y, int M, int O,
                                   int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * O) return;
  int s = 0;
  for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * M * O + i];
  y[i] = __float2bfloat16_rn(__int2float_rn(s) * xs[i / O] * scale[i % O]);
}

int m_tile(int M) {
  return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 6 ? 6 : 8;
}

template <int MT>
void launch_main(bool w8a8, bool vec, const void* xin, const int8_t* w,
                 void* part, int M, int D, int O, int nsplit,
                 cudaStream_t st) {
  dim3 grid((O + BLOCK_O - 1) / BLOCK_O, nsplit, (M + MT - 1) / MT);
  if (w8a8) {
    const int8_t* x8 = static_cast<const int8_t*>(xin);
    int* p = static_cast<int*>(part);
    if (vec)
      gemv_w8a8_kernel<MT, true><<<grid, THREADS, 0, st>>>(x8, w, p, M, D, O, nsplit);
    else
      gemv_w8a8_kernel<MT, false><<<grid, THREADS, 0, st>>>(x8, w, p, M, D, O, nsplit);
  } else {
    const bf16* x = static_cast<const bf16*>(xin);
    float* p = static_cast<float*>(part);
    if (vec)
      gemv_wo_kernel<MT, true><<<grid, THREADS, 0, st>>>(x, w, p, M, D, O, nsplit);
    else
      gemv_wo_kernel<MT, false><<<grid, THREADS, 0, st>>>(x, w, p, M, D, O, nsplit);
  }
}

int launch(const void* x, const void* w, const void* scale, void* y,
           void* x8, void* xs, void* part, int M, int D, int O, int w8a8,
           int nsplit, void* stream) {
  if (M < 1 || D < 4 || (D & 3) || O < 1 || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const bool vec = (O % 16 == 0) && ((uintptr_t)w % 16 == 0);
  const void* xin = x;
  if (w8a8) {
    quant_rows_kernel<<<M, THREADS, 0, st>>>(static_cast<const bf16*>(x),
                                             static_cast<int8_t*>(x8),
                                             static_cast<float*>(xs), D);
    xin = x8;
  }
  switch (m_tile(M)) {
    case 1: launch_main<1>(w8a8, vec, xin, wp, part, M, D, O, nsplit, st); break;
    case 2: launch_main<2>(w8a8, vec, xin, wp, part, M, D, O, nsplit, st); break;
    case 4: launch_main<4>(w8a8, vec, xin, wp, part, M, D, O, nsplit, st); break;
    case 6: launch_main<6>(w8a8, vec, xin, wp, part, M, D, O, nsplit, st); break;
    default: launch_main<8>(w8a8, vec, xin, wp, part, M, D, O, nsplit, st); break;
  }
  const int n = M * O;
  const int blocks = (n + THREADS - 1) / THREADS;
  if (w8a8)
    finish_w8a8_kernel<<<blocks, THREADS, 0, st>>>(
        static_cast<const int*>(part), static_cast<const float*>(xs),
        static_cast<const float*>(scale), static_cast<bf16*>(y), M, O, nsplit);
  else
    finish_wo_kernel<<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(part), static_cast<const float*>(scale),
        static_cast<bf16*>(y), M, O, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// w8a8: x [M,D] bf16, w [D,O] int8, scale [O] fp32 -> y [M,O] bf16.
// x8 [M,D] int8, xs [M] fp32 and part (nsplit*M*O int32) are scratch.
extern "C" int gvllm_int8_gemv(const void* x, const void* w, const void* scale,
                               void* y, void* x8, void* xs, void* part, int M,
                               int D, int O, int nsplit, void* stream) {
  return launch(x, w, scale, y, x8, xs, part, M, D, O, 1, nsplit, stream);
}

// weight-only, same shapes; part: nsplit*M*O fp32 scratch. Any O (byte
// loads when O % 16 != 0).
extern "C" int gvllm_int8_matmul(const void* x, const void* w,
                                 const void* scale, void* y, void* part, int M,
                                 int D, int O, int nsplit, void* stream) {
  return launch(x, w, scale, y, nullptr, nullptr, part, M, D, O, 0, nsplit,
                stream);
}
