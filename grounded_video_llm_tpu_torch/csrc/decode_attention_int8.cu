// One-query decode attention over an int8 KV cache, Hopper (sm_90a).
//
// K4: replaces grounded_video_llm_tpu/ops/decode_attention_int8.py `_kernel`
// (wrappers decode_attention_int8 and decode_attention_int8_layer).
//
// Contract, per batch row b and query head h (kv head hk = h / G):
//   q [B,H,D] bf16; cache k8, v8 [B,Hkv,L,D] int8 (one slot's D bytes are
//   contiguous) with fp32 scales ks, vs [B,Hkv,L]; valid [B,L] bytes;
//   the current token's k_new, v_new [B,Hkv,D] bf16 as one more slot.
//   s_i   = (sum_d bf16(q)[d] * k8[i][d]) * ks[i] * scale, or the fp32
//           minimum where valid[i] == 0;
//   s_new = (sum_d q[d] * k_new[d]) * scale          (q not rounded here);
//   m = max(max_i s_i, s_new); p_i = exp(s_i - m); p_new = exp(s_new - m);
//   pv_i  = bf16(p_i * vs[i]);
//   out[d] = (sum_i v8[i][d] * pv_i + p_new * v_new[d]) / (sum_i p_i + p_new)
//   in bf16. The new slot is always valid, so a row never dies.
//
// What bounds it on an H100: every cache byte is read once per step and used
// for ~2 operations per head in the group, far below the ridge, so the cache
// stream is the limit: 147.5 MB at B = 6, L = 3,840, 32 heads of 96 -> 44 us.
//
// Design. One block of 8 warps per (b, kv head) serves the G query heads of
// the group. Pass 1: each warp takes four slots at a time, eight lanes per
// slot, each lane reading D/32 contiguous 4-byte words of its slot (four
// coalesced rows per warp instruction); the dot is reduced over the eight
// lanes with three shuffles; scores stay in shared memory (G * L floats,
// dynamic shared memory). Pass 2: threads over slots form p and
// bf16(p * vs) in place and sum p. Pass 3: the same slot walk, each lane
// accumulating sum v8 * pv over its columns; slot groups and warps are
// reduced with shuffles and shared memory. D must be a multiple of 32.
// Two passes over the scores keep the exact global-max softmax of the
// Pallas kernel (pv is rounded after subtracting the final max). At B = 1
// there are only 32 blocks for 132 SMs; splitting the slots across blocks
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 128;
constexpr int MAX_WPL = MAX_D / 32;   // 4-byte words per lane, D % 32 == 0

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum over the 8 lanes of a slot group
__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void bf16x4(const bf16* p, float out[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(u.x << 16);
  out[1] = __uint_as_float(u.x & 0xFFFF0000u);
  out[2] = __uint_as_float(u.y << 16);
  out[3] = __uint_as_float(u.y & 0xFFFF0000u);
}

__device__ __forceinline__ void i8x4(int word, float out[4]) {
  out[0] = (float)(int8_t)(word & 0xFF);
  out[1] = (float)(int8_t)((word >> 8) & 0xFF);
  out[2] = (float)(int8_t)((word >> 16) & 0xFF);
  out[3] = (float)(int8_t)((word >> 24) & 0xFF);
}

template <int G>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ k8,
              const float* __restrict__ ks, const int8_t* __restrict__ v8,
              const float* __restrict__ vs, const uint8_t* __restrict__ valid,
              const bf16* __restrict__ k_new, const bf16* __restrict__ v_new,
              bf16* __restrict__ out, int Hkv, int L, int D, float scale) {
  extern __shared__ float s[];                   // [G][L]
  __shared__ float red[WARPS][G][MAX_D];
  __shared__ float stat[WARPS][G];
  __shared__ float s_new[G], m_row[G], denom[G];

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a warp walks 4 slots at a time: 8 lanes per slot, each lane owning
  // WPL = D / 32 consecutive 4-byte words (columns sub*4*WPL ...)
  const int sg = lane >> 3, sub = lane & 7;
  const int wpl = D >> 5;
  const int col0 = sub * 4 * wpl;
  const size_t head = (size_t)b * Hkv + hk;       // cache row (b, hk)
  const int8_t* kh = k8 + head * L * D;
  const int8_t* vh = v8 + head * L * D;
  const float* ksh = ks + head * L;
  const float* vsh = vs + head * L;
  const uint8_t* vm = valid + (size_t)b * L;
  const int H = Hkv * G;

  // this lane's columns of q (bf16 already, so also its bf16 rounding)
  float qf[G][4 * MAX_WPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int w = 0; w < MAX_WPL; ++w) {
      if (w < wpl) {
        bf16x4(q + ((size_t)b * H + hk * G + g) * D + col0 + 4 * w, &qf[g][4 * w]);
      } else {
        qf[g][4 * w] = qf[g][4 * w + 1] = qf[g][4 * w + 2] = qf[g][4 * w + 3] = 0.f;
      }
    }

  // the new slot's score (warp 0, slot group 0)
  if (warp == 0) {
    float kn[4 * MAX_WPL];
#pragma unroll
    for (int w = 0; w < MAX_WPL; ++w) {
      if (w < wpl) {
        bf16x4(k_new + head * D + col0 + 4 * w, &kn[4 * w]);
      } else {
        kn[4 * w] = kn[4 * w + 1] = kn[4 * w + 2] = kn[4 * w + 3] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 4 * MAX_WPL; ++c) part = fmaf(qf[g][c], kn[c], part);
      part = group8_sum(part);
      if (lane == 0) s_new[g] = part * scale;
    }
  }

  // pass 1: scores of the cache slots, running max per lane
  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = -FLT_MAX;
  // the loop bound is warp-uniform: every lane reaches the shuffles
  for (int base = warp * 4; base < L; base += WARPS * 4) {
    const int i = base + sg;
    const bool in = i < L;
    int kw[MAX_WPL];
    const int* row = reinterpret_cast<const int*>(kh + (size_t)i * D + col0);
#pragma unroll
    for (int w = 0; w < MAX_WPL; ++w) kw[w] = (in && w < wpl) ? __ldg(row + w) : 0;
    const float ksc = in ? ksh[i] : 0.f;
    const bool keep = in && vm[i] != 0;
    float kv[4 * MAX_WPL];
#pragma unroll
    for (int w = 0; w < MAX_WPL; ++w) i8x4(kw[w], &kv[4 * w]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 4 * MAX_WPL; ++c) part = fmaf(qf[g][c], kv[c], part);
      part = group8_sum(part);
      const float sc = keep ? part * ksc * scale : -FLT_MAX;
      mx[g] = fmaxf(mx[g], sc);
      if (sub == 0 && in) s[g * L + i] = sc;
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float m = warp_max(mx[g]);
    if (lane == 0) stat[warp][g] = m;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float m = s_new[g];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, stat[w][g]);
    m_row[g] = m;
  }
  __syncthreads();

  // pass 2: p_i = exp(s_i - m), the sum of p, and pv_i = bf16(p_i * vs_i)
  float psum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) psum[g] = 0.f;
  for (int i = threadIdx.x; i < L; i += THREADS) {
    const float vsc = vsh[i];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = expf(s[g * L + i] - m_row[g]);
      psum[g] += p;
      s[g * L + i] = __bfloat162float(__float2bfloat16_rn(p * vsc));
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float t = warp_sum(psum[g]);
    if (lane == 0) stat[warp][g] = t;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += stat[w][g];
    denom[g] = t + expf(s_new[g] - m_row[g]);
  }

  // pass 3: sum_i v8[i] * pv_i over this lane's columns
  float acc[G][4 * MAX_WPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < 4 * MAX_WPL; ++c) acc[g][c] = 0.f;
  for (int i = warp * 4 + sg; i < L; i += WARPS * 4) {
    int vw[MAX_WPL];
    const int* row = reinterpret_cast<const int*>(vh + (size_t)i * D + col0);
#pragma unroll
    for (int w = 0; w < MAX_WPL; ++w) vw[w] = w < wpl ? __ldg(row + w) : 0;
    float vv[4 * MAX_WPL];
#pragma unroll
    for (int w = 0; w < MAX_WPL; ++w) i8x4(vw[w], &vv[4 * w]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float pv = s[g * L + i];
#pragma unroll
      for (int c = 0; c < 4 * MAX_WPL; ++c) acc[g][c] = fmaf(vv[c], pv, acc[g][c]);
    }
  }
  // the 4 slot groups of a warp hold the same columns: add them up
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < 4 * MAX_WPL; ++c) {
      float v = acc[g][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[g][c] = v;
    }
  if (sg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4 * MAX_WPL; ++c)
        if (c < 4 * wpl) red[warp][g][col0 + c] = acc[g][c];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * D; t += THREADS) {
    const int g = t / D, d = t % D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w][g][d];
    const float p_new = expf(s_new[g] - m_row[g]);
    const float vn = __bfloat162float(v_new[head * D + d]);
    out[((size_t)b * H + hk * G + g) * D + d] =
        __float2bfloat16_rn((sum + p_new * vn) / denom[g]);
  }
}

template <int G>
int launch(const void* q, const void* k8, const void* ks, const void* v8,
           const void* vs, const void* valid, const void* k_new,
           const void* v_new, void* out, int B, int Hkv, int L, int D,
           float scale, cudaStream_t st) {
  const size_t smem = (size_t)G * L * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<G><<<B * Hkv, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const float*>(vs), static_cast<const uint8_t*>(valid),
      static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
      static_cast<bf16*>(out), Hkv, L, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,H,D] bf16, k8/v8 [B,Hkv,L,D] int8, ks/vs [B,Hkv,L] fp32, valid [B,L]
// bytes, k_new/v_new [B,Hkv,D] bf16 -> out [B,H,D] bf16. H = Hkv * G.
extern "C" int gvllm_decode_attention_int8(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* valid, const void* k_new, const void* v_new,
    void* out, int B, int H, int Hkv, int L, int D, float scale,
    void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv || L < 1 || D < 32 || D % 32 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / Hkv) {
    case 1: return launch<1>(q, k8, ks, v8, vs, valid, k_new, v_new, out, B, Hkv, L, D, scale, st);
    case 2: return launch<2>(q, k8, ks, v8, vs, valid, k_new, v_new, out, B, Hkv, L, D, scale, st);
    case 4: return launch<4>(q, k8, ks, v8, vs, valid, k_new, v_new, out, B, Hkv, L, D, scale, st);
    case 8: return launch<8>(q, k8, ks, v8, vs, valid, k_new, v_new, out, B, Hkv, L, D, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
