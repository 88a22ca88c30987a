// Speculative-verify attention over an int8 KV cache, Hopper (sm_90a).
//
// K8: replaces grounded_video_llm_tpu/ops/decode_attention_int8.py
// `_kernel_multi` (wrappers verify_attention_int8 and
// verify_attention_int8_layer).
//
// Contract, per batch row b, query head h (kv head hk = h / G) and new token
// i < S:
//   q [B,S,H,D] bf16; cache k8, v8 [B,Hkv,L,D] int8 (one slot's D bytes are
//   contiguous) with fp32 scales ks, vs [B,Hkv,L]; mask [B,S,L] bytes, one
//   row per query token; the S new tokens' k_new, v_new [B,S,Hkv,D] bf16.
//   s_l  = (sum_d q[i][d] * k8[l][d]) * (ks[l] * scale), or the fp32 minimum
//          where mask[i][l] == 0;
//   n_j  = (sum_d q[i][d] * k_new[j][d]) * scale for j <= i, else the fp32
//          minimum (query i sees new tokens 0..i);
//   m = max(max_l s_l, max_j n_j); denom = sum_l e^(s_l-m) + sum_j e^(n_j-m);
//   pv_l = bf16((e^(s_l - m) / denom) * vs[l]);  pn_j = bf16(e^(n_j - m) / denom)
//   out[d] = sum_l pv_l * v8[l][d] + sum_j pn_j * v_new[j][d], in bf16.
// These are `_kernel_multi`'s roundings (the joint softmax is normalised
// before the value sums; q is bf16 for both score kinds), so at S = 1 the
// result is close to K4's, not bit-equal. Token 0 is always visible, so a
// query whose cache mask is empty still has a finite softmax.
//
// What bounds it on an H100: the cache stream, as for K4. Each int8 K row is
// scored once against all G * S queries of the block, which is the point of
// verify: one cache stream for S tokens. At B = 6, S = 5, 32 heads of 96 and
// 3,840 slots a launch must read ~148 MB -> 44 us at 3.35 TB/s.
//
// Design. One block of 8 warps per (b, kv head), Q = G * S queries.
// Pass 1: K4's slot walk (each warp four slots at a time, eight lanes per
// slot, each lane D/32 contiguous 4-byte words, the next slot group's words
// loaded while this one is scored), the dot against each query (q kept in
// shared memory as fp32, read as float4) reduced with three shuffles; raw
// scores go to shared memory, Q * L floats. The Q * S new-token scores are
// one warp reduction each. Pass 2: a warp per query row applies the row's
// mask (coalesced byte loads), takes the row max and the softmax
// denominator, and writes pv (bf16-rounded, as fp32) over its scores in
// place, and pn. Pass 3: threads take one 4-byte word of a slot's V row
// each, slot lanes stride over L four slots at a time, and accumulate up to
// 8 queries at a time; slot lanes are summed through shared memory, the new
// tokens' values added, and the output written. The launch refuses what
// does not fit the 227 KB of shared memory.

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
constexpr int QC = 8;                 // queries accumulated at once, pass 3
constexpr int SMEM_LIMIT = 227 * 1024;

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

// sum over the 8 lanes of a slot group
__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void i8x4(int word, float out[4]) {
  out[0] = (float)(int8_t)(word & 0xFF);
  out[1] = (float)(int8_t)((word >> 8) & 0xFF);
  out[2] = (float)(int8_t)((word >> 16) & 0xFF);
  out[3] = (float)(int8_t)((word >> 24) & 0xFF);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// shared memory floats: scores Q*L (rounded up to 4, so q is 16-byte
// aligned), q Q*D, new-token scores Q*S, and the pass-3 slot-lane partials
// lanes*QC*D
__host__ __device__ inline size_t scores_floats(int Q, int L) {
  return ((size_t)Q * L + 3) & ~(size_t)3;
}

__host__ __device__ inline size_t smem_floats(int Q, int S, int L, int D) {
  const int lanes = THREADS / (D / 4);
  return scores_floats(Q, L) + (size_t)Q * D + (size_t)Q * S
         + (size_t)lanes * QC * D;
}

__global__ void __launch_bounds__(THREADS)
verify_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ k8,
              const float* __restrict__ ks, const int8_t* __restrict__ v8,
              const float* __restrict__ vs, const uint8_t* __restrict__ mask,
              const bf16* __restrict__ k_new, const bf16* __restrict__ v_new,
              bf16* __restrict__ out, int Hkv, int G, int S, int L, int D,
              float scale) {
  extern __shared__ __align__(16) float smem[];
  const int Q = G * S;
  float* sc = smem;                    // [Q][L] scores, then pv
  float* qs = sc + scores_floats(Q, L); // [Q][D] q (bf16 values)
  float* sn = qs + (size_t)Q * D;      // [Q][S] new-token scores, then pn
  float* red = sn + (size_t)Q * S;     // [lanes][QC][D]

  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = Hkv * G;
  const size_t head = (size_t)b * Hkv + hk;       // cache row (b, hk)
  const int8_t* kh = k8 + head * L * D;
  const int8_t* vh = v8 + head * L * D;
  const float* ksh = ks + head * L;
  const float* vsh = vs + head * L;
  const uint8_t* mb = mask + (size_t)b * S * L;

  // query qi = g * S + i: head hk * G + g, token i
  for (int t = threadIdx.x; t < Q * D; t += THREADS) {
    const int qi = t / D, d = t % D;
    const int g = qi / S, i = qi % S;
    qs[t] = __bfloat162float(q[(((size_t)b * S + i) * H + hk * G + g) * D + d]);
  }
  __syncthreads();

  // pass 1a: cache scores. A warp walks 4 slots at a time: 8 lanes per slot,
  // each lane owning WPL = D / 32 consecutive 4-byte words (columns col0 ...)
  const int sg = lane >> 3, sub = lane & 7;
  const int wpl = D >> 5;
  const int col0 = sub * 4 * wpl;
  auto load_k = [&](int l, int kw[MAX_WPL], float& ksc) {
    const bool in = l < L;
    const int* row = reinterpret_cast<const int*>(kh + (size_t)l * D + col0);
#pragma unroll
    for (int w = 0; w < MAX_WPL; ++w) kw[w] = (in && w < wpl) ? __ldg(row + w) : 0;
    ksc = in ? ksh[l] * scale : 0.f;
  };
  int kw_next[MAX_WPL];
  float ksc_next;
  load_k(warp * 4 + sg, kw_next, ksc_next);
  // the loop bound is warp-uniform: every lane reaches the shuffles
  for (int base = warp * 4; base < L; base += WARPS * 4) {
    const int l = base + sg;
    float kv[4 * MAX_WPL];
#pragma unroll
    for (int w = 0; w < MAX_WPL; ++w) i8x4(kw_next[w], &kv[4 * w]);
    const float ksc = ksc_next;
    load_k(l + WARPS * 4, kw_next, ksc_next);        // the next slot group
    for (int qi = 0; qi < Q; ++qi) {
      const float4* qr = reinterpret_cast<const float4*>(qs + qi * D + col0);
      float part = 0.f;
#pragma unroll
      for (int w = 0; w < MAX_WPL; ++w)
        if (w < wpl) {
          const float4 qv = qr[w];
          part = fmaf(qv.x, kv[4 * w], part);
          part = fmaf(qv.y, kv[4 * w + 1], part);
          part = fmaf(qv.z, kv[4 * w + 2], part);
          part = fmaf(qv.w, kv[4 * w + 3], part);
        }
      part = group8_sum(part);
      if (sub == 0 && l < L) sc[(size_t)qi * L + l] = part * ksc;
    }
  }
  // pass 1b: new-token scores, one warp reduction per (query, new token)
  for (int p = warp; p < Q * S; p += WARPS) {
    const int qi = p / S, j = p % S;
    const bf16* kn = k_new + (((size_t)b * S + j) * Hkv + hk) * D;
    float part = 0.f;
    for (int d = lane; d < D; d += 32)
      part = fmaf(qs[qi * D + d], __bfloat162float(kn[d]), part);
    part = warp_sum(part);
    if (lane == 0) sn[qi * S + j] = j <= qi % S ? part * scale : -FLT_MAX;
  }
  __syncthreads();

  // pass 2: a warp per query row: the mask, max, denominator, then pv and
  // pn in place
  for (int qi = warp; qi < Q; qi += WARPS) {
    float* r = sc + (size_t)qi * L;
    float* nr = sn + qi * S;
    const uint8_t* mr = mb + (size_t)(qi % S) * L;
    float m = -FLT_MAX;
    for (int l = lane; l < L; l += 32) {
      const float v = mr[l] ? r[l] : -FLT_MAX;
      r[l] = v;
      m = fmaxf(m, v);
    }
    for (int j = lane; j < S; j += 32) m = fmaxf(m, nr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) sum += expf(r[l] - m);
    for (int j = lane; j < S; j += 32) sum += expf(nr[j] - m);
    sum = warp_sum(sum);
    for (int l = lane; l < L; l += 32)
      r[l] = bf16_round((expf(r[l] - m) / sum) * vsh[l]);
    for (int j = lane; j < S; j += 32)
      nr[j] = bf16_round(expf(nr[j] - m) / sum);
  }
  __syncthreads();

  // pass 3: out = sum_l pv_l v8[l] + sum_j pn_j v_new[j], QC queries at once
  const int nw = D >> 2;                       // 4-byte words per V row
  const int lanes = THREADS / nw;              // slot lanes
  const int sl = threadIdx.x / nw, w = threadIdx.x % nw;
  const bool worker = sl < lanes;
  for (int q0 = 0; q0 < Q; q0 += QC) {
    float acc[QC][4];
#pragma unroll
    for (int a = 0; a < QC; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    if (worker) {
      const int* vw = reinterpret_cast<const int*>(vh) + w;
      for (int l0 = sl; l0 < L; l0 += 4 * lanes) {
        int words[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int l = l0 + u * lanes;
          words[u] = l < L ? __ldg(vw + (size_t)l * nw) : 0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int l = l0 + u * lanes;
          if (l >= L) break;
          float vv[4];
          i8x4(words[u], vv);
#pragma unroll
          for (int a = 0; a < QC; ++a) {
            if (q0 + a < Q) {
              const float p = sc[(size_t)(q0 + a) * L + l];
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(vv[c], p, acc[a][c]);
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < QC; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) red[((size_t)sl * QC + a) * D + 4 * w + c] = acc[a][c];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < QC * D; t += THREADS) {
      const int a = t / D, d = t % D;
      const int qi = q0 + a;
      if (qi >= Q) continue;
      float total = 0.f;
      for (int s = 0; s < lanes; ++s) total += red[((size_t)s * QC + a) * D + d];
      const int g = qi / S, i = qi % S;
      for (int j = 0; j < S; ++j)
        total = fmaf(sn[qi * S + j],
                     __bfloat162float(v_new[(((size_t)b * S + j) * Hkv + hk) * D + d]),
                     total);
      out[(((size_t)b * S + i) * H + hk * G + g) * D + d] = __float2bfloat16_rn(total);
    }
    __syncthreads();
  }
}

}  // namespace

// q [B,S,H,D] bf16, k8/v8 [B,Hkv,L,D] int8, ks/vs [B,Hkv,L] fp32, mask
// [B,S,L] bytes, k_new/v_new [B,S,Hkv,D] bf16 -> out [B,S,H,D] bf16.
// H = Hkv * G; D in {32, 64, 96, 128}.
extern "C" int gvllm_verify_attention_int8(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* mask, const void* k_new, const void* v_new,
    void* out, int B, int S, int H, int Hkv, int L, int D, float scale,
    void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv || L < 1 || D < 32 || D % 32 ||
      D > MAX_D)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  const size_t smem = smem_floats(G * S, S, L, D) * sizeof(float);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      verify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  verify_kernel<<<B * Hkv, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const float*>(vs), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
      static_cast<bf16*>(out), Hkv, G, S, L, D, scale);
  return (int)cudaGetLastError();
}
