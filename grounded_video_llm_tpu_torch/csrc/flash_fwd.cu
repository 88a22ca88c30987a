// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces grounded_video_llm_tpu/ops/flash_attention.py:_fwd_kernel (the
// non-causal kernel: CLIP ViT-L and the InternVideo2 trunk in bounded-softmax
// mode) and :_fwd_kernel_causal (LLM prefill), with the same contract as
// _flash_fwd: q [B,Sq,H,D], k/v [B,Sk,Hkv,D] bf16 (GQA: q head h reads kv head
// h / (H/Hkv)), an optional additive fp32 key bias [B,Sk]; returns o
// [B,Sq,H,D] bf16 and the row logsumexp lse [B,H,Sq] fp32. A row with no
// valid key gives o = 0 and lse = +inf, never NaN.
//
// Design. The Pallas kernels hold a head's whole K/V in VMEM; a CUDA block
// has at most 227 KB of shared memory, so that layout cannot carry over.
// Here one block of 4 warps owns one (batch, q-head, 64-row q tile); each warp
// owns 16 q rows. An inner loop streams 64-key K/V tiles through shared
// memory and keeps an online softmax (running max m, running sum l) in
// registers, so the [Sq, Sk] score matrix never leaves the SM. Both products
// (Q K^T and P V) run on the tensor cores as mma.sync m16n8k16 bf16 -> fp32;
// P is rounded to bf16 for the second product exactly where the Pallas
// kernel casts it, and the row sums stay fp32.
//
// What bounds it on an H100. A head costs 4*S*S*D flops against 8*S*D bytes
// of q, k, v and o, about S/2 flops per byte: near the card's bf16 ridge
// (~295) at S = 577 and well above it at S = 2049 and 3.7k, so the tensor
// cores are the first limit. The exp per score is the second: the SFUs issue
// 16 exp2 per SM per clock against ~2048 tensor-core bf16 FMAs, and a score
// costs 2*D FMAs (Q K^T and P V) but one exp2, so at D = 64 the exps take as
// long as the products and at D = 96 about two thirds as long. What the
// design does about it: scores never go to device memory; causal blocks skip
// every key tile above the diagonal (half the prefill work); bounded mode
// keeps m fixed at 40 and skips the row-max reduction and the rescale of the
// accumulator; the softmax runs in the log2 domain so each score costs one
// FMA and one exp2. This version reaches ~85-90 TFLOP/s at the slice's
// shapes on an H100 SXM at 700 W (PERF.md), far from both limits. What it
// does not do yet (later work): wgmma, TMA, larger q tiles, and overlapping
// the next tile's load with the current tile's math (the loads here are
// synchronous).
//
// Trouble spots handled on purpose:
//  * D = 88 is not a multiple of 16: the contraction pads to 96 with zero
//    columns in shared memory; padded output columns are never stored.
//  * Ragged Sk (2049): keys past Sk are masked by bounds. Their shared-memory
//    rows are zero-filled (garbage there could be NaN, and 0 * NaN = NaN).
//  * Masked scores are -FLT_MAX and the running max starts at -1e30, so it
//    stays finite and exp2 of a masked score underflows to exactly 0.
//  * Sliding window: keep = kpos <= qpos && qpos - kpos < window; the tile
//    range also skips whole tiles below the window.
//
// A second entry, gvllm_flash_variant (M2), replaces
// scripts/microbench_encoder_attn.py:174 (`flash_variant`, `_kernel` :47):
// the InternVideo2 attention variants that script times. Non-causal,
// maskless, q/k/v/o [B,H,S,D] (head-major), no lse. Its modes are template
// modes of the same tile loop: "full" (online max, exact softmax), "offset"
// (p = exp2(s * log2e - 30 * log2e); the script's nomax, exp2, unroll2, pipe
// and dh128 compute this one function and differ only in TPU scheduling),
// "noexp" (p = s, the bound with no transcendental; its row sums can be near
// 0 or negative, so it has no dead-row rule) and "sumdot" (the offset
// softmax whose denominator sums the bf16-rounded p, as the script's ones
// column in the PV product does). P enters the PV product in bf16; the
// denominator is fp32 (of fp32 p, or of bf16 p for sumdot). The script's
// block_q sweep is a Mosaic tiling knob with no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;              // q rows per block
constexpr int BN = 64;              // keys per K/V tile
constexpr int WARPS = BM / 16;      // one warp per 16 q rows
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -FLT_MAX;  // masked score (JAX NEG_INF)
constexpr float M_INIT = -1e30f;     // finite start of the running max
constexpr float LOG2E = 1.4426950408889634f;
constexpr float BOUNDED_OFFSET = 40.0f;   // K1's bounded mode
constexpr float VARIANT_OFFSET = 30.0f;   // M2's fixed offset

// how a tile's scores become p and the row sums
enum Mode {
  kOnline = 0,  // running row max, rescaled accumulator (exact softmax)
  kFixed = 1,   // fixed offset in place of the row max (bounded scores)
  kNoExp = 2,   // p = s (M2 only)
  kSumDot = 3,  // kFixed with the row sums over bf16-rounded p (M2 only)
};

// element strides of q (and o) and of k/v
struct Strides {
  int64_t q_row, q_head, q_batch, kv_row, kv_head, kv_batch;
};

template <int D>
struct HeadDim {
  static constexpr int DP = (D + 15) / 16 * 16;  // contraction padded to k16
  // +8 bf16 per row: the fragment loads of 8 rows x 4 column pairs then hit
  // 32 distinct banks for every DP used here (64, 96, 128).
  static constexpr int LD = DP + 8;
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

template <int D, bool CAUSAL, int MODE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Sk,
                 int H, int Hkv, float scale, int window, int q_offset,
                 float offset, Strides st) {
  constexpr int DP = HeadDim<D>::DP;
  constexpr int LD = HeadDim<D>::LD;
  constexpr int KSTEPS = DP / 16;  // k16 steps of Q K^T
  constexpr int NT_O = DP / 8;     // n8 tiles of the output
  constexpr int NT_S = BN / 8;     // n8 tiles of a score tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * LD;
  bf16* sV = sK + BN * LD;

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread in group

  const int64_t q_stride = st.q_row;
  const int64_t kv_stride = st.kv_row;
  const bf16* qg = q + b * st.q_batch + h * st.q_head + q0 * q_stride;
  const bf16* kg = k + b * st.kv_batch + hk * st.kv_head;
  const bf16* vg = v + b * st.kv_batch + hk * st.kv_head;
  const float* bg = bias ? bias + (int64_t)b * Sk : nullptr;

  load_tile<D, BM>(sQ, qg, q_stride, Sq - q0);
  __syncthreads();

  // this warp's 16 q rows as mma A fragments, kept in registers
  uint32_t qf[KSTEPS][4];
  {
    const bf16* sQw = sQ + warp * 16 * LD;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const bf16* p = sQw + kk * 16 + t4 * 2;
      qf[kk][0] = ld32(p + g * LD);
      qf[kk][1] = ld32(p + (g + 8) * LD);
      qf[kk][2] = ld32(p + g * LD + 8);
      qf[kk][3] = ld32(p + (g + 8) * LD + 8);
    }
  }

  // rows g and g + 8 of this warp
  const int row0 = q0 + warp * 16 + g;
  const int qpos[2] = {q_offset + row0, q_offset + row0 + 8};

  int t_begin = 0;
  int t_end = (Sk + BN - 1) / BN;
  if (CAUSAL) {
    // keys beyond the block's last query position are masked for every row
    const int64_t hi = min((int64_t)q_offset + q0 + BM, (int64_t)Sk);
    t_end = hi <= 0 ? 0 : (int)((hi + BN - 1) / BN);
    if (window > 0) {
      const int64_t lo = (int64_t)q_offset + q0 - window + 1;
      if (lo > 0) t_begin = (int)(lo / BN);
    }
  }

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m_run[2] = {MODE == kOnline ? M_INIT : offset,
                    MODE == kOnline ? M_INIT : offset};
  float l_part[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // every warp is done reading the previous tile
    load_tile<D, BN>(sK, kg + (int64_t)k0 * kv_stride, kv_stride, Sk - k0);
    load_tile<D, BN>(sV, vg + (int64_t)k0 * kv_stride, kv_stride, Sk - k0);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const bf16* kp = sK + (j * 8 + g) * LD + kk * 16 + t4 * 2;
        mma_16816(s[j], qf[kk], ld32(kp), ld32(kp + 8));
      }
    }

    // scale, bias and masks; masked scores become NEG_INF (p = 0 after
    // the exp), or 0 where p = s
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t4 * 2 + (e & 1);
        bool keep = key < Sk;
        if (CAUSAL) {
          const int qp = qpos[e >> 1];
          keep = keep && key <= qp;
          if (window > 0) keep = keep && (qp - key < window);
        }
        float x = s[j][e] * scale;
        if (bg != nullptr && key < Sk) x += bg[key];
        s[j][e] = keep ? x : (MODE == kNoExp ? 0.f : NEG_INF);
      }
    }

    float alpha[2] = {1.f, 1.f};
    if (MODE == kOnline) {
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m_run[r] - mx[r]) * LOG2E);
        m_run[r] = mx[r];
        l_part[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }

    // p = exp(s - m) in the log2 domain; masked scores give exactly 0
    const float mb[2] = {m_run[0] * LOG2E, m_run[1] * LOG2E};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = MODE == kNoExp
                            ? s[j][e]
                            : exp2f(fmaf(s[j][e], LOG2E, -mb[e >> 1]));
        s[j][e] = p;
        l_part[e >> 1] +=
            MODE == kSumDot ? __bfloat162float(__float2bfloat16_rn(p)) : p;
      }
    }

    // O += P V: the score accumulators are reused as A fragments
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const bf16* vp = sV + (16 * kc + t4 * 2) * LD + n * 8 + g;
        mma_16816(acc[n], a, pack_pair(vp, vp + LD),
                  pack_pair(vp + 8 * LD, vp + 9 * LD));
      }
    }
  }

  // finish the rows: o = acc / l, lse = m + log(l); dead rows o = 0, +inf
  // (p = s has no dead rows: its sums may be negative)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    const bool dead = MODE != kNoExp && !(l > 0.f);
    const float inv = dead ? 0.f : 1.f / l;
    if (row < Sq) {
      bf16* orow = o + b * st.q_batch + h * st.q_head + row * q_stride;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const int col = n * 8 + t4 * 2;
        if (col < D) {
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
        }
      }
      if (lse != nullptr && t4 == 0) {
        lse[((int64_t)b * H + h) * Sq + row] =
            dead ? __int_as_float(0x7f800000) : m_run[r] + logf(l);
      }
    }
  }
}

template <int D, bool CAUSAL, int MODE>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const float* bias, bf16* o, float* lse, int B, int Sq,
                   int Sk, int H, int Hkv, float scale, int window,
                   int q_offset, float offset, const Strides& st,
                   cudaStream_t stream) {
  const int smem = (BM + 2 * BN) * HeadDim<D>::LD * (int)sizeof(bf16);
  auto kern = flash_fwd_kernel<D, CAUSAL, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  kern<<<grid, THREADS, smem, stream>>>(q, k, v, bias, o, lse, Sq, Sk, H, Hkv,
                                        scale, window, q_offset, offset, st);
  return cudaGetLastError();
}

// K1/K2: [B,S,H,D] q/o and [B,S,Hkv,D] k/v
template <int D>
cudaError_t dispatch(const bf16* q, const bf16* k, const bf16* v,
                     const float* bias, bf16* o, float* lse, int B, int Sq,
                     int Sk, int H, int Hkv, float scale, int causal,
                     int bounded, int window, int q_offset,
                     cudaStream_t stream) {
  const Strides st{(int64_t)H * D, D, (int64_t)Sq * H * D,
                   (int64_t)Hkv * D, D, (int64_t)Sk * Hkv * D};
  if (causal) {
    return launch<D, true, kOnline>(q, k, v, bias, o, lse, B, Sq, Sk, H, Hkv,
                                    scale, window, q_offset, 0.f, st, stream);
  }
  if (bounded) {
    return launch<D, false, kFixed>(q, k, v, bias, o, lse, B, Sq, Sk, H, Hkv,
                                    scale, 0, q_offset, BOUNDED_OFFSET, st,
                                    stream);
  }
  return launch<D, false, kOnline>(q, k, v, bias, o, lse, B, Sq, Sk, H, Hkv,
                                   scale, 0, q_offset, 0.f, st, stream);
}

// M2: [B,H,S,D] q, k, v and o, no bias, no lse
template <int D>
cudaError_t dispatch_variant(const bf16* q, const bf16* k, const bf16* v,
                             bf16* o, int B, int S, int H, float scale,
                             int mode, cudaStream_t stream) {
  const Strides st{D, (int64_t)S * D, (int64_t)H * S * D,
                   D, (int64_t)S * D, (int64_t)H * S * D};
  switch (mode) {
    case kOnline:
      return launch<D, false, kOnline>(q, k, v, nullptr, o, nullptr, B, S, S,
                                       H, H, scale, 0, 0, 0.f, st, stream);
    case kFixed:
      return launch<D, false, kFixed>(q, k, v, nullptr, o, nullptr, B, S, S,
                                      H, H, scale, 0, 0, VARIANT_OFFSET, st,
                                      stream);
    case kNoExp:
      return launch<D, false, kNoExp>(q, k, v, nullptr, o, nullptr, B, S, S,
                                      H, H, scale, 0, 0, 0.f, st, stream);
    case kSumDot:
      return launch<D, false, kSumDot>(q, k, v, nullptr, o, nullptr, B, S, S,
                                       H, H, scale, 0, 0, VARIANT_OFFSET, st,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes. Returns a cudaError_t (0 on success); an
// unsupported head dim returns cudaErrorInvalidValue without launching.
// causal ignores bounded, as the Pallas causal kernel does; window <= 0 means
// no sliding window; bias may be null.
extern "C" int gvllm_flash_fwd(const void* q, const void* k, const void* v,
                               const void* bias, void* o, void* lse, int B,
                               int Sq, int Sk, int H, int Hkv, int D,
                               float scale, int causal, int bounded,
                               int window, int q_offset, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch<64>(qp, kp, vp, bp, op, lp, B, Sq, Sk, H, Hkv, scale,
                          causal, bounded, window, q_offset, st);
    case 88:
      return dispatch<88>(qp, kp, vp, bp, op, lp, B, Sq, Sk, H, Hkv, scale,
                          causal, bounded, window, q_offset, st);
    case 96:
      return dispatch<96>(qp, kp, vp, bp, op, lp, B, Sq, Sk, H, Hkv, scale,
                          causal, bounded, window, q_offset, st);
    case 128:
      return dispatch<128>(qp, kp, vp, bp, op, lp, B, Sq, Sk, H, Hkv, scale,
                           causal, bounded, window, q_offset, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// M2: q, k, v, o [B,H,S,D] bf16; mode 0 full, 1 offset, 2 noexp, 3 sumdot.
// Returns a cudaError_t; an unsupported head dim or mode returns
// cudaErrorInvalidValue without launching.
extern "C" int gvllm_flash_variant(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int D, float scale, int mode,
                                   void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch_variant<64>(qp, kp, vp, op, B, S, H, scale, mode, st);
    case 88:
      return dispatch_variant<88>(qp, kp, vp, op, B, S, H, scale, mode, st);
    case 96:
      return dispatch_variant<96>(qp, kp, vp, op, B, S, H, scale, mode, st);
    case 128:
      return dispatch_variant<128>(qp, kp, vp, op, B, S, H, scale, mode, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
