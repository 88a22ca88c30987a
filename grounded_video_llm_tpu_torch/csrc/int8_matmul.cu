// int8-weight matrix products for decode and verify, Hopper (sm_90a): one
// kernel, two C entries.
//
//   gvllm_int8_gemv    w8a8: replaces the w8a8 branch of
//                      grounded_video_llm_tpu/ops/int8_matmul.py
//                      int8_matmul_layer (:151, its `kernel` at :132; K3):
//                      the four decoder projections of a decode step or a
//                      verify pass under the int8_full marker.
//   gvllm_int8_matmul  weight-only: replaces int8_matmul (:192, `_mm_kernel`
//                      at :35; K6, the int8 lm_head) and the weight-only
//                      branch of int8_matmul_layer (K3 in modes B and C).
//
// Contract: y[M,O] bf16 from x[M,D] bf16, w[D,O] int8 whose rows start ldw
// bytes apart (ldw % 16 == 0: a ragged O, such as the lm_head's 32,366, is
// stored in padded rows, ops/int8_matmul.empty_int8_weight) and
// per-output-channel fp32 scales s[O]; D % 8 == 0.
//   weight-only: y = (sum_d x[m,d] * w[d,o]) * s[o]: fp32 sums of exact
//                bf16 x int8 products, rounded to bf16 once;
//   w8a8:        per row xs = max(absmax(x[m,:]) / 127, 1e-8) (a true
//                division), x8 = clip(rint(x / xs), -127, 127) (round half
//                to even), an exact int32 dot, y = (float(dot) * xs) * s[o]
//                rounded to bf16 once: bit-equal to the plain version.
//
// What bounds it on an H100: the weight stream. Each weight byte is used 2M
// times; at the verify pass's M = 30 that is 60 operations a byte against
// the ~590 int8 (~295 bf16) a byte of the card's ridge, so bytes bound every
// decode (M = 1, 6) and verify (M = 30) call: D * O / 3.35 TB/s, 8.4 us for
// Phi-3.5's qkv (28.3 MB), 1.09 ms for a step's 128 projections, where the
// operations of a pass at M = 30 take 0.11 ms in int8.
//
// Design, against what held the first version of this kernel (a GEMV on CUDA
// cores, three launches a w8a8 call) back:
//  1. Each weight byte is read once for every M <= 32. The x rows, padded to
//     NP = 8, 16 or 32, are the N side of the tensor-core products (one n8
//     tile per 8 rows) and the output columns the M side, so one pass over
//     the weights serves every row. M = 33..255 takes ceil(M / 32) passes
//     (grid y), each a full read.
//  2. One launch a call, no scratch in device memory. The D rows are split
//     over a thread-block cluster of C blocks per 128-column tile (split-K).
//     Each block keeps its partial sums in shared memory; after a cluster
//     barrier output element e is summed over the C blocks in rank order
//     through distributed shared memory (two launches are bit-equal),
//     scaled and written by block e / 288 % C. w8a8: x's slice of the NP
//     rows comes by TMA ahead of the weights; each block takes the absmax of
//     its slice of every row and sends it to every block of the cluster with
//     st.async (completing on the receiver's mbarrier: a cluster barrier
//     here, with its release, would wait for the weight loads in flight);
//     each then has the row's exact max and quantizes its slice into shared
//     memory while its weights stream in. The quotient x / xs comes from
//     x * (1 / xs) and two FMA corrections, correctly rounded as a division
//     (quantize8).
//  3. The ragged vocabulary on the fast path. The weights are read by TMA
//     through a 2-D tensor map [D rows, O columns] in boxes of 64 rows x 128
//     columns; TMA needs 16-byte row pitches only, and columns past O read
//     as zeros and are never written.
//  4. Tensor cores, and bytes in flight. A producer warp keeps a ring of up
//     to 12 stages of 8 KB (weight-only: plus the stage's x box, 64 columns
//     of the NP rows) in flight on mbarriers; two blocks an SM hold up to
//     ~200 KB of loads in flight on each SM. Eight consumer warps own 16
//     columns each: ldmatrix.trans reads 32 weight rows x 16 columns of the
//     128-byte-swizzled stage (no bank conflicts) and puts rows 2t, 2t + 1
//     of columns 2g, 2g + 1 in one register.
//       weight-only: i8x4_to_bf16 makes the A fragments of mma.sync
//       m16n8k16 (columns 2g: MMA rows 0-7, columns 2g + 1: rows 8-15)
//       exactly, with two logic ops and one packed subtraction a pair; x's
//       B fragments come from the x box by ldmatrix; fp32 sums.
//       w8a8: two byte permutes of two such registers give the A fragment
//       of m16n8k32 s8 with the k order 2t, 2t + 1, 8 + 2t, 9 + 2t; x8 is
//       written to shared memory in that order, one 8-byte load a fragment;
//       int32 sums.
//  5. The launch uses programmatic stream serialization: the blocks may be
//     placed, and set up their barriers, while the previous kernel on the
//     stream drains; grid_dependency_wait comes before any read or write of
//     device memory (weights included), so the result is the same.
// What is left (PERF.md): per call the launch, the wait for the first weight
// stage, the cluster epilogue and the slowest block's tail; a Phi-3.5
// projection streams 9-50 MB, so those fixed costs hold the smallest (o,
// 9.4 MB) near 3x its bound.
//
// Launch plan (make_plan; ops/int8_matmul.int8_matmul_plan mirrors it):
// tiles = ceil(O / 128), passes = ceil(M / 32), kst = ceil(D / 64) stages of
// weight rows. Clusters of about TARGET_BLOCKS / (tiles * passes) blocks
// (two blocks an SM, one wave of 132 SMs), at least 1 and at most 8 (CPORT)
// and kst; spb = ceil(kst / C) stages a block and C = ceil(kst / spb), so no
// block is empty. Shared memory (at most 112 KB, two blocks an SM): the
// ring, as many stages as fit, at most spb (it doubles as the [NP][132]
// fp32 partial sums after the loop); w8a8's x boxes (NP rows of the slice
// in bf16, rounded up to 128 columns) and x8 slice (NP rows of spb * 64 + 32
// bytes); the row maxima, row scales and the tile's scales; the mbarriers.
// Where w8a8's slice leaves less than two stages C grows, up to 16
// (non-portable clusters); a plan with none is refused (w8a8 past
// D = 14,336 at M > 16, 30,720 at M 9-16, 61,440 at M <= 8).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int8_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CONSUMERS = 8;                   // warps, 16 columns each
constexpr int THREADS = 32 * (CONSUMERS + 1);  // + the producer warp
constexpr int BO = 16 * CONSUMERS;             // columns a tile (128 bytes)
constexpr int BK = 64;                         // weight rows a stage
constexpr int MP = 32;                         // x rows a pass
constexpr int W_STAGE = BK * BO;               // weight bytes a stage
constexpr int OUT_PITCH = BO + 4;              // floats a partial-sum row
constexpr int CMAX = 16;                       // blocks a cluster (non-portable above 8)
constexpr int CPORT = 8;                       // ... unless shared memory needs more
// one wave of BLOCKS_PER_SM blocks on each of an H100's 132 SMs, each
// within SMEM_TARGET of shared memory
constexpr int BLOCKS_PER_SM = 2;
constexpr int TARGET_BLOCKS = 132 * BLOCKS_PER_SM;
constexpr int SMEM_TARGET = 112 * 1024;
constexpr int ALIGN = 1024;   // a 128-byte-swizzled TMA box starts here
constexpr int XBOX = 128;     // x columns a TMA box, w8a8

struct Plan {
  int NP, passes, tiles, C, spb, stages, stage, pitch;
  int off_xb, off_x8, off_stat, off_bar, smem;
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// false where the kernel cannot take (M, D, O) or no cluster fits
inline bool make_plan(int M, int D, int O, bool w8a8, Plan* p) {
  if (M < 1 || D < 8 || D % 8 || O < 1 || (w8a8 && O % 16)) return false;
  p->NP = M <= 8 ? 8 : M <= 16 ? 16 : MP;
  p->passes = (M + MP - 1) / MP;
  p->tiles = (O + BO - 1) / BO;
  p->stage = W_STAGE + (w8a8 ? 0 : p->NP * 128);
  const int kst = (D + BK - 1) / BK;
  const int top = kst < CMAX ? kst : CMAX;
  int c0 = TARGET_BLOCKS / (p->tiles * p->passes);
  if (c0 > CPORT) c0 = CPORT;
  if (c0 < 1) c0 = 1;
  if (c0 > top) c0 = top;
  for (int c = c0; c <= top; ++c) {
    p->spb = (kst + c - 1) / c;
    p->C = (kst + p->spb - 1) / p->spb;
    p->pitch = p->spb * BK + 32;
    const int xb = w8a8 ? p->NP * round_up(p->spb * BK, XBOX) * 2 : 0;
    const int x8 = w8a8 ? round_up(p->NP * p->pitch, 128) : 0;
    const int stat = ((CMAX + 1) * MP + BO) * 4;
    int n = (SMEM_TARGET - ALIGN - xb - x8 - stat) / (p->stage + 16);
    if (n > p->spb) n = p->spb;
    if (n < (p->spb < 2 ? p->spb : 2)) continue;
    const int out = p->NP * OUT_PITCH * 4;
    const int ring = n * p->stage > out ? n * p->stage : round_up(out, 128);
    p->stages = n;
    p->off_xb = ring;
    p->off_x8 = ring + xb;
    p->off_stat = p->off_x8 + x8;
    p->off_bar = p->off_stat + stat;
    p->smem = ALIGN + p->off_bar + 16 * n + 16;   // + xbar and abar
    return true;
  }
  return false;
}

struct Args {
  const bf16* x;
  const float* scale;
  bf16* y;
  int M, D, O;
  Plan plan;
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

// c += a b: A 16x32 (row), B 32x8 (col), int8, int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// box of a 2-D tensor map at (column c, row r) into shared memory;
// completion counts on the barrier's transaction bytes
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r)
      : "memory");
}

// the float v into the shared memory of the cluster's block `rank` at the
// offset `addr` has in this block's, completing `bar`'s transaction bytes
// there (the receiver's barrier expects them)
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar,
                                         int rank) {
  uint32_t raddr, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(raddr) : "r"(addr), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar) : "r"(bar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(raddr), "f"(v), "r"(rbar)
      : "memory");
}

// every thread of the cluster, once each block's barriers are initialised
// (fence.mbarrier_init before it); a relaxed arrive, which does not wait
// for the weight loads in flight
__device__ __forceinline__ void cluster_started() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Launched with programmatic stream serialization, the kernel's blocks may
// start while the previous kernel on the stream drains; this waits for it
// (and its memory). Every read of device memory and every write comes after
// it; only the block's own set-up comes before.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the consumer warps alone (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(CONSUMERS * 32) : "memory");
}

// every warp of the block, from the producer's and the consumers' own code
// paths (named barrier 2)
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"r"(THREADS) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float bf16_bits(uint32_t two, int hi) {
  return __uint_as_float(hi ? two & 0xFFFF0000u : two << 16);
}

// The 8 bf16 values of w4 (the low half of each word first) as
// rint(v / xs), v / xs the true (correctly rounded) quotient, packed in 2
// words (byte i value i), without a division: with inv = RN(1 / xs), t =
// RN(v * inv) is within 2 ulps of v / xs; one correction q1 = RN(t +
// RN(v - t * xs) * inv) is within an ulp of it, and then (Markstein's
// theorem: v - q1 * xs is exact, inv within half an ulp of 1 / xs)
// RN(q1 + (v - q1 * xs) * inv) is the correctly rounded quotient. No
// underflow matters here: a quotient within reach of a half-integer has
// |v| >= xs / 2 >= 5e-9. |v| <= absmax and xs >= absmax / 127 up to
// rounding, so |v / xs| < 127.5 and the contract's clip to +-127 never
// binds.
__device__ __forceinline__ uint2 quantize8(const uint32_t (&w4)[4], float xs,
                                           float inv) {
  int q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = bf16_bits(w4[i >> 1], i & 1), t = v * inv;
    const float q1 = fmaf(fmaf(-t, xs, v), inv, t);
    q[i] = __float2int_rn(fmaf(fmaf(-q1, xs, v), inv, q1));
  }
  return make_uint2(
      __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                  __byte_perm(q[2], q[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(q[4], q[5], 0x0040),
                  __byte_perm(q[6], q[7], 0x0040), 0x5410));
}

// ---------------------------------------------------------------------------
// the kernel: block (tile * C + rank, pass); NT n8 tiles of x rows
// ---------------------------------------------------------------------------

template <bool W8A8, int NT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
int8_mm_kernel(const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap xmap, const Args a) {
  typedef typename std::conditional<W8A8, int, float>::type Acc;
  constexpr int NP = 8 * NT;
  extern __shared__ uint8_t smem_raw[];
  const Plan& p = a.plan;
  const int M = a.M, D = a.D, O = a.O;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;           // mma fragment coordinates
  const int rank = (int)cluster_rank();
  const int o0 = (blockIdx.x / p.C) * BO, m0 = blockIdx.y * MP;
  const int k0 = rank * p.spb * BK;                // the block's first row
  const int kst = (D + BK - 1) / BK;
  const int nst = min(p.spb, kst - rank * p.spb);  // its stages
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~uint32_t(ALIGN - 1);
  uint8_t* smem = smem_raw + (base - raw);
  // w8a8: the cluster's row maxima, [rank][MP], sent by st.async
  float* amax_in = reinterpret_cast<float*>(smem + p.off_stat);
  float* xs_s = amax_in + CMAX * MP;                                 // [MP]
  float* sc_s = xs_s + MP;                                           // [BO]
  uint8_t* x8s = smem + p.off_x8;                  // [NP][pitch], w8a8
  const uint8_t* xbs = smem + p.off_xb;            // x boxes [NP][XBOX], w8a8
  const uint32_t full0 = base + p.off_bar, empty0 = full0 + 8 * p.stages;
  const uint32_t xbar = empty0 + 8 * p.stages;     // the x boxes, w8a8
  const uint32_t abar = xbar + 8;                  // amax_in, w8a8
  const int span = nst * BK;                       // the slice's columns
  const int nbox = (span + XBOX - 1) / XBOX;

  if (warp == CONSUMERS) {
    // the producer: stage s of the slice into ring slot s % stages. Lane 0
    // sets up the barriers and issues the first stages before the block's
    // first barrier, so the weights are on their way while the consumers
    // read x
    auto issue = [&](int s, int slot) {
      const uint32_t dst = base + slot * p.stage, bar = full0 + 8 * slot;
      mbar_expect_tx(bar, p.stage);
      tma_load_2d(dst, &wmap, bar, o0, k0 + s * BK);
      if (!W8A8) tma_load_2d(dst + W_STAGE, &xmap, bar, k0 + s * BK, m0);
    };
    const int first = min(nst, p.stages);
    if (lane == 0) {
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, CONSUMERS);
      }
      mbar_init(xbar, 1);
      mbar_init(abar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      grid_dependency_wait();
      if (W8A8) {                     // x's slice first: ahead of the weights
        mbar_expect_tx(abar, p.C * NP * 4);
        mbar_expect_tx(xbar, nbox * NP * XBOX * 2);
        for (int b = 0; b < nbox; ++b)
          tma_load_2d(base + p.off_xb + b * NP * XBOX * 2, &xmap, xbar,
                      k0 + b * XBOX, m0);
      }
      for (int s = 0; s < first; ++s) issue(s, s);
    }
    block_sync();                     // the barriers are set up
    if (W8A8) cluster_started();      // and the cluster's (see below)
    if (lane == 0) {
      int slot = 0;
      uint32_t phase = 0;
      for (int s = first; s < nst; ++s) {
        mbar_wait(empty0 + 8 * slot, phase);
        issue(s, slot);
        if (++slot == p.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    grid_dependency_wait();
    if (threadIdx.x < BO)             // the tile's scales, for the epilogue
      sc_s[threadIdx.x] = o0 + threadIdx.x < O ? a.scale[o0 + threadIdx.x] : 0.f;
    block_sync();                     // the barriers are set up
    if constexpr (W8A8) {
      cluster_started();              // the peers' abar too
      // x's rows m0 .. m0 + NP - 1 over the slice arrive by TMA (boxes of
      // XBOX columns, [NP][XBOX] each, zeros past M and D), issued before
      // the weights, so no load of x waits behind the weight stream. Row
      // n = warp + 8r: the absmax of its slice (the last box's columns
      // past the slice are x's own, so they leave the row's max as it
      // is); each block sends its maxima to
      // every block of the cluster (st.async into amax_in, completing on
      // the receiver's abar: no cluster barrier, which would wait for the
      // weight loads in flight), so each takes the row's max (exact, in
      // any order); then each
      // quantizes its slice into x8s in the fragment order: within each 32
      // columns, lane t's 8 bytes are columns 2t, 2t + 1, 8 + 2t, 9 + 2t,
      // then the same + 16
      // the 16 bytes of row warp + 8r at slice columns 8c .. 8c + 7
      auto chunk = [&](int r, int c) {
        return *reinterpret_cast<const uint4*>(
            xbs + ((c / (XBOX / 8)) * NP + warp + CONSUMERS * r) * (XBOX * 2) +
            16 * (c % (XBOX / 8)));
      };
      mbar_wait(xbar, 0);
      float am[NT];
#pragma unroll
      for (int r = 0; r < NT; ++r) {
        am[r] = 0.f;
        for (int c = lane; c < nbox * (XBOX / 8); c += 32) {
          const uint4 v = chunk(r, c);
          const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            am[r] = fmaxf(am[r], fabsf(bf16_bits(w4[i >> 1], i & 1)));
        }
        am[r] = warp_max(am[r]);
        if (lane < p.C)
          st_async(smem_addr(amax_in + rank * MP + warp + CONSUMERS * r),
                   am[r], abar, lane);
      }
      mbar_wait(abar, 0);
#pragma unroll
      for (int r = 0; r < NT; ++r) {
        const int n = warp + CONSUMERS * r;
        const float v = lane < p.C ? amax_in[lane * MP + n] : 0.f;
        const float xs = fmaxf(warp_max(v) / 127.0f, 1e-8f);
        const float inv = 1.0f / xs;
        if (lane == 0) xs_s[n] = xs;
        uint8_t* row = x8s + n * p.pitch;
        for (int kk = 8 * lane; kk < span; kk += 256) {
          const uint4 v4 = chunk(r, kk / 8);
          const uint32_t w4[4] = {v4.x, v4.y, v4.z, v4.w};
          const uint2 q = quantize8(w4, xs, inv);
          // the 8 columns' byte pairs go to lanes 0-3 of the fragment
          // order (see above), 8 bytes apart
          uint8_t* dst = row + (kk & ~31) + 4 * ((kk >> 4) & 1) + ((kk & 8) ? 2 : 0);
          *reinterpret_cast<uint16_t*>(dst) = (uint16_t)q.x;
          *reinterpret_cast<uint16_t*>(dst + 8) = (uint16_t)(q.x >> 16);
          *reinterpret_cast<uint16_t*>(dst + 16) = (uint16_t)q.y;
          *reinterpret_cast<uint16_t*>(dst + 24) = (uint16_t)(q.y >> 16);
        }
      }
      consumers_sync();               // x8s complete
    }

    Acc acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
    int slot = 0;
    uint32_t phase = 0;
    for (int s = 0; s < nst; ++s) {
      mbar_wait(full0 + 8 * slot, phase);
      const uint32_t wst = base + slot * p.stage;
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // two halves of 32 weight rows
        const int row = h * 32 + lane;
        uint32_t r[4];
        ldsm_x4_trans(r, wst + row * 128 + ((warp ^ (row & 7)) << 4));
        if constexpr (W8A8) {
          const uint32_t af[4] = {__byte_perm(r[0], r[1], 0x6420),
                                  __byte_perm(r[0], r[1], 0x7531),
                                  __byte_perm(r[2], r[3], 0x6420),
                                  __byte_perm(r[2], r[3], 0x7531)};
          const uint8_t* xb = x8s + s * BK + h * 32 + t * 8;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint2 b = *reinterpret_cast<const uint2*>(
                xb + (nt * 8 + g) * p.pitch);
            mma_s8(acc[nt], af, b.x, b.y);
          }
        } else {
          uint32_t a0[4], a1[4];
          i8x4_to_bf16(r[0], a0[0], a0[1]);   // rows 0-7: (col 2g, col 2g+1)
          i8x4_to_bf16(r[1], a0[2], a0[3]);   // rows 8-15
          i8x4_to_bf16(r[2], a1[0], a1[1]);   // rows 16-23
          i8x4_to_bf16(r[3], a1[2], a1[3]);   // rows 24-31
          const uint32_t xst = wst + W_STAGE;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = nt * 8 + (lane & 7), c = h * 4 + (lane >> 3);
            uint32_t b[4];
            ldsm_x4(b, xst + n * 128 + ((c ^ (n & 7)) << 4));
            mma_bf16(acc[nt], a0, b[0], b[1]);
            mma_bf16(acc[nt], a1, b[2], b[3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }
    }

    // the block's partial sums [NP][OUT_PITCH] over the ring, once every
    // consumer is done with it: MMA row g is column 2g, row g + 8 column
    // 2g + 1; MMA columns 2t, 2t + 1 are x rows
    consumers_sync();
    float* out = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * t, c = warp * 16 + 2 * g;
      float2 v0, v1;
      if constexpr (W8A8) {
        v0 = make_float2(__int_as_float(acc[nt][0]), __int_as_float(acc[nt][2]));
        v1 = make_float2(__int_as_float(acc[nt][1]), __int_as_float(acc[nt][3]));
      } else {
        v0 = make_float2(acc[nt][0], acc[nt][2]);
        v1 = make_float2(acc[nt][1], acc[nt][3]);
      }
      *reinterpret_cast<float2*>(out + n * OUT_PITCH + c) = v0;
      *reinterpret_cast<float2*>(out + (n + 1) * OUT_PITCH + c) = v1;
    }
  }

  // the cluster's sums: element e of the [NP][128] tile is block
  // (e / THREADS) % C's, which adds the C partials in rank order
  cluster_sync();
  grid_dependency_wait();
  const float* out = reinterpret_cast<const float*>(smem);
  for (int e = rank * THREADS + threadIdx.x; e < NP * BO; e += p.C * THREADS) {
    const int n = e / BO, c = e % BO;
    const int m = m0 + n, o = o0 + c;
    if (m >= M || o >= O) continue;
    const uint32_t addr = smem_addr(out + n * OUT_PITCH + c);
    float v[CMAX];
#pragma unroll
    for (int r = 0; r < CMAX; ++r) v[r] = r < p.C ? ld_cluster(addr, r) : 0.f;
    float y;
    if constexpr (W8A8) {
      int sum = 0;
#pragma unroll
      for (int r = 0; r < CMAX; ++r) sum += __float_as_int(v[r]);
      y = __fmul_rn(__fmul_rn(__int2float_rn(sum), xs_s[n]), sc_s[c]);
    } else {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < CMAX; ++r)
        if (r < p.C) sum += v[r];
      y = __fmul_rn(sum, sc_s[c]);
    }
    a.y[(size_t)m * O + o] = __float2bfloat16_rn(y);
  }
  cluster_sync();   // every block's partials stay until the others read them
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

// cuTensorMapEncodeTiled from libcuda, looked up once (the library links
// only the CUDA runtime)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a 2-D tensor map (cols x rows, rows `pitch` bytes apart) read in boxes
// of box_cols x box_rows; out-of-range elements read as zeros
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
              int cols, int rows, long long pitch, int box_cols,
              int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool W8A8, int NT>
int launch(const CUtensorMap& wmap, const CUtensorMap& xmap, const Args& a,
           cudaStream_t st) {
  auto kern = int8_mm_kernel<W8A8, NT>;
  static bool attr_set = false;   // a block's whole shared memory, once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.plan.tiles * a.plan.C),
                     (unsigned)a.plan.passes);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)a.plan.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.plan.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // the blocks may be placed while the previous kernel drains (see
  // grid_dependency_wait)
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, wmap, xmap, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool W8A8>
int run(const void* x, const void* w, int ldw, const void* scale, void* y,
        int M, int D, int O, void* stream) {
  Args a = {};
  if (!make_plan(M, D, O, W8A8, &a.plan) || ldw < O || ldw % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const bf16*>(x);
  a.scale = static_cast<const float*>(scale);
  a.y = static_cast<bf16*>(y);
  a.M = M;
  a.D = D;
  a.O = O;
  CUtensorMap wmap, xmap;
  // w8a8 reads x's slice in boxes of XBOX columns, weight-only a stage's 64
  // columns beside each weight stage (128-byte swizzled, as ldmatrix
  // reads it)
  if (!make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, O, D, ldw, BO, BK,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, D, M, 2LL * D,
                W8A8 ? XBOX : 64, a.plan.NP,
                W8A8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.plan.NP) {
    case 8: return launch<W8A8, 1>(wmap, xmap, a, st);
    case 16: return launch<W8A8, 2>(wmap, xmap, a, st);
    default: return launch<W8A8, 4>(wmap, xmap, a, st);
  }
}

}  // namespace

// w8a8: x [M,D] bf16, w [D,O] int8 (rows ldw bytes apart), scale [O] fp32
// -> y [M,O] bf16; O % 16 == 0. cudaErrorInvalidValue where the plan or
// the alignment refuses.
extern "C" int gvllm_int8_gemv(const void* x, const void* w, int ldw,
                               const void* scale, void* y, int M, int D,
                               int O, void* stream) {
  return run<true>(x, w, ldw, scale, y, M, D, O, stream);
}

// weight-only, same arguments, any O.
extern "C" int gvllm_int8_matmul(const void* x, const void* w, int ldw,
                                 const void* scale, void* y, int M, int D,
                                 int O, void* stream) {
  return run<false>(x, w, ldw, scale, y, M, D, O, stream);
}
