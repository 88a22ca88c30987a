// Attention over the int8 KV cache on Hopper (sm_90a): the one kernel behind
// K4 (decode_attention_int8.cu, one query token) and K8
// (verify_attention_int8.cu, S query tokens). Each .cu file states its
// contract; this header holds what they share. NORM_FIRST picks K8's order
// of normalisation, else K4's.
//
// Inputs (both): q [B,S,H,D] bf16 (K4: S = 1); cache k8, v8 [B,Hkv,L,D] int8
// (a slot's D bytes contiguous) with fp32 scales ks, vs [B,Hkv,L]; mask
// [B,S,L] bytes (K4: [B,L]); the S new tokens' k_new, v_new [B,S,Hkv,D]
// bf16. Query qi = g * S + i is head hk * G + g at token i (Q = G * S).
//
// Design. One thread-block cluster of C blocks (256 threads each) per
// (b, kv head); block `rank` owns chunks [rank * cpb, (rank + 1) * cpb) of
// 128 slots (CH), so the cluster's slots, and their scales, are contiguous.
//  1. Each block reads its share of the mask rows (16 bytes a load), keeps
//     them in shared memory as bits and lists the chunks some query of the
//     row sees; no other chunk is loaded (its slots would add
//     exp(-FLT_MAX - m) = 0 under both contracts).
//  2. The last warp's lane 0 issues the bulk asynchronous copies
//     (cp.async.bulk, completed on an mbarrier) into a ring of stages: for
//     each visible chunk its K rows and key scales, then its V rows. Where
//     the share fits the ring every copy is in flight at once and V arrives
//     while K is scored; else a stage is refilled once all eight warps
//     released it. The value scales are read from global memory into
//     registers while the cluster exchanges its maxima.
//  3. Scores on tensor cores (mma.sync m16n8k16 bf16, fp32 sums, two
//     accumulator chains): slots fill M (warp w takes slots 16w..16w+15 of
//     each chunk), queries fill N (one n8 tile per 8 queries: Q = 5 pads to
//     8), D is the reduction. ldmatrix reads a warp's 16 slots; int8 becomes
//     bf16 exactly with two logic ops and one packed subtraction a pair of
//     bytes (i8x4_to_bf16), pairing byte 0 with 2 and 1 with 3: the D order
//     of the product is permuted and q's B fragments are built in the same
//     permutation, so the sum is the same. Scores [Q][P] stay in shared
//     memory (fp32; masked ones the fp32 minimum); each lane keeps running
//     maxima of its queries.
//  4. Softmax over the cluster: each block's row maxima go to the others
//     through distributed shared memory (mapa + ld.shared::cluster) after a
//     cluster barrier, so every block uses the global max. p = exp(s - m)
//     in place; K8 then exchanges the partial denominators the same way
//     (summed in rank order, so every block holds the same fp32 value).
//     pv = bf16(p * vs) (K4) or bf16(p / denom * vs) (K8) is rounded from
//     exactly the value the plain version rounds, kept in fp32.
//  5. PV on tensor cores: D fills M (warp w takes columns 16w..16w+15; at
//     D = 96 warps 6 and 7 have none), queries fill N (up to 32 a pass, QG;
//     more queries stream V again), slots are the reduction. ldmatrix.trans
//     reads a 16-column tile of 8-slot rows, which again pairs bytes 0/2 and
//     1/3: here as columns 2j and 2j + 1 of M, undone where the fragment is
//     written out. A full chunk's loads all go out before any conversion.
//  6. Each block's partial output [queries][D] (fp32) stays in its shared
//     memory; after a cluster barrier output element e is block (e % C)'s,
//     which adds the C partials in rank order (two launches are bit-equal)
//     and the new tokens' terms, and writes it; a last barrier keeps every
//     block's shared memory alive until the others have read it.
// The new tokens' scores (8-lane reductions, CUDA cores) are rank 0's: its
// partial max and, for K8, its partial denominator include them, and the
// output's new-token terms (K8's pn, K4's p_new) are read from it.
//
// Launch plan (make_plan; ops/decode_attention_int8.attention_plan mirrors
// it): nch = ceil(L / 128) chunks. Clusters of TARGET_BLOCKS / (B * Hkv)
// blocks (three blocks an SM, one wave of 132 SMs), no more than leave each
// block 4 chunks (MIN_CHUNKS), at least 1 and at most 16 (CMAX); then
// cpb = ceil(nch / C) chunks a block and C = ceil(nch / cpb), so no block is
// empty. Shared memory: the ring (stages of 128 * (D + 4) bytes), scores
// Q * P fp32 (P = min(cpb * 128, L rounded up to 16) + 8), the share's mask
// S * cpb * 128 bits, q's fragments Q * D bf16, one pass's partial output
// min(Q, 32) * D fp32, the new tokens' scores Q * S fp32 and four fp32
// statistics a query. Stages are added up to 74 KB (three blocks an SM),
// never fewer than two unless the share needs fewer; while a block needs
// more than 74 KB, C grows (up to 16); a plan past 227 KB is refused. So
// the cap on L rose with the cluster: a block holds 1/16 of the row's
// scores and mask bits (4 * Q + S / 8 bytes a slot). At D = 96: Q = 1,
// 827,392 slots (the one-block design: 47,872, 187 KB of scores); Q = 5,
// 165,888 (was 9,985); G = 8, D = 128: 102,400 (was 5,984); Q = 20,
// D = 128: 38,912 (was 2,363).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 128;           // slots a chunk: one bulk copy, one mask test
constexpr int QG = 32;            // queries a value pass (four n8 tiles)
constexpr int CMAX = 16;          // blocks a cluster (non-portable above 8)
// the grid aims at one wave of BLOCKS_PER_SM blocks on each of an H100's 132
// SMs (also the kernel's __launch_bounds__: at most 85 registers a thread),
// each block within 228 KB / BLOCKS_PER_SM of shared memory
constexpr int BLOCKS_PER_SM = 3;
constexpr int TARGET_BLOCKS = 132 * BLOCKS_PER_SM;
constexpr int MIN_CHUNKS = 4;     // a block's share, where the grid allows
constexpr long long SMEM_TARGET = (228 / BLOCKS_PER_SM - 2) * 1024LL;
constexpr long long SMEM_LIMIT = 227 * 1024;

struct Plan {
  int C, cpb, P, ng, stages, stage, smem;
  int off_sc, off_mask, off_q, off_out, off_sn, off_stat, off_list, off_bar;
};

__host__ __device__ inline long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// the plan with clusters of about c0 blocks; false where it needs more
// shared memory than a block has
inline bool plan_with(int c0, int G, int S, int L, int D, Plan* p) {
  const long long Q = (long long)G * S, Qp = round_up(Q, 8);
  const int nch = (L + CH - 1) / CH;
  p->cpb = (nch + c0 - 1) / c0;
  p->C = (nch + p->cpb - 1) / p->cpb;
  // a score row's pitch: its positions, + 8 floats so that rows start 8
  // banks apart (the value pass reads a column of 8 rows at once)
  const long long P = (p->cpb * (long long)CH < round_up(L, 16)
                           ? p->cpb * (long long)CH : round_up(L, 16)) + 8;
  p->ng = (int)((Q + QG - 1) / QG);
  const long long items = (long long)p->cpb * (1 + p->ng);
  // a stage: rows and key scales (128-byte aligned), + its mbarriers
  const long long stage_bytes = (long long)CH * (D + 4);
  const long long stage = stage_bytes + 16;
  const long long sc = Q * P * 4, mb = round_up((long long)S * p->cpb * CH / 8, 16),
                  qb = Qp * D * 2,
                  ob = (Qp < QG ? Qp : QG) * D * 4, sn = round_up(Q * S * 4, 16),
                  st = round_up(16 * Q, 16), li = round_up(4LL * p->cpb, 16);
  const long long rest = sc + mb + qb + ob + sn + st + li;
  long long n = (SMEM_TARGET - rest) / stage;
  if (n < 2) n = 2;
  if (n > items) n = items;
  if (rest + n * stage > SMEM_LIMIT) n = (SMEM_LIMIT - rest) / stage;
  if (n < 1) return false;
  long long off = n * stage_bytes;
  p->off_sc = (int)off;    off += sc;
  p->off_mask = (int)off;  off += mb;
  p->off_q = (int)off;     off += qb;
  p->off_out = (int)off;   off += ob;
  p->off_sn = (int)off;    off += sn;
  p->off_stat = (int)off;  off += st;
  p->off_list = (int)off;  off += li;
  p->off_bar = (int)off;   off += 16 * n;
  p->P = (int)P;
  p->stages = (int)n;
  p->stage = (int)stage_bytes;
  p->smem = (int)off;
  return true;
}

// heads = B * Hkv clusters. Clusters of TARGET_BLOCKS / heads blocks, but
// no more than leave each block MIN_CHUNKS chunks (at least 1 block, at
// most CMAX and one a chunk), more while a block's shared memory passes
// SMEM_TARGET (BLOCKS_PER_SM blocks an SM); false where not even CMAX
// blocks fit
inline bool make_plan(int heads, int G, int S, int L, int D, Plan* p) {
  const int nch = (L + CH - 1) / CH;
  const int top = nch < CMAX ? nch : CMAX;
  int c0 = TARGET_BLOCKS / heads;
  if (c0 > (nch + MIN_CHUNKS - 1) / MIN_CHUNKS) c0 = (nch + MIN_CHUNKS - 1) / MIN_CHUNKS;
  if (c0 < 1) c0 = 1;
  if (c0 > top) c0 = top;
  for (; c0 <= top; ++c0)
    if (plan_with(c0, G, S, L, D, p) && (p->smem <= SMEM_TARGET || c0 == top))
      return true;
  return plan_with(top, G, S, L, D, p);
}

struct Args {
  const bf16* q;
  const int8_t* k8;
  const float* ks;
  const int8_t* v8;
  const float* vs;
  const uint8_t* mask;
  const bf16* k_new;
  const bf16* v_new;
  bf16* out;
  int Hkv, G, S, L;
  float scale;
  Plan plan;
};

// ---------------------------------------------------------------------------
// device helpers (the ones the int8 matrix products share are in
// int8_mma.cuh)
// ---------------------------------------------------------------------------

// *a = max(*a, v) for floats (ordered as ints by their sign bit); exact, so
// the order of the atomics does not matter
__device__ __forceinline__ void atomic_max_float(float* a, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

// the float at `addr` in each of the cluster's first n blocks, all loads in
// flight at once (v[r] = 0 for r >= n)
__device__ __forceinline__ void ld_ranks(float (&v)[CMAX], uint32_t addr, int n) {
#pragma unroll
  for (int r = 0; r < CMAX; ++r) v[r] = r < n ? ld_cluster(addr, r) : 0.f;
}

// v[0] + v[1] + ... + v[n - 1], in rank order
__device__ __forceinline__ float sum_ranks(const float (&v)[CMAX], int n) {
  float t = 0.f;
#pragma unroll
  for (int r = 0; r < CMAX; ++r)
    if (r < n) t += v[r];
  return t;
}

// ---------------------------------------------------------------------------
// the kernel. NORM_FIRST: K8's contract (the softmax is normalised before
// PV, pv = bf16(p / denom * vs), new tokens' pn = bf16(p_new / denom));
// else K4's (pv = bf16(p * vs), the division at the end).
// ---------------------------------------------------------------------------

template <int D, bool NORM_FIRST>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) attention_kernel(const Args a) {
  constexpr int KS = D / 16;          // k steps of the scores, d tiles of PV
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int n_vis_s;
  __shared__ float red[WARPS][8];     // the row passes' per-warp sums
  const Plan& p = a.plan;
  const int S = a.S, L = a.L, G = a.G, Hkv = a.Hkv;
  const int Q = G * S, NT = (Q + 7) >> 3, H = Hkv * G;
  const int C = p.C, P = p.P;
  const int rank = (int)cluster_rank();
  const int head = blockIdx.x / C;                 // b * Hkv + hk
  const int b = head / Hkv, hk = head % Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, tig = lane & 3;        // mma fragment coordinates
  const int nch = (L + CH - 1) / CH;
  const int c_begin = rank * p.cpb;
  const int n_own = min(p.cpb, nch - c_begin);
  const int SB = p.stage;                          // bytes a stage

  float* sc = reinterpret_cast<float*>(smem + p.off_sc);     // [Q][P]
  // the share's mask, a bit a slot: [S][cpb * CH / 16] 16-bit words
  uint16_t* msk = reinterpret_cast<uint16_t*>(smem + p.off_mask);
  uint2* qf = reinterpret_cast<uint2*>(smem + p.off_q);      // B fragments
  float* pout = reinterpret_cast<float*>(smem + p.off_out);  // [<=QG][D]
  float* sn = reinterpret_cast<float*>(smem + p.off_sn);     // [Q][S]
  float* xmax = reinterpret_cast<float*>(smem + p.off_stat); // [Q] this block
  float* gmax = xmax + Q;                                    // [Q] cluster
  float* xsum = gmax + Q;
  float* gsum = xsum + Q;
  int* list = reinterpret_cast<int*>(smem + p.off_list);     // visible chunks
  const uint32_t stage0 = smem_addr(smem);
  const uint32_t full0 = smem_addr(smem + p.off_bar);
  const uint32_t empty0 = full0 + 8 * p.stages;
  const size_t head_slot = (size_t)head * L;       // cache row (b, hk)
  const uint8_t* mrow = a.mask + (size_t)b * S * L;
  // a K chunk's copy: its rows (CH * D bytes) and key scales (CH fp32) into
  // a stage; a V chunk's: its rows. The key scales ride the bulk copy where
  // their rows are 16-byte aligned, else they are read from global memory
  // where they are used; the value scales are read from global memory in
  // the softmax
  const bool bulk_scales =
      (L & 3) == 0 && (reinterpret_cast<uintptr_t>(a.ks) & 15) == 0;
  const bool wide_mask =
      (L & 15) == 0 && (reinterpret_cast<uintptr_t>(a.mask) & 15) == 0;
  const int share = p.cpb * CH;

  for (int c = threadIdx.x; c < n_own; c += THREADS) list[c] = 0;
  for (int qi = threadIdx.x; qi < Q; qi += THREADS) xmax[qi] = -FLT_MAX;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // 1. which of this block's chunks does some query of the row see: every
  // thread reads 16 bytes of the S rows at a time (one load where the rows
  // are 16-byte aligned), one round trip, and keeps them as 16 bits
  {
    const int l_begin = c_begin * CH, l_end = min(L, (c_begin + n_own) * CH);
    const int span = (l_end - l_begin + 15) / 16;
#pragma unroll 4
    for (int f = threadIdx.x; f < S * span; f += THREADS) {
      const int i = f / span, o = (f % span) * 16;
      const uint8_t* at = mrow + (size_t)i * L + l_begin + o;
      uint32_t w[4];
      if (wide_mask) {
        const uint4 u = *reinterpret_cast<const uint4*>(at);
        w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          w[t] = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (l_begin + o + 4 * t + k < l_end) w[t] |= (uint32_t)at[4 * t + k] << (8 * k);
        }
      }
      uint32_t bits = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t nz = __vcmpne4(w[t], 0u);      // 0xFF for each set byte
#pragma unroll
        for (int k = 0; k < 4; ++k) bits |= ((nz >> (8 * k + 7)) & 1u) << (4 * t + k);
      }
      msk[(i * share + o) / 16] = (uint16_t)bits;
      if (bits) list[o / CH] = 1;
    }
  }
  __syncthreads();

  // 2. thread 0 compacts the list; the first copies go out
  auto chunk_slot0 = [&](int j) { return (c_begin + list[j]) * CH; };
  auto issue = [&](int it, int nv) {
    const int s = it % p.stages;
    const bool is_v = it >= nv;
    const int j = is_v ? (it - nv) % nv : it;
    const int l0 = chunk_slot0(j);
    const uint32_t cnt = (uint32_t)min(CH, L - l0);
    const uint32_t dst = stage0 + (uint32_t)(s * SB), bar = full0 + 8 * s;
    const bool scales = !is_v && bulk_scales;
    mbar_expect_tx(bar, cnt * D + (scales ? 4 * cnt : 0));
    bulk_load(dst, (is_v ? a.v8 : a.k8) + (head_slot + l0) * D, cnt * D, bar);
    if (scales) bulk_load(dst + CH * D, a.ks + head_slot + l0, 4 * cnt, bar);
  };
  if (threadIdx.x == 0) {
    int n = 0;
    for (int c = 0; c < n_own; ++c)
      if (list[c]) list[n++] = c;
    n_vis_s = n;
  }
  __syncthreads();
  const int nv = n_vis_s;
  const int items = nv * (1 + p.ng);
  // the last warp's lane 0 issues every copy (at D = 96 that warp has no
  // value columns, so the refills cost the value pass nothing)
  const bool issuer = threadIdx.x == THREADS - 32;
  if (issuer)
    for (int it = 0; it < min(items, p.stages); ++it) issue(it, nv);
  // scored positions: visible chunk j holds positions j*CH .. (only the
  // row's last chunk is partial, and it is the last visible one)
  const int R = nv ? (nv - 1) * CH + (int)round_up(min(CH, L - chunk_slot0(nv - 1)), 16) : 0;

  // while the copies fly: q's B fragments, rank 0's new-token scores
  for (int e = threadIdx.x; e < NT * KS * 32; e += THREADS) {
    const int nt = e / (KS * 32), k = (e / 32) % KS, ln = e % 32;
    const int qi = nt * 8 + (ln >> 2), d0 = k * 16 + 4 * (ln & 3);
    uint2 w = make_uint2(0u, 0u);
    if (qi < Q) {
      const int gg = qi / S, i = qi % S;
      const uint2 u = *reinterpret_cast<const uint2*>(
          a.q + (((size_t)b * S + i) * H + hk * G + gg) * D + d0);
      // k 2t, 2t + 1 <- d 4t, 4t + 2; k 2t + 8, 2t + 9 <- d 4t + 1, 4t + 3
      w = make_uint2(__byte_perm(u.x, u.y, 0x5410), __byte_perm(u.x, u.y, 0x7632));
    }
    qf[e] = w;
  }
  if (rank == 0) {      // eight lanes a (query, new token) pair
    const int sub = threadIdx.x & 7;
    const int n_pairs = Q * S, span = (n_pairs + THREADS / 8 - 1) / (THREADS / 8) * (THREADS / 8);
    for (int pr = threadIdx.x >> 3; pr < span; pr += THREADS / 8) {
      float part = 0.f;
      const int qi = pr / S, j = pr % S, gg = qi / S, i = qi % S;
      if (pr < n_pairs) {
        const bf16* qr = a.q + (((size_t)b * S + i) * H + hk * G + gg) * D;
        const bf16* kn = a.k_new + (((size_t)b * S + j) * Hkv + hk) * D;
#pragma unroll
        for (int d = sub; d < D; d += 8)
          part = fmaf(__bfloat162float(qr[d]), __bfloat162float(kn[d]), part);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (sub == 0 && pr < n_pairs) sn[pr] = j <= i ? part * a.scale : -FLT_MAX;
    }
  }
  __syncthreads();

  // 3. scores: warp w takes slots 16w..16w+15 of each visible chunk. A
  // lane keeps its running maxima of queries 8 nt + 2 tig (+ 1), nt < 4, in
  // registers (more queries: shared-memory atomics, exact in any order).
  // The ring's stage and phase step with the items (no division).
  int ring_s = 0;
  uint32_t ring_ph = 0;
  auto ring_next = [&]() {
    if (++ring_s == p.stages) {
      ring_s = 0;
      ring_ph ^= 1u;
    }
  };
  float mrun[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) mrun[nt][0] = mrun[nt][1] = -FLT_MAX;
  int mo[4][2];         // the mask row (token) of this lane's queries
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = nt * 8 + 2 * tig + h;
      mo[nt][h] = (qi < Q ? qi % S : 0) * share;
    }
  for (int j = 0; j < nv; ++j) {
    const int s = ring_s;
    const int l0 = chunk_slot0(j);
    const int cnt = min(CH, L - l0);
    const int sl0 = warp * 16 + g8;              // fragment rows g8, g8 + 8
    float ksc[2];
    if (!bulk_scales) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = l0 + sl0 + 8 * h;
        ksc[h] = l < L ? a.ks[head_slot + l] : 0.f;
      }
    }
    mbar_wait(full0 + 8 * s, ring_ph);
    if (warp * 16 < cnt) {
      const uint8_t* stg = smem + s * SB;
      if (bulk_scales) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ksc[h] = reinterpret_cast<const float*>(stg + CH * D)[sl0 + 8 * h];
      }
      const uint32_t st = stage0 + (uint32_t)(s * SB);
      uint32_t A[KS][4];
      const int mi = lane >> 3;
      const uint32_t row = st + (uint32_t)((warp * 16 + (lane & 7) + (mi & 1) * 8) * D + (mi >> 1) * 16);
      uint32_t r[KS / 2][4];            // every load in flight, then convert
#pragma unroll
      for (int k = 0; k < KS; k += 2) ldsm_x4(r[k / 2], row + k * 16);
#pragma unroll
      for (int k = 0; k < KS; k += 2) {
        i8x4_to_bf16(r[k / 2][0], A[k][0], A[k][2]);
        i8x4_to_bf16(r[k / 2][1], A[k][1], A[k][3]);
        i8x4_to_bf16(r[k / 2][2], A[k + 1][0], A[k + 1][2]);
        i8x4_to_bf16(r[k / 2][3], A[k + 1][1], A[k + 1][3]);
      }
      const int mbase = l0 - c_begin * CH;     // this chunk in the share
      const float ks0 = NORM_FIRST ? ksc[0] * a.scale : ksc[0];
      const float ks1 = NORM_FIRST ? ksc[1] * a.scale : ksc[1];
      const bool in0 = sl0 < cnt, in1 = sl0 + 8 < cnt;   // slots in the row
      // the scores of n8 tile nt; mr: the running maxima (nullptr: atomics)
      auto tile = [&](int nt, float* mr, const int* row_o) {
        float c[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < KS; k += 2) {     // two chains: even, odd k
          const uint2 b0 = qf[(nt * KS + k) * 32 + lane];
          const uint2 b1 = qf[(nt * KS + k + 1) * 32 + lane];
          mma_bf16(c, A[k], b0.x, b0.y);
          mma_bf16(c2, A[k + 1], b1.x, b1.y);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + 2 * tig + (e & 1);
          const int sl = sl0 + 8 * (e >> 1);
          const float dot = c[e] + c2[e];
          const float sv = NORM_FIRST ? dot * (e < 2 ? ks0 : ks1)
                                      : dot * (e < 2 ? ks0 : ks1) * a.scale;
          const int mb = row_o[e & 1] + mbase + sl;
          const bool keep = qi < Q && (e < 2 ? in0 : in1) && ((msk[mb >> 4] >> (mb & 15)) & 1u);
          const float v = keep ? sv : -FLT_MAX;
          if (qi < Q) sc[qi * P + j * CH + sl] = v;
          if (mr) {
            mr[e & 1] = fmaxf(mr[e & 1], v);
          } else if (qi < Q) {
            atomic_max_float(xmax + qi, v);
          }
        }
      };
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (nt < NT) tile(nt, mrun[nt], mo[nt]);
      for (int nt = 4; nt < NT; ++nt) {
        int ro[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qi = nt * 8 + 2 * tig + h;
          ro[h] = (qi < Q ? qi % S : 0) * share;
        }
        tile(nt, nullptr, ro);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (issuer && j + p.stages < items) {
      mbar_wait(empty0 + 8 * s, ring_ph);
      issue(j + p.stages, nv);
    }
    ring_next();
  }
  // the warps' maxima: over the 8 lanes of a query column, then atomics
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = mrun[nt][h];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const int qi = nt * 8 + 2 * tig + h;
      if (g8 == 0 && nt < NT && qi < Q) atomic_max_float(xmax + qi, m);
    }
  __syncthreads();

  // a thread's first PRE value scales (positions threadIdx.x + THREADS k)
  // load now, across the cluster's max, the rest where they are used
  constexpr int PRE = 8;
  auto vs_at = [&](int pos) {
    const int l = chunk_slot0(pos / CH) + pos % CH;
    return l < L ? a.vs[head_slot + l] : 0.f;
  };
  float vpre[PRE];
#pragma unroll
  for (int k = 0; k < PRE; ++k) {
    const int pos = threadIdx.x + THREADS * k;
    vpre[k] = pos < R ? vs_at(pos) : 0.f;
  }

  // 4. the cluster's max per query (rank 0's includes the new tokens)
  if (rank == 0) {
    for (int qi = threadIdx.x; qi < Q; qi += THREADS) {
      float m = xmax[qi];
      for (int j = 0; j < S; ++j) m = fmaxf(m, sn[qi * S + j]);
      xmax[qi] = m;
    }
  }
  cluster_sync();
  for (int qi = threadIdx.x; qi < Q; qi += THREADS) {
    float v[CMAX];
    ld_ranks(v, smem_addr(xmax + qi), C);
    float m = -FLT_MAX;
#pragma unroll
    for (int r = 0; r < CMAX; ++r)
      if (r < C) m = fmaxf(m, v[r]);
    gmax[qi] = m;
  }
  __syncthreads();

  // the softmax over the score rows, in place: p = exp(s - m) and the
  // block's partial denominators; then (K8 after the cluster's denominator)
  // pv = bf16(p * vs) or bf16(p / denom * vs), a bf16 value kept in fp32
  // (the value pass packs two into a bf16 pair). For Q <= 8 every thread
  // takes positions of every row, else a warp takes a row.
  if (Q <= 8) {
    float t[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int pos = threadIdx.x; pos < R; pos += THREADS) {
#pragma unroll
      for (int qi = 0; qi < 8; ++qi) {
        if (qi < Q) {
          const float e = expf(sc[qi * P + pos] - gmax[qi]);
          sc[qi * P + pos] = e;
          t[qi] += e;
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < 8; ++qi) {
      const float v = warp_sum(t[qi]);
      if (lane == 0) red[warp][qi] = v;
    }
    __syncthreads();
    if (threadIdx.x < Q) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += red[w][threadIdx.x];
      xsum[threadIdx.x] = v;
    }
  } else {
    for (int qi = warp; qi < Q; qi += WARPS) {
      const float m = gmax[qi];
      float t = 0.f;
      for (int pos = lane; pos < R; pos += 32) {
        const float e = expf(sc[qi * P + pos] - m);
        sc[qi * P + pos] = e;
        t += e;
      }
      t = warp_sum(t);
      if (lane == 0) xsum[qi] = t;
    }
  }
  __syncthreads();
  if (rank == 0) {      // the new tokens: p_new, and K8's denominator terms
    for (int e = threadIdx.x; e < Q * S; e += THREADS)
      sn[e] = expf(sn[e] - gmax[e / S]);
    __syncthreads();
    if (NORM_FIRST)
      for (int qi = threadIdx.x; qi < Q; qi += THREADS)
        for (int j = 0; j < S; ++j) xsum[qi] += sn[qi * S + j];
  }
  if (NORM_FIRST) {
    cluster_sync();
    for (int qi = threadIdx.x; qi < Q; qi += THREADS) {
      float v[CMAX];
      ld_ranks(v, smem_addr(xsum + qi), C);
      gsum[qi] = sum_ranks(v, C);
    }
    __syncthreads();
    if (rank == 0)      // pn = bf16(p_new / denom)
      for (int e = threadIdx.x; e < Q * S; e += THREADS)
        sn[e] = __bfloat162float(__float2bfloat16_rn(sn[e] / gsum[e / S]));
  }
  auto pv_at = [&](int pos, float vsc) {
    for (int qi = 0; qi < Q; ++qi) {
      const float x = NORM_FIRST ? sc[qi * P + pos] / gsum[qi] : sc[qi * P + pos];
      sc[qi * P + pos] = __bfloat162float(__float2bfloat16_rn(x * vsc));
    }
  };
#pragma unroll
  for (int k = 0; k < PRE; ++k) {
    const int pos = threadIdx.x + THREADS * k;
    if (pos < R) pv_at(pos, vpre[k]);
  }
  for (int pos = threadIdx.x + THREADS * PRE; pos < R; pos += THREADS)
    pv_at(pos, vs_at(pos));
  __syncthreads();

  // 5. PV, QG queries a pass: warp w < KS takes columns 16w..16w+15
  for (int gi = 0; gi < p.ng; ++gi) {
    const int q0 = gi * QG, nq = min(QG, Q - q0), ntg = (nq + 7) >> 3;
    float acc[4][4], acc2[4][4];      // two chains: even, odd k steps
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = acc2[nt][e] = 0.f;
    for (int j = 0; j < nv; ++j) {
      const int it = nv * (1 + gi) + j;
      const int s = ring_s;
      const int l0 = chunk_slot0(j);
      const int cnt = min(CH, L - l0);
      mbar_wait(full0 + 8 * s, ring_ph);
      if (warp < KS) {
        const int tiles = (cnt + 15) >> 4;
        const uint32_t st = stage0 + (uint32_t)(s * SB) + warp * 16;
        // k steps kt, kt + 1 (slots 16 kt .., loaded in r), the second
        // where `two`
        auto kpair = [&](const uint32_t (&r)[4], int kt, bool two) {
          uint32_t A0[4], A1[4];
          // rows of M: d 2g8 (low bytes of each pair), 2g8 + 1 (high)
          i8x4_to_bf16(r[0], A0[0], A0[1]);
          i8x4_to_bf16(r[1], A0[2], A0[3]);
          i8x4_to_bf16(r[2], A1[0], A1[1]);
          i8x4_to_bf16(r[3], A1[2], A1[3]);
          const int pos = j * CH + kt * 16 + 2 * tig;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (nt < ntg) {
              // pv pairs: the bf16 halves of two floats (0 past Q)
              const int qi = q0 + nt * 8 + g8;
              const float* pr = sc + min(qi, Q - 1) * P + pos;
              uint32_t bb[4] = {0u, 0u, 0u, 0u};
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                if (h < 2 || two) {
                  const float2 f = *reinterpret_cast<const float2*>(pr + 8 * h);
                  bb[h] = qi < Q ? __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632) : 0u;
                }
              }
              mma_bf16(acc[nt], A0, bb[0], bb[1]);
              if (two) mma_bf16(acc2[nt], A1, bb[2], bb[3]);
            }
          }
        };
        if (tiles == CH / 16) {       // a full chunk: every load in flight
          uint32_t r[CH / 32][4];
#pragma unroll
          for (int i = 0; i < CH / 32; ++i)
            ldsm_x4_trans(r[i], st + (uint32_t)((i * 32 + lane) * D));
#pragma unroll
          for (int i = 0; i < CH / 32; ++i) kpair(r[i], 2 * i, true);
        } else {
          for (int kt = 0; kt < tiles; kt += 2) {
            uint32_t r[4];
            ldsm_x4_trans(r, st + (uint32_t)((kt * 16 + lane) * D));
            kpair(r, kt, kt + 1 < tiles);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if (issuer && it + p.stages < items) {
        mbar_wait(empty0 + 8 * s, ring_ph);
        issue(it + p.stages, nv);
      }
      ring_next();
    }
    if (warp < KS) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = nt * 8 + 2 * tig + (e & 1);
          if (nt < ntg && ql < nq)
            pout[ql * D + warp * 16 + 2 * g8 + (e >> 1)] = acc[nt][e] + acc2[nt][e];
        }
    }
    cluster_sync();
    // 6. output element e is block (e % C)'s: it adds the C partials in rank
    // order, then the new tokens' terms (rank 0's pn, K4's p_new and the
    // partial denominators)
    for (int e = rank + C * threadIdx.x; e < nq * D; e += C * THREADS) {
      const int qi = q0 + e / D, d = e % D;
      const int gg = qi / S, i = qi % S;
      float v[CMAX];
      ld_ranks(v, smem_addr(pout + e), C);
      float total = sum_ranks(v, C);
      if (NORM_FIRST) {
        for (int j = 0; j < S; ++j)
          total = fmaf(ld_cluster(smem_addr(sn + qi * S + j), 0),
                       __bfloat162float(a.v_new[(((size_t)b * S + j) * Hkv + hk) * D + d]),
                       total);
      } else {
        ld_ranks(v, smem_addr(xsum + qi), C);
        const float p_new = ld_cluster(smem_addr(sn + qi), 0);
        total = (total + p_new * __bfloat162float(a.v_new[((size_t)b * Hkv + hk) * D + d]))
                / (sum_ranks(v, C) + p_new);
      }
      a.out[(((size_t)b * S + i) * H + hk * G + gg) * D + d] = __float2bfloat16_rn(total);
    }
    cluster_sync();
  }
}

template <int D, bool NORM_FIRST>
int launch(const Args& a, int B, cudaStream_t st) {
  auto kern = attention_kernel<D, NORM_FIRST>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.plan.smem);
  if (err != cudaSuccess) return (int)err;
  if (a.plan.C > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * a.Hkv * a.plan.C));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)a.plan.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.plan.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the plan for (G, S, L, D) and the launch; cudaErrorInvalidValue for a D
// the kernel does not take or a plan past the shared memory
template <bool NORM_FIRST>
int run(Args a, int B, int D, cudaStream_t st) {
  if (!make_plan(B * a.Hkv, a.G, a.S, a.L, D, &a.plan))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32, NORM_FIRST>(a, B, st);
    case 64: return launch<64, NORM_FIRST>(a, B, st);
    case 96: return launch<96, NORM_FIRST>(a, B, st);
    case 128: return launch<128, NORM_FIRST>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
