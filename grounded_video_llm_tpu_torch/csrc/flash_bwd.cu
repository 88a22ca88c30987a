// Flash-attention backward for Hopper (sm_90a): wgmma and TMA, bf16 in and
// out, fp32 math.
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
// What bounds it on an H100. The backward needs five products over the
// visible (q, key) pairs (10 * D flops per pair and head) against reading q,
// k, v, do, lse, delta once and writing dq, dk, dv once: at the training
// shape ([1, 7515, 32, 96], causal) that is 8.7e11 flops against ~0.37 GB,
// about 2,300 flops per byte, far above the bf16 ridge (~295): the tensor
// cores bound it (0.88 ms at 989 TFLOP/s), and wgmma is the only instruction
// that reaches their full rate.
//
// The schedule: two kernels, the JAX one, 7 products where 5 suffice (Q K^T
// and dO V^T run in both), deterministic and free of atomics. Two launches
// on the same inputs give bit-identical dq, dk and dv. The fused
// alternative (FlashAttention-3's backward, arXiv 2407.08608: one kernel,
// 5 products, dq summed across the key-tile blocks) needs an fp32 dq
// buffer, a conversion pass and, to stay deterministic, semaphores that
// make the key-tile blocks add their dq partials in a fixed order. It was
// not built, so the two schedules are not compared by measurement yet;
// the fused kernel is the next K7 item (ROADMAP.md). The two-kernel
// schedule was chosen because it is deterministic by construction and
// each kernel is the flash forward's structure (csrc/flash_fwd.cu) with
// one more product or two; PERF.md has its times beside the bound.
//
// Design (one block per SM for each kernel; PERF.md has the numbers):
//  * Loads are TMA (cp.async.bulk.tensor) with 4-D tensor maps (D, S,
//    heads, batch), so a tile past S is zero-filled and never reads the
//    next head, paced by full and empty mbarriers; the consumers are two
//    warpgroups of 64 rows each on wgmma with fp32 accumulators in
//    registers.
//  * dq kernel: 384 threads; warpgroup 2 is the producer (one thread issues
//    the loads; setmaxnreg.dec 24 / .inc 240 as in flash_fwd.cu). ptxas
//    compiles a 12-warp block within 168 registers a thread (3 warps on
//    each of the SM's four 16K-register partitions), which this kernel
//    needs no more than.
//  * dk/dv kernel: 256 threads, the two consumer warpgroups alone: it holds
//    dK and dV (2 x 48 fp32 at D = 96) beside S^T and dP^T, 187-208
//    registers, which a 12-warp (or 9-warp) block would spill. Thread 0
//    issues the loads: it refills a stage once both warpgroups have
//    released it (mbarrier.test_wait, no waiting), and waits only when the
//    tile it needs next is not issued yet.
//  * dq kernel: a block owns 128 q rows of one (batch, q head); its Q and dO
//    tiles are loaded once, and 64-key K and V tiles stream through a ring
//    of three stages. Per tile and consumer: S = Q K^T and dP = dO V^T
//    (wgmma m64n64k16, both operands K-major from 128-byte-swizzled shared
//    memory), committed as two groups so P's exp2 runs while dP is in
//    flight; dS in registers becomes the register A operand of dQ += dS K,
//    with K as the MN-major B operand (wgmma transposes bf16 B itself, as
//    for V in the forward's P V). Causal blocks skip the key tiles above
//    their diagonal and below their window, and run longest first.
//  * dk/dv kernel: a block owns 128 keys of one (batch, kv head); its K and
//    V tiles are loaded once, and 64-row Q and dO tiles (32 rows at D =
//    128, for registers) of every q head of the GQA group stream through
//    the ring. Per tile and consumer: S^T = K Q^T and dP^T = V dO^T (64
//    keys x 64 rows; P^T's exp2 runs while dP^T is in flight), then dS^T,
//    then dV += P^T dO and dK += dS^T Q in one group (P^T and dS^T from
//    registers, dO and Q as MN-major B operands). The one Q tile
//    in shared memory serves as the K-major B of K Q^T and the MN-major B
//    of dS^T Q; dO likewise. lse and delta of the tile's 64 rows enter
//    through a per-consumer buffer in shared memory (one row a thread,
//    loaded while the tile's first products run). The causal / window
//    range of q tiles is taken in 64-bit arithmetic.
//  * Masks only where they bite: a tile wholly inside Sk, below the
//    diagonal and inside the window (for this warpgroup's 64 rows or keys)
//    skips the mask arithmetic. The scores run in the log2 domain: a score
//    costs one FMA and one exp2 (ex2.approx.ftz).
//
// Trouble spots handled on purpose:
//  * Dead rows (lse = +inf: no valid key in the forward) and rows past Sq
//    (lse read as +inf, delta as 0): the replay computes exp2(x - inf) = 0
//    for any finite or -FLT_MAX score, so they contribute exactly 0 and
//    their dq is exactly 0; nothing computes inf - inf or inf * 0.
//  * Ragged Sq and Sk: TMA zero-fills rows past the extent (garbage could
//    be NaN, and 0 * NaN = NaN); keys past Sk are masked and never stored.
//  * Head dims 88 and 96: 64-column atoms (128-byte swizzle) plus one
//    32-column tail atom (64-byte swizzle, its own tensor maps); the maps'
//    inner extent is D, so TMA zero-fills columns 88-95 of the contraction;
//    columns past D are never stored.
//  * An mbarrier parity error hangs the card: a wait that never ends traps
//    after 2^28 polls, so the launch fails instead. Every load the
//    producer issues is waited on by the consumers before they exit.
//
// Measured and not kept (PERF.md): Q / dO (dq) and K / V (dk/dv) held as
// register A fragments for S and dP (RS wgmma, reading only the streamed
// tile from shared memory) was 2% faster at the training shape, and at
// D = 64 ptxas (CUDA 12.9) gave the loop-invariant fragment registers to
// the dS fragments, which corrupted every tile after the first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

// The PTX wrappers and tensor-map helpers repeat flash_fwd.cu's: each source
// is built (and hashed for the build cache, ops/cuda_build.py) on its own.
typedef __nv_bfloat16 bf16;

constexpr int BIG = 128;            // rows of a block's resident tiles
constexpr int SMALL = 64;           // rows of the dq kernel's key tiles
constexpr int STAGES = 3;           // streamed tiles in flight
constexpr int CONSUMERS = 2;        // consumer warpgroups, 64 rows each
constexpr int PRODUCER = CONSUMERS * 128;   // the thread that issues TMA
// dq kernel: a producer warpgroup (12 warps: ptxas's budget is 168
// registers a thread, 3 warps on each of the SM's four 16K-register
// partitions); dk/dv kernel: the two consumer warpgroups alone (8 warps: 255
// registers), one of whose threads issues the loads
constexpr int THREADS_DQ = (CONSUMERS + 1) * 128;
constexpr int THREADS_DKV = CONSUMERS * 128;
constexpr float NEG_INF = -FLT_MAX;  // masked score (JAX NEG_INF)
constexpr float LOG2E = 1.4426950408889634f;

// The head dim as 64-column atoms (128-byte rows, 128-byte swizzle) and at
// most one 32-column tail atom (64-byte rows, 64-byte swizzle); a tile of
// ROWS rows of bf16 in that layout.
template <int D>
struct HeadDim {
  static constexpr int FULL = D / 64;
  static constexpr int TAIL = D % 64 == 0 ? 0 : 1;
  static_assert(D % 64 <= 32 && D % 8 == 0, "head dim not tiled");
  static constexpr int KSTEPS = (64 * FULL + 32 * TAIL) / 16;
  template <int ROWS>
  struct Tile {
    static constexpr int ATOM = ROWS * 128, TAIL_ATOM = ROWS * 64;
    static constexpr int BYTES = FULL * ATOM + TAIL * TAIL_ATOM;
  };
  typedef Tile<BIG> Big;
  // the dk/dv kernel's q tile: 64 rows, 32 at D = 128 (registers)
  static constexpr int QT = D > 96 ? 32 : 64;
  // shared memory with streamed tiles of RING rows: two resident tiles,
  // then STAGES pairs of streamed tiles; every buffer starts on a 1,024-byte
  // boundary
  template <int RING>
  struct Smem {
    static constexpr int RING_OFF = 2 * Big::BYTES;
    static constexpr int BAR_OFF = RING_OFF + STAGES * 2 * Tile<RING>::BYTES;
    // res_full, full[STAGES], empty[STAGES]
    static constexpr int BUF_OFF = BAR_OFF + 128;
    // per consumer: 64 floats of the tile's bias (dq) or lse and delta
    static constexpr int SMEM = BUF_OFF + CONSUMERS * 2 * SMALL * 4 + 1024;
  };
};

// The tensor maps of a call: each tensor as 64-column atoms and a 32-column
// tail (unused when D % 64 == 0); q and do in boxes of `q rows`, k and v in
// boxes of `kv rows` (128 and 64 in the dq kernel, 64 and 128 in the dk/dv
// kernel).
struct Maps {
  CUtensorMap q, q_tail, dO, dO_tail, k, k_tail, v, v_tail;
};

// ---- PTX wrappers ---------------------------------------------------------

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

// whether the barrier's phase of parity `parity` has completed (no wait)
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
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

// box of a 4-D tensor map (D, S, heads, batch) at column c, row s into
// shared memory; completion counts on the barrier's transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(s), "r"(h),
      "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading byte offset 16
// (unused: every operand spans one swizzle atom along its contiguous
// dimension), stride byte offset between 8-row groups, swizzle layout (1:
// 128-byte, 2: 64-byte); buffers start on 1,024-byte boundaries
template <int SWIZZLE_BYTES>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t layout = SWIZZLE_BYTES == 128 ? 1 : 2;
  constexpr uint64_t sbo = 8 * SWIZZLE_BYTES;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((sbo >> 4) << 32) | (layout << 62);
}

// barrier of the 128 threads of consumer warpgroup wg (ids 1 and 2)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
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

// ties registers to this point of the instruction stream: the compiler may
// neither read an accumulator before the wgmma.wait_group that precedes
// this, nor reuse an A fragment's registers before it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B from shared memory, both
// K-major and swizzled; 32 fp32 accumulators a thread. FIRST overwrites D
// (write-only operands, so D's old values need not stay live).
template <bool FIRST>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  if (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
          "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
          "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(da), "l"(db), "r"(0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32]: the same with 16 accumulators
template <bool FIRST>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  if (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
          "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
        : "l"(da), "l"(db), "r"(0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (bf16 pairs), B
// from shared memory MN-major (trans-b) and swizzled; 32 accumulators
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32]: the same for a 32-column tail atom
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x in one SFU instruction; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- shared pieces of the two kernels --------------------------------------

// A[64 rows of a resident 128-row tile, from row 64 * wg] times B^T, B a
// streamed tile of N rows, over the head dim: 64 x N into d (one chain)
template <int D, int N>
__device__ __forceinline__ void rows_times_rows(float (&d)[N / 2], uint32_t a,
                                                int wg, uint32_t b) {
  typedef HeadDim<D> HD;
  typedef typename HD::template Tile<N> T;
#pragma unroll
  for (int kk = 0; kk < HD::KSTEPS; ++kk) {
    uint64_t da, db;
    if (kk < 4 * HD::FULL) {
      const uint32_t off = (kk % 4) * 32;
      da = desc<128>(a + (kk / 4) * HD::Big::ATOM + wg * 64 * 128 + off);
      db = desc<128>(b + (kk / 4) * T::ATOM + off);
    } else {
      const uint32_t off = (kk - 4 * HD::FULL) * 32;
      da = desc<64>(a + HD::FULL * HD::Big::ATOM + wg * 64 * 64 + off);
      db = desc<64>(b + HD::FULL * T::ATOM + off);
    }
    if constexpr (N == 64) {
      if (kk == 0)
        wgmma_ss_n64<true>(d, da, db);
      else
        wgmma_ss_n64<false>(d, da, db);
    } else {
      if (kk == 0)
        wgmma_ss_n32<true>(d, da, db);
      else
        wgmma_ss_n32<false>(d, da, db);
    }
  }
}

// acc[64 x D] += P[64 x N] (A fragments) M[N x D], M a streamed tile of N
// rows read MN-major (its rows are the contraction)
template <int D, int N>
__device__ __forceinline__ void frags_times_rows(
    float (&acc)[HeadDim<D>::FULL][32], float (&acc_t)[HeadDim<D>::TAIL ? 16 : 1],
    const uint32_t (&pa)[N / 16][4], uint32_t m) {
  typedef HeadDim<D> HD;
  typedef typename HD::template Tile<N> T;
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
#pragma unroll
    for (int a = 0; a < HD::FULL; ++a)
      wgmma_rs_n64(acc[a], pa[kc],
                   desc<128>(m + a * T::ATOM + kc * 16 * 128));
    if constexpr (HD::TAIL != 0)
      wgmma_rs_n32(acc_t, pa[kc],
                   desc<64>(m + HD::FULL * T::ATOM + kc * 16 * 64));
  }
}

// the 64 x N accumulator tile x (fp32) as bf16 A fragments
template <int N>
__device__ __forceinline__ void to_frags(const float (&x)[N / 2],
                                         uint32_t (&f)[N / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    f[kc][0] = pack_bf16(x[8 * kc + 0], x[8 * kc + 1]);
    f[kc][1] = pack_bf16(x[8 * kc + 2], x[8 * kc + 3]);
    f[kc][2] = pack_bf16(x[8 * kc + 4], x[8 * kc + 5]);
    f[kc][3] = pack_bf16(x[8 * kc + 6], x[8 * kc + 7]);
  }
}

// the producer's loads of a tile of `rows` rows (all atoms) onto `bar`
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          const CUtensorMap* m_tail,
                                          uint32_t bar, int s, int h, int b) {
  typedef HeadDim<D> HD;
  typedef typename HD::template Tile<ROWS> T;
#pragma unroll
  for (int a = 0; a < HD::FULL; ++a)
    tma_load(dst + a * T::ATOM, m, bar, 64 * a, s, h, b);
  if (HD::TAIL)
    tma_load(dst + HD::FULL * T::ATOM, m_tail, bar, 64 * HD::FULL, s, h, b);
}

// rows rr of this thread's accumulators (rows r and r + 8 of its warp's 16)
// written as bf16 to out (row stride `stride` elements), columns < D
template <int D>
__device__ __forceinline__ void store_rows(
    const float (&acc)[HeadDim<D>::FULL][32],
    const float (&acc_t)[HeadDim<D>::TAIL ? 16 : 1], bf16* out, int rr,
    int t4) {
  typedef HeadDim<D> HD;
#pragma unroll
  for (int a = 0; a < HD::FULL; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 64 * a + 8 * j + 2 * t4) =
          pack_bf16(acc[a][4 * j + 2 * rr], acc[a][4 * j + 2 * rr + 1]);
  if constexpr (HD::TAIL != 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 64 * HD::FULL + 8 * j + 2 * t4;
      if (col < D)
        *reinterpret_cast<uint32_t*>(out + col) =
            pack_bf16(acc_t[4 * j + 2 * rr], acc_t[4 * j + 2 * rr + 1]);
    }
  }
}

__device__ __forceinline__ bool visible(int64_t qpos, int64_t key,
                                        int window) {
  return key <= qpos && (window <= 0 || qpos - key < window);
}

struct Params {
  const float* bias;   // [B, Sk] or null
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  bf16* out0;          // dq, or dk
  bf16* out1;          // dv
  int Sq, Sk, H, Hkv;
  float scale;
  int window, q_offset;
};

// ---- dq kernel ---------------------------------------------------------------

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS_DQ, 1)
flash_bwd_dq_kernel(const __grid_constant__ Maps maps, const Params p) {
  typedef HeadDim<D> HD;
  typedef typename HD::template Smem<SMALL> SM;
  typedef typename HD::template Tile<SMALL> KV;
  constexpr int FULL = HD::FULL;
  constexpr int TAIL = HD::TAIL;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;                        // Q, 128 rows
  const uint32_t sdo = sq + HD::Big::BYTES;        // dO, 128 rows
  const uint32_t ring = base + SM::RING_OFF;       // K, V per stage
  const uint32_t bars = base + SM::BAR_OFF;
  float* const sbuf =
      reinterpret_cast<float*>(smem_raw + (base - raw) + SM::BUF_OFF);
  const uint32_t res_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto sk = [&](int s) { return ring + s * 2 * KV::BYTES; };
  auto sv = [&](int s) { return sk(s) + KV::BYTES; };

  const int Sq = p.Sq, Sk = p.Sk;
  const int n_qt = (Sq + BIG - 1) / BIG;
  const int qt = CAUSAL ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BIG;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);

  // the key tiles any row of the block can see
  int t_begin = 0;
  int t_end = (Sk + SMALL - 1) / SMALL;
  if (CAUSAL) {
    const int64_t hi = min((int64_t)p.q_offset + q0 + BIG, (int64_t)Sk);
    t_end = hi <= 0 ? 0 : (int)((hi + SMALL - 1) / SMALL);
    if (p.window > 0) {
      const int64_t lo = (int64_t)p.q_offset + q0 - p.window + 1;
      if (lo > 0) t_begin = (int)min(lo / SMALL, (int64_t)t_end);
    }
  }

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
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
      mbar_expect_tx(res_full, 2 * HD::Big::BYTES);
      load_tile<D, BIG>(sq, &maps.q, &maps.q_tail, res_full, q0, h, b);
      load_tile<D, BIG>(sdo, &maps.dO, &maps.dO_tail, res_full, q0, h, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * KV::BYTES);
        load_tile<D, SMALL>(sk(s), &maps.k, &maps.k_tail, full(s),
                            t * SMALL, hk, b);
        load_tile<D, SMALL>(sv(s), &maps.v, &maps.v_tail, full(s),
                            t * SMALL, hk, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int r = lane >> 2;   // accumulator row in the warp's 16
    const int t4 = lane & 3;   // column pair in each 8-column group
    const int wq0 = q0 + 64 * wg;
    const int row0 = wq0 + 16 * warp + r;   // rows row0 and row0 + 8
    const int64_t qpos[2] = {(int64_t)p.q_offset + row0,
                             (int64_t)p.q_offset + row0 + 8};
    const float* bg = p.bias ? p.bias + (int64_t)b * Sk : nullptr;
    float* const wbias = sbuf + wg * 2 * SMALL;   // the tile's bias, log2
    const float sc = p.scale * LOG2E;
    float lse2[2], dlt[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + 8 * rr;
      const int64_t idx = ((int64_t)b * p.H + h) * Sq + row;
      lse2[rr] = row < Sq ? p.lse[idx] * LOG2E : __int_as_float(0x7f800000);
      dlt[rr] = row < Sq ? p.delta[idx] : 0.f;
    }

    float acc[FULL][32];
    float acc_t[TAIL ? 16 : 1];
#pragma unroll
    for (int a = 0; a < FULL; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
#pragma unroll
    for (int i = 0; i < (TAIL ? 16 : 1); ++i) acc_t[i] = 0.f;

    mbar_wait(res_full, 0);
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int stage = i % STAGES;
      const int k0 = t * SMALL;
      mbar_wait(full(stage), (i / STAGES) & 1);

      // S = Q K^T and dP = dO V^T, 64 rows x 64 keys, two groups
      float s[32], dp[32];
      wgmma_fence();
      rows_times_rows<D, SMALL>(s, sq, wg, sk(stage));
      wgmma_commit();
      rows_times_rows<D, SMALL>(dp, sdo, wg, sv(stage));
      wgmma_commit();
      if (bg != nullptr) {
        // the tile's bias, one key a thread, into this warpgroup's buffer
        // (the first barrier: every thread is done with the previous one)
        const int kl = threadIdx.x % 128;
        const float bk =
            (kl < SMALL && k0 + kl < Sk) ? __ldg(bg + k0 + kl) : 0.f;
        warpgroup_sync(wg);
        if (kl < SMALL) wbias[kl] = bk * LOG2E;
        warpgroup_sync(wg);
      }
      wgmma_wait<1>();
      fence_regs(s);

      bool masked = k0 + SMALL > Sk;
      if (CAUSAL) {
        const int64_t lo = (int64_t)p.q_offset + wq0, hi = lo + 63;
        masked = masked || k0 + SMALL - 1 > lo ||
                 (p.window > 0 && hi - k0 >= p.window);
      }
      // P replayed from lse: exp2(s * scale * log2e + bias * log2e - lse2)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * j + 2 * t4 + (e & 1);
          const int rr = e >> 1;
          float x = fmaf(s[4 * j + e], sc, bg != nullptr ? wbias[kl] : 0.f);
          if (masked) {
            bool keep = k0 + kl < Sk;
            if (CAUSAL) keep = keep && visible(qpos[rr], k0 + kl, p.window);
            if (!keep) x = NEG_INF;
          }
          s[4 * j + e] = exp2_ftz(x - lse2[rr]);
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P (dP - delta) scale, as bf16 A fragments
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dp[e] = s[e] * (dp[e] - dlt[(e >> 1) & 1]) * p.scale;
      uint32_t dsa[SMALL / 16][4];
      to_frags<SMALL>(dp, dsa);

      // dQ += dS K
      wgmma_fence();
      frags_times_rows<D, SMALL>(acc, acc_t, dsa, sk(stage));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < FULL; ++a) fence_regs(acc[a]);
      if constexpr (TAIL != 0) fence_regs(acc_t);
      fence_regs(dsa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));
    }

    const int64_t stride = (int64_t)p.H * D;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + 8 * rr;
      if (row < Sq)
        store_rows<D>(acc, acc_t,
                      p.out0 + ((int64_t)b * Sq + row) * stride +
                          (int64_t)h * D,
                      rr, t4);
    }
  }
}

// ---- dk/dv kernel ------------------------------------------------------------

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS_DKV, 1)
flash_bwd_dkv_kernel(const __grid_constant__ Maps maps, const Params p) {
  typedef HeadDim<D> HD;
  constexpr int QT = HD::QT;                 // rows of a q tile
  typedef typename HD::template Smem<QT> SM;
  typedef typename HD::template Tile<QT> QTile;
  constexpr int FULL = HD::FULL;
  constexpr int TAIL = HD::TAIL;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base;                        // K, 128 keys
  const uint32_t sv = sk + HD::Big::BYTES;         // V, 128 keys
  const uint32_t ring = base + SM::RING_OFF;       // Q, dO per stage
  const uint32_t bars = base + SM::BAR_OFF;
  float* const sbuf =
      reinterpret_cast<float*>(smem_raw + (base - raw) + SM::BUF_OFF);
  const uint32_t res_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto sq = [&](int s) { return ring + s * 2 * QTile::BYTES; };
  auto sdo = [&](int s) { return sq(s) + QTile::BYTES; };

  const int Sq = p.Sq, Sk = p.Sk;
  const int k0 = blockIdx.x * BIG;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.Hkv;

  // the q tiles whose rows can see a key of this block: row r sees key k iff
  // k <= r + q_offset and r + q_offset - k < window
  const int nq = (Sq + QT - 1) / QT;
  int jq_start = 0, jq_end = nq;
  if (CAUSAL) {
    const int64_t first = max((int64_t)k0 - p.q_offset, (int64_t)0);
    jq_start = (int)min(first / QT, (int64_t)nq);
    if (p.window > 0) {
      const int64_t last =
          (int64_t)k0 + BIG - 1 + p.window - 1 - p.q_offset;
      jq_end = last < 0 ? 0 : (int)min(last / QT + 1, (int64_t)nq);
    }
    if (jq_end < jq_start) jq_end = jq_start;
  }
  const int per_head = jq_end - jq_start;
  const int n_tiles = G * per_head;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues the loads: tile t of the loop goes to stage t % STAGES
  // once the consumers have released tile t - STAGES
  auto issue = [&](int t) {
    const int s = t % STAGES;
    const int h = hk * G + t / per_head;
    const int q0 = (jq_start + t % per_head) * QT;
    mbar_expect_tx(full(s), 2 * QTile::BYTES);
    load_tile<D, QT>(sq(s), &maps.q, &maps.q_tail, full(s), q0, h, b);
    load_tile<D, QT>(sdo(s), &maps.dO, &maps.dO_tail, full(s), q0, h, b);
  };
  int issued = 0;   // (thread 0) tiles whose loads are issued
  if (threadIdx.x == 0) {
    mbar_expect_tx(res_full, 2 * HD::Big::BYTES);
    load_tile<D, BIG>(sk, &maps.k, &maps.k_tail, res_full, k0, hk, b);
    load_tile<D, BIG>(sv, &maps.v, &maps.v_tail, res_full, k0, hk, b);
    for (; issued < min(STAGES, n_tiles); ++issued) issue(issued);
  }
  {
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = threadIdx.x % 32;
    const int r = lane >> 2;
    const int t4 = lane & 3;
    const int wk0 = k0 + 64 * wg;             // this warpgroup's first key
    const int key0 = wk0 + 16 * warp + r;     // keys key0 and key0 + 8
    // the tile's lse * log2e and delta, one row a thread
    float* const wl = sbuf + wg * 2 * SMALL;
    float* const wd = wl + QT;
    const float sc = p.scale * LOG2E;
    float kb[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = key0 + 8 * rr;
      kb[rr] = (p.bias != nullptr && key < Sk)
                   ? p.bias[(int64_t)b * Sk + key] * LOG2E
                   : 0.f;
    }

    float acc_dk[FULL][32], acc_dv[FULL][32];
    float acc_dk_t[TAIL ? 16 : 1], acc_dv_t[TAIL ? 16 : 1];
#pragma unroll
    for (int a = 0; a < FULL; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_dk[a][i] = acc_dv[a][i] = 0.f;
#pragma unroll
    for (int i = 0; i < (TAIL ? 16 : 1); ++i) acc_dk_t[i] = acc_dv_t[i] = 0.f;

    mbar_wait(res_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % STAGES;
      const int h = hk * G + i / per_head;
      const int q0 = (jq_start + i % per_head) * QT;
      if (threadIdx.x == 0) {
        // refill the stages both consumers have released, without waiting;
        // wait only when tile i itself is not issued yet
        while (issued < n_tiles && issued < i + STAGES) {
          const int old = issued - STAGES;   // the tile the stage held
          const uint32_t bar = empty(old % STAGES);
          const uint32_t parity = (old / STAGES) & 1;
          if (issued == i)
            mbar_wait(bar, parity);
          else if (!mbar_test(bar, parity))
            break;
          issue(issued++);
        }
      }
      mbar_wait(full(stage), (i / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T, 64 keys x QT rows, two groups
      float s[QT / 2], dp[QT / 2];
      wgmma_fence();
      rows_times_rows<D, QT>(s, sk, wg, sq(stage));
      wgmma_commit();
      rows_times_rows<D, QT>(dp, sv, wg, sdo(stage));
      wgmma_commit();
      {
        // lse and delta of the tile's rows (rows past Sq: +inf and 0)
        const int row = q0 + (tid % QT);
        const int64_t idx = ((int64_t)b * p.H + h) * Sq + row;
        float v = 0.f;
        if (tid < QT)
          v = row < Sq ? __ldg(p.lse + idx) * LOG2E
                       : __int_as_float(0x7f800000);
        else if (tid < 2 * QT)
          v = row < Sq ? __ldg(p.delta + idx) : 0.f;
        warpgroup_sync(wg);
        if (tid < 2 * QT) wl[tid] = v;   // wd = wl + QT
        warpgroup_sync(wg);
      }
      wgmma_wait<1>();
      fence_regs(s);

      bool masked = wk0 + 64 > Sk;
      if (CAUSAL) {
        // rows [q0, q0 + QT) at positions lo.., keys wk0..wk0 + 63
        const int64_t lo = (int64_t)p.q_offset + q0;
        masked = masked || wk0 + 63 > lo ||
                 (p.window > 0 && lo + QT - 1 - wk0 >= p.window);
      }
      // P^T replayed from lse: element (key row, q column), while dP^T runs
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = 8 * j + 2 * t4 + (e & 1);   // q row in the tile
          const int rr = e >> 1;
          float x = fmaf(s[4 * j + e], sc, kb[rr]);
          if (masked) {
            const int key = key0 + 8 * rr;
            bool keep = key < Sk;
            if (CAUSAL)
              keep = keep &&
                     visible((int64_t)p.q_offset + q0 + cl, key, p.window);
            if (!keep) x = NEG_INF;
          }
          s[4 * j + e] = exp2_ftz(x - wl[cl]);
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS^T = P^T (dP^T - delta) scale; then both as bf16 A fragments
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = 8 * j + 2 * t4 + (e & 1);
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - wd[cl]) * p.scale;
        }
      uint32_t pa[QT / 16][4], dsa[QT / 16][4];
      to_frags<QT>(s, pa);
      to_frags<QT>(dp, dsa);
      // dV += P^T dO and dK += dS^T Q, one group
      wgmma_fence();
      frags_times_rows<D, QT>(acc_dv, acc_dv_t, pa, sdo(stage));
      frags_times_rows<D, QT>(acc_dk, acc_dk_t, dsa, sq(stage));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < FULL; ++a) {
        fence_regs(acc_dk[a]);
        fence_regs(acc_dv[a]);
      }
      if constexpr (TAIL != 0) {
        fence_regs(acc_dk_t);
        fence_regs(acc_dv_t);
      }
      fence_regs(pa);
      fence_regs(dsa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));
    }

    const int64_t stride = (int64_t)p.Hkv * D;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = key0 + 8 * rr;
      if (key < Sk) {
        const int64_t off = ((int64_t)b * Sk + key) * stride + (int64_t)hk * D;
        store_rows<D>(acc_dk, acc_dk_t, p.out0 + off, rr, t4);
        store_rows<D>(acc_dv, acc_dv_t, p.out1 + off, rr, t4);
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once
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

// a dense bf16 tensor [batch, S, heads, D] as a 4-D map (D, S, heads,
// batch), read in boxes of `cols` columns x `rows` rows
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
              int batch, int cols, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)heads * D * 2,
                                 (cuuint64_t)D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the maps of one kernel: q and do in boxes of q_rows rows, k and v in
// boxes of kv_rows rows
bool make_maps(Maps* m, const void* q, const void* dout, const void* k,
               const void* v, int B, int Sq, int Sk, int H, int Hkv, int D,
               int q_rows, int kv_rows) {
  bool ok = true;
  for (int tail = 0; tail < 2; ++tail) {
    const int cols = tail ? 32 : 64;
    ok = ok && make_map(tail ? &m->q_tail : &m->q, q, D, Sq, H, B, cols,
                        q_rows);
    ok = ok && make_map(tail ? &m->dO_tail : &m->dO, dout, D, Sq, H, B, cols,
                        q_rows);
    ok = ok && make_map(tail ? &m->k_tail : &m->k, k, D, Sk, Hkv, B, cols,
                        kv_rows);
    ok = ok && make_map(tail ? &m->v_tail : &m->v, v, D, Sk, Hkv, B, cols,
                        kv_rows);
  }
  return ok;
}

template <int D, bool CAUSAL>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const float* bias, const float* lse, const float* delta,
                   const bf16* dout, bf16* dq, bf16* dk, bf16* dv, int B,
                   int Sq, int Sk, int H, int Hkv, float scale, int window,
                   int q_offset, cudaStream_t stream) {
  typedef HeadDim<D> HD;
  Maps mdq, mdkv;
  if (!make_maps(&mdq, q, dout, k, v, B, Sq, Sk, H, Hkv, D, BIG, SMALL) ||
      !make_maps(&mdkv, q, dout, k, v, B, Sq, Sk, H, Hkv, D, HD::QT, BIG))
    return cudaErrorInvalidValue;
  const int smem_dq = HD::template Smem<SMALL>::SMEM;
  const int smem_dkv = HD::template Smem<HD::QT>::SMEM;
  auto kdq = flash_bwd_dq_kernel<D, CAUSAL>;
  auto kkv = flash_bwd_dkv_kernel<D, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return err;
  Params pq{bias, lse, delta, dq, nullptr, Sq, Sk, H, Hkv, scale, window,
            q_offset};
  kdq<<<dim3((Sq + BIG - 1) / BIG, H, B), THREADS_DQ, smem_dq, stream>>>(mdq,
                                                                         pq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Params pkv{bias, lse, delta, dk, dv, Sq, Sk, H, Hkv, scale, window,
             q_offset};
  kkv<<<dim3((Sk + BIG - 1) / BIG, Hkv, B), THREADS_DKV, smem_dkv, stream>>>(
      mdkv, pkv);
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
