// Flash-attention forward for Hopper (sm_90a): wgmma and TMA, bf16 in,
// fp32 softmax.
//
// Replaces grounded_video_llm_tpu/ops/flash_attention.py:_fwd_kernel (the
// non-causal kernel: CLIP ViT-L and the InternVideo2 trunk in bounded-softmax
// mode) and :_fwd_kernel_causal (LLM prefill), with the same contract as
// _flash_fwd: q [B,Sq,H,D], k/v [B,Sk,Hkv,D] bf16 (GQA: q head h reads kv head
// h / (H/Hkv)), an optional additive fp32 key bias [B,Sk]; returns o
// [B,Sq,H,D] bf16 and the row logsumexp lse [B,H,Sq] fp32. A row with no
// valid key gives o = 0 and lse = +inf, never NaN.
//
// What bounds it on an H100. A head costs 4*S*S*D flops against 8*S*D bytes
// of q, k, v and o, about S/2 flops per byte: near the card's bf16 ridge
// (~295) at S = 577 and well above it at S = 2049 and 3.7k, so the tensor
// cores are the first limit, and wgmma is the only instruction that reaches
// their full rate. The exp per score is the second: the SFUs issue 16 exp2
// per SM per clock against 1,024 dense bf16 FMAs of wgmma, and a score costs
// 2*D FMAs (Q K^T and P V) but one exp2, so at D = 64 the exps take as long
// as the products and at D = 96 about two thirds as long. What this design
// leaves on the table: inside a consumer the Q K^T, the softmax and the P V
// of a tile run one after another, and only the other consumer's work fills
// the gaps; at CLIP's 577 keys a block has five key tiles, too few to fill
// the ring. PERF.md section 6 has the measured times on an H100 beside
// SDPA's and the bound.
//
// Design (PERF.md has its numbers):
//  * One block owns 128 q rows of one (batch, q head) and runs three
//    warpgroups. Warpgroup 2 is the producer: one thread issues TMA loads
//    (cp.async.bulk.tensor) of the block's Q tile once and of 128-key K and
//    V tiles into a ring of three stages, paced by full and empty
//    mbarriers; it gives registers back with setmaxnreg.dec (24).
//    Warpgroups 0 and 1 are the consumers, 64 q rows each, under
//    setmaxnreg.inc (240):
//    S = Q K^T is one wgmma m64n128k16 chain with Q and K from
//    128-byte-swizzled shared memory (K-major), its first k-step writing S
//    (write-only operands, so the last tile's S need not stay live); the
//    online softmax runs on the accumulators in registers; O += P V takes P
//    from registers as the A operand (bf16, rounded where the Pallas kernel
//    casts it) and V as the B operand from shared memory MN-major (wgmma
//    transposes bf16 B itself, so V needs no transpose pass). The
//    accumulators stay fp32 in registers.
//  * The two consumers share each K/V tile, so a tile fetched serves 128
//    queries; the producer keeps up to three tiles in flight ahead of both
//    consumers' math, and while one consumer runs its softmax the other's
//    wgmma keeps the tensor cores busy.
//  * Occupancy is set on purpose: one block per SM. 384 threads at ptxas's
//    168 registers (the most __launch_bounds__(384, 1) leaves; no spills in
//    any instantiation) fill the register file, and shared memory (Q plus
//    three K/V stages: 112 KiB at D = 64, 168 at 88 and 96, 224 at 128)
//    would not take a second block at D >= 88 either. The 168 that
//    ptxas reports is the launch allotment; after setmaxnreg the producer
//    holds 24 and the consumers 240 (128 * 24 + 256 * 240 = 64,512 of
//    65,536). Measured against the same kernel without the pair, in one
//    call, the pair is worth 1-16% (most at the causal shapes; PERF.md);
//    whether the consumers' code uses the larger budget or the gain comes
//    from elsewhere is not measured. A
//    288-thread block with a lone producer warp measured 5-10% slower
//    (ptxas still allots 168 registers), and a consumer loop that overlaps
//    tile i's softmax with tile i-1's P V in the same warpgroup spilled
//    (S, P and O all live) and measured 20-30% slower (PERF.md).
//  * Tensor maps are built on the host for each call from the call's
//    strides, so K1/K2 ([B,S,H,D]) and M2 ([B,H,S,D]) share the code; they
//    are 4-D (D, S, heads, batch), so a tile past S is zero-filled by TMA
//    and never reads the next head.
//  * Masks only where they bite: a key tile wholly inside Sk, wholly below
//    the diagonal and inside the window (for this warpgroup's 64 rows) skips
//    the mask arithmetic; boundary tiles (the ragged Sk tail, the diagonal,
//    the window edge, wherever q_offset puts them) keep it. The bias is read
//    from device memory once per key tile (one key a thread, while the tile's
//    Q K^T runs) into shared memory, where the scores of all rows find it.
//  * Causal q tiles run longest first (the tile index is reversed), so the
//    short tiles fill the tail of the grid.
//  * The softmax runs in the log2 domain, so each score costs one FMA and
//    one exp2; fixed-offset modes keep m fixed and skip the row max and the
//    rescale of the accumulator.
//
// Trouble spots handled on purpose:
//  * Head dims 88 and 96: a 128-byte swizzle holds 64 bf16 in a row, so the
//    head dim is split into 64-column atoms (128-byte swizzle) and, for 88
//    and 96, one 32-column tail atom (64-byte swizzle, its own tensor map
//    and descriptors). The tensor map's inner extent stays D, so TMA
//    zero-fills columns 88-95 for the contraction; P V runs N = 64 + 32 (the
//    tail padded to 96, its last 8 columns zero) and columns past D are
//    never stored.
//  * Ragged Sq and Sk (577, 2049, 3709, 7515): TMA zero-fills rows past the
//    extent; a zero key scores 0, not -inf, so the key bound is still
//    masked. At Sq = 2049 the 17th q tile holds one valid row of 128.
//  * Masked scores are -FLT_MAX and the running max starts at -1e30, so it
//    stays finite and exp2 of a masked score underflows to exactly 0.
//  * An mbarrier parity error hangs the card: each stage's full barriers
//    (K and V apart, so S = Q K^T starts before V lands) complete once per
//    use, the empty barrier once per use after all eight consumer warps
//    retired their wgmma reads of it; the consumers always wait on the Q
//    load, so no copy is in flight when the block exits.
//  * Online mode rescales O by alpha only after the previous P V wgmma
//    retired (wgmma.wait_group 0 at the end of each tile), and the A
//    fragments of P stay live (fenced) until that wait.
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
//
// The tensor maps are encoded with cuTensorMapEncodeTiled, a libcuda
// function, reached through cudaGetDriverEntryPointByVersion: the library
// links only the CUDA runtime, as every other kernel library of the port
// does (no -lcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;             // q rows per block
constexpr int BN = 128;             // keys per K/V tile
constexpr int STAGES = 3;           // K/V ring (224 KiB at D = 128)
constexpr int CONSUMERS = 2;        // consumer warpgroups, 64 q rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER = CONSUMERS * 128;   // the thread that issues TMA
constexpr float NEG_INF = -FLT_MAX;  // masked score (JAX NEG_INF)
constexpr float M_INIT = -1e30f;     // finite start of the running max
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
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

// The head dim as 64-column atoms (128-byte rows, 128-byte swizzle) and at
// most one 32-column tail atom (64-byte rows, 64-byte swizzle).
template <int D>
struct HeadDim {
  static constexpr int FULL = D / 64;
  static constexpr int TAIL = D % 64 == 0 ? 0 : 1;
  static_assert(D % 64 <= 32 && D % 8 == 0, "head dim not tiled");
  static constexpr int DP = 64 * FULL + 32 * TAIL;  // contraction, padded
  static constexpr int KSTEPS = DP / 16;
  // shared memory, bytes; every buffer starts on a 1,024-byte boundary
  static constexpr int Q_ATOM = BM * 128, Q_TAIL = BM * 64;
  static constexpr int KV_ATOM = BN * 128, KV_TAIL = BN * 64;
  static constexpr int Q_BYTES = FULL * Q_ATOM + TAIL * Q_TAIL;
  static constexpr int KV_BYTES = FULL * KV_ATOM + TAIL * KV_TAIL;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BIAS_OFF = BAR_OFF + 128;
  // each consumer's copy of the current key tile's bias
  static constexpr int SMEM = BIAS_OFF + CONSUMERS * BN * 4 + 1024;
};

// The six tensor maps of a call: Q, K and V, each as its 64-column atoms
// and its 32-column tail (the tail maps are unused when D % 64 == 0).
struct Maps {
  CUtensorMap q, q_tail, k, k_tail, v, v_tail;
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

// spin until the barrier's phase of parity `parity` has completed. A wait
// that never ends (a pipeline fault) traps after 2^28 polls, so the launch
// fails instead of hanging the card.
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
// (unused: every operand here spans one swizzle atom along its contiguous
// dimension), stride byte offset between 8-row groups, swizzle layout (1:
// 128-byte, 2: 64-byte). Buffers start on 1,024-byte boundaries, so the
// base offset is 0.
template <int SWIZZLE_BYTES>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t layout = SWIZZLE_BYTES == 128 ? 1 : 2;
  constexpr uint64_t sbo = 8 * SWIZZLE_BYTES;  // 8 rows of one swizzle row
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((sbo >> 4) << 32) | (layout << 62);
}

// barrier of the 128 threads of consumer warpgroup wg (ids 1 and 2; 0 is
// __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// D[64 x 128] += A[64 x 16] B[16 x 128]: A and B from shared memory, both
// K-major and swizzled; fp32 accumulators, 64 a thread
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 128] = A[64 x 16] B[16 x 128]: the first k-step, which overwrites D
// (write-only operands, so D's old values need not stay live)
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64],
                                                    uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (bf16 pairs), B
// from shared memory MN-major (trans-b) and swizzled; 32 accumulators a
// thread
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

// D[64 x 32] += A[64 x 16] B[16 x 32]: A from registers (bf16 pairs), B
// from shared memory MN-major (trans-b) and swizzled; 16 accumulators a
// thread
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

// 2^x in one SFU instruction; results below 2^-126 flush to 0 (a p that
// small is below one ulp of any row sum it joins)
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

// ---- the kernel -------------------------------------------------------------

template <int D, bool CAUSAL, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ bias, bf16* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 float scale, int window, int q_offset, float offset,
                 Strides st) {
  typedef HeadDim<D> HD;
  constexpr int FULL = HD::FULL;
  constexpr int TAIL = HD::TAIL;

  extern __shared__ unsigned char smem_raw[];
  // round the dynamic shared memory up to a 1,024-byte boundary (the
  // swizzle patterns repeat every 1,024 bytes); SMEM holds the slack
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + HD::K_OFF;
  const uint32_t sv = base + HD::V_OFF;
  const uint32_t bars = base + HD::BAR_OFF;
  float* const sbias = reinterpret_cast<float*>(
      smem_raw + (base - raw) + HD::BIAS_OFF);
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  const int n_qt = (Sq + BM - 1) / BM;
  const int qt = CAUSAL ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);

  // the block's key tiles: causal blocks skip the tiles above the diagonal
  // of their last row and below the window of their first
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

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER) {
    // ---- producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == PRODUCER) {
      mbar_expect_tx(q_full, HD::Q_BYTES);
#pragma unroll
      for (int a = 0; a < FULL; ++a)
        tma_load(sq + a * HD::Q_ATOM, &maps.q, q_full, 64 * a, q0, h, b);
      if (TAIL)
        tma_load(sq + FULL * HD::Q_ATOM, &maps.q_tail, q_full, 64 * FULL, q0,
                 h, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        const int k0 = t * BN;
        const uint32_t dk = sk + s * HD::KV_BYTES;
        const uint32_t dv = sv + s * HD::KV_BYTES;
        mbar_expect_tx(k_full(s), HD::KV_BYTES);
#pragma unroll
        for (int a = 0; a < FULL; ++a)
          tma_load(dk + a * HD::KV_ATOM, &maps.k, k_full(s), 64 * a, k0, hk,
                   b);
        if (TAIL)
          tma_load(dk + FULL * HD::KV_ATOM, &maps.k_tail, k_full(s),
                   64 * FULL, k0, hk, b);
        mbar_expect_tx(v_full(s), HD::KV_BYTES);
#pragma unroll
        for (int a = 0; a < FULL; ++a)
          tma_load(dv + a * HD::KV_ATOM, &maps.v, v_full(s), 64 * a, k0, hk,
                   b);
        if (TAIL)
          tma_load(dv + FULL * HD::KV_ATOM, &maps.v_tail, v_full(s),
                   64 * FULL, k0, hk, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int r = lane >> 2;   // accumulator row in the warp's 16
    const int t4 = lane & 3;   // column pair in each 8-column group
    const int wq0 = q0 + 64 * wg;           // this warpgroup's first row
    const int row0 = wq0 + 16 * warp + r;   // rows row0 and row0 + 8
    const int qpos[2] = {q_offset + row0, q_offset + row0 + 8};
    const float* bg = bias ? bias + (int64_t)b * Sk : nullptr;
    float* const wbias = sbias + wg * BN;   // bias of the tile, log2 domain
    // log2-domain scale: p = exp2(s * scale * log2e - m2)
    const float sc = MODE == kNoExp ? scale : scale * LOG2E;

    float acc[FULL][32];
    float acc_t[TAIL ? 16 : 1];
#pragma unroll
    for (int a = 0; a < FULL; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
#pragma unroll
    for (int i = 0; i < (TAIL ? 16 : 1); ++i) acc_t[i] = 0.f;
    float m_run[2] = {MODE == kOnline ? M_INIT : offset * LOG2E,
                      MODE == kOnline ? M_INIT : offset * LOG2E};
    float l_part[2] = {0.f, 0.f};  // this thread's share of the row sums
    float s[BN / 2];               // the score tile: 16 n8 groups x 4

    mbar_wait(q_full, 0);
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int stage = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = t * BN;
      const uint32_t dk = sk + stage * HD::KV_BYTES;
      const uint32_t dv = sv + stage * HD::KV_BYTES;

      // S = Q K^T for 64 rows x 128 keys
      mbar_wait(k_full(stage), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD::KSTEPS; ++kk) {
        if (kk < 4 * FULL) {
          const uint32_t off = (kk % 4) * 32;
          const uint64_t dq =
              desc<128>(sq + (kk / 4) * HD::Q_ATOM + wg * 64 * 128 + off);
          const uint64_t dkk = desc<128>(dk + (kk / 4) * HD::KV_ATOM + off);
          if (kk == 0)
            wgmma_ss_n128_first(s, dq, dkk);
          else
            wgmma_ss_n128(s, dq, dkk);
        } else {
          const uint32_t off = (kk - 4 * FULL) * 32;
          wgmma_ss_n128(
              s, desc<64>(sq + FULL * HD::Q_ATOM + wg * 64 * 64 + off),
              desc<64>(dk + FULL * HD::KV_ATOM + off));
        }
      }
      wgmma_commit();
      if (bg != nullptr) {
        // the tile's bias, one key a thread, into this warpgroup's buffer:
        // the global load overlaps the Q K^T in flight, and the scores read
        // it from shared memory (the first barrier: every thread is done
        // with the previous tile's)
        const int key = k0 + (int)(threadIdx.x % 128);
        const float bk = key < Sk ? __ldg(bg + key) : 0.f;
        warpgroup_sync(wg);
        wbias[threadIdx.x % 128] = MODE == kNoExp ? bk : bk * LOG2E;
        warpgroup_sync(wg);
      }
      wgmma_wait_all();
      fence_regs(s);

      // scale and bias; masks only on boundary tiles (masked scores become
      // NEG_INF, so p = 0 after the exp, or 0 where p = s)
      bool masked = k0 + BN > Sk;
      if (CAUSAL) {
        const int lo = q_offset + wq0, hi = q_offset + wq0 + 63;
        masked = masked || k0 + BN - 1 > lo ||
                 (window > 0 && hi - k0 >= window);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + 8 * j + 2 * t4 + c;
          const float bv = bg != nullptr ? wbias[8 * j + 2 * t4 + c] : 0.f;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float x = fmaf(s[4 * j + 2 * rr + c], sc, bv);
            if (masked) {
              bool keep = key < Sk;
              if (CAUSAL) {
                keep = keep && key <= qpos[rr];
                if (window > 0) keep = keep && qpos[rr] - key < window;
              }
              if (!keep) x = MODE == kNoExp ? 0.f : NEG_INF;
            }
            s[4 * j + 2 * rr + c] = x;
          }
        }
      }

      if (MODE == kOnline) {
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        float alpha[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
          alpha[rr] = exp2_ftz(m_run[rr] - mx[rr]);
          m_run[rr] = mx[rr];
          l_part[rr] *= alpha[rr];
        }
        // the previous tile's P V retired at its wgmma_wait_all
#pragma unroll
        for (int a = 0; a < FULL; ++a)
#pragma unroll
          for (int i2 = 0; i2 < 32; ++i2) acc[a][i2] *= alpha[(i2 >> 1) & 1];
        if constexpr (TAIL != 0) {
#pragma unroll
          for (int i2 = 0; i2 < 16; ++i2) acc_t[i2] *= alpha[(i2 >> 1) & 1];
        }
      }

      // p = exp2(x - m2); masked scores give exactly 0. P as A fragments
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * j + e];
          const float p = MODE == kNoExp ? x : exp2_ftz(x - m_run[e >> 1]);
          s[4 * j + e] = p;
          l_part[e >> 1] +=
              MODE == kSumDot ? __bfloat162float(__float2bfloat16_rn(p)) : p;
        }
      }
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        pa[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
        pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
      }

      // O += P V
      mbar_wait(v_full(stage), parity);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
#pragma unroll
        for (int a = 0; a < FULL; ++a)
          wgmma_rs_n64(acc[a], pa[kc],
                       desc<128>(dv + a * HD::KV_ATOM + kc * 16 * 128));
        if constexpr (TAIL != 0)
          wgmma_rs_n32(acc_t, pa[kc],
                       desc<64>(dv + FULL * HD::KV_ATOM + kc * 16 * 64));
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int a = 0; a < FULL; ++a) fence_regs(acc[a]);
      if constexpr (TAIL != 0) fence_regs(acc_t);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));
    }

    // finish the rows: o = acc / l, lse = (m2 + log2 l) ln 2; dead rows
    // o = 0, lse = +inf (p = s has no dead rows: its sums may be negative)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_part[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * rr;
      const bool dead = MODE != kNoExp && !(l > 0.f);
      const float inv = dead ? 0.f : 1.f / l;
      if (row < Sq) {
        bf16* orow = o + b * st.q_batch + h * st.q_head + row * st.q_row;
#pragma unroll
        for (int a = 0; a < FULL; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * a + 8 * j + 2 * t4;
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack_bf16(acc[a][4 * j + 2 * rr] * inv,
                          acc[a][4 * j + 2 * rr + 1] * inv);
          }
        if (TAIL) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 64 * FULL + 8 * j + 2 * t4;
            if (col < D)
              *reinterpret_cast<uint32_t*>(orow + col) =
                  pack_bf16(acc_t[4 * j + 2 * rr] * inv,
                            acc_t[4 * j + 2 * rr + 1] * inv);
          }
        }
        if (lse != nullptr && t4 == 0) {
          lse[((int64_t)b * H + h) * Sq + row] =
              dead ? __int_as_float(0x7f800000)
                   : (m_run[rr] + log2f(l)) * LN2;
        }
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

// a bf16 tensor (D, S, heads, batch) with the given element strides of S,
// heads and batch, read in boxes of `cols` columns x `rows` rows
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
              int batch, int64_t s_row, int64_t s_head, int64_t s_batch,
              int cols, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
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

template <int D, bool CAUSAL, int MODE>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const float* bias, bf16* o, float* lse, int B, int Sq,
                   int Sk, int H, int Hkv, float scale, int window,
                   int q_offset, float offset, const Strides& st,
                   cudaStream_t stream) {
  Maps maps;
  bool ok = true;
  for (int tail = 0; tail < 2; ++tail) {
    const int cols = tail ? 32 : 64;
    CUtensorMap* mq = tail ? &maps.q_tail : &maps.q;
    CUtensorMap* mk = tail ? &maps.k_tail : &maps.k;
    CUtensorMap* mv = tail ? &maps.v_tail : &maps.v;
    ok = ok && make_map(mq, q, D, Sq, H, B, st.q_row, st.q_head, st.q_batch,
                        cols, BM);
    ok = ok && make_map(mk, k, D, Sk, Hkv, B, st.kv_row, st.kv_head,
                        st.kv_batch, cols, BN);
    ok = ok && make_map(mv, v, D, Sk, Hkv, B, st.kv_row, st.kv_head,
                        st.kv_batch, cols, BN);
  }
  if (!ok) return cudaErrorInvalidValue;
  const int smem = HeadDim<D>::SMEM;
  auto kern = flash_fwd_kernel<D, CAUSAL, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, H, B);
  kern<<<grid, THREADS, smem, stream>>>(maps, bias, o, lse, Sq, Sk, H, Hkv,
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
