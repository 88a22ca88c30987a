// int8 x int8 GEMMs of the port's microbenchmarks, Hopper (sm_90a).
//
// M3  gvllm_int8_gemm          replaces scripts/microbench_int8_gemm.py:128
//     (`_pl_kernel` :120): x8 [M,K] int8 (quantized beforehand) @ w [K,N]
//     int8 -> exact int32 -> float(acc) * s[n] -> bf16.
// M3d gvllm_int8_gemm_dynamic  replaces the same script's :165
//     (`_pl_dyn_kernel` :154): x [M,K] bf16 quantized per row inside the
//     GEMM program, xs = max(absmax / 127, 1e-8), x8 = clamp(rint(x / xs),
//     +-127); y = float(acc) * xs * s[n] -> bf16 (dynamic_int8_matmul's
//     function and rounding order).
// M1  gvllm_i8i8_gemv          replaces scripts/microbench_decode.py:85
//     (`i8i8_matmul`, `_i8i8_kernel` :64): the decode-shaped x [M<=16,K]
//     bf16, quantized per row as above, then int8 x int8 on the tensor cores
//     with the rows padded to one 16-row m tile; y = float(acc) * xs * s[n]
//     -> bf16. This is the function the script's docstring names; the TPU
//     prototype multiplies its output by a zero placeholder and returns
//     zeros, a fault of the reference the port does not reproduce.
//
// What bounds them on an H100. M3/M3d at the encoder shapes (M 8192, K
// 1408, N 6144 and the transpose) do 2MKN = 142 GOP against ~70 MB of
// bytes: ~2,000 operations per byte, far above the int8 ridge (~590), so
// the int8 tensor-core rate (1,979 TOP/s) is the limit. M1 reads each
// weight byte once for at most 16 rows: ~32 operations per byte, so the
// weight stream at 3.35 TB/s is the limit.
//
// Design. M3/M3d: K10's tile scheme (csrc/fused_block.cu) as a GEMM of its
// own: a 128 x 128 output tile per block of 8 warps (warp tile 64 x 32),
// K in steps of 64 through shared memory with the next step's global loads
// in registers, mma.sync.m16n8k32 s8 -> s32; the [K,N] weight (N
// contiguous) is transposed 4 x 4 bytes at a time with __byte_perm on its
// way to shared memory, where the mma B operand wants 4 consecutive k of a
// column per register. M3d asks the question the TPU script asked of a
// fused quantization (there "a wash") again on this card. Where K <= 1,792
// (the fc1 shape, K = 1,408) a block owns 64 rows: a prologue reads each
// bf16 row once into registers, takes its absmax and writes the int8 row
// into shared memory (64 x 1,424 bytes at K = 1,408), and the block then
// streams the weight tiles of a run of column tiles past those resident
// rows. No int8 copy of x exists in device memory, and x is read and
// rounded once per run of column tiles: once per block, where the grid is
// one wave of 64-row blocks, each over N / 2 columns at M = 8,192. Where K
// is larger (the fc2 transpose, K = 6,144: 64 rows would take 384 KB) the
// rows stream with the K steps of the 128 x 128 tile: the prologue takes
// the row absmax, each K step rounds the bf16 x tile on its way into
// shared memory, so every column block reads and rounds its rows again.
// M1: three launches. A warp per row quantizes x into a 16-row int8
// scratch (rows >= M are zero) and its scales; the GEMV splits K over
// blocks (grid.y) so the skinny N of the down projection still fills the
// card, each block of 4 warps owns 128 columns and its K chunk of the int8
// rows in shared memory, each warp 32 columns: per k32 step it loads its
// 32 x 32 weight bytes as 4 x 4 blocks (a full 32-byte sector per 8
// lanes), transposes them through a small per-warp shared buffer into B
// fragments, and runs four m16n8k32 products; the int32 partial sums go to
// scratch, and a last kernel adds the splits in order (exact in int32) and
// rescales. All three are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ---- M3 / M3d ----
constexpr int THREADS = 256;
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;          // shared row stride in bytes (80)
constexpr int LDW = LDS / 4;          // the same in 4-byte words (20)

// ---- M3d with its rows resident in shared memory (K <= RES_KMAX)
constexpr int RBM = 64;                 // rows per block
constexpr int RES_VEC = 7;              // 8-bf16 vectors per lane and row
constexpr int RES_KMAX = RES_VEC * 8 * 32;   // 1,792

// ---- M1 ----
constexpr int GV_ROWS = 16;           // one m16 tile
constexpr int GV_WARPS = 4;
constexpr int GV_BN = 32 * GV_WARPS;  // columns per block
constexpr int GV_LDB = 9;             // per-warp B stage: [32 cols][8 + 1]

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rint(v / s) clamped to +-127 as an int8 byte (IEEE division, as the plain
// version divides)
__device__ __forceinline__ uint32_t q8(float v, float s) {
  return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(rintf(v / s), -127.f),
                                                127.f);
}

// 8 bf16 (one uint4) -> 8 int8 (one uint2)
__device__ __forceinline__ uint2 quant8(uint4 raw, float s) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint32_t w[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 a = __bfloat1622float2(h[2 * i]);
    const float2 b = __bfloat1622float2(h[2 * i + 1]);
    w[i] = q8(a.x, s) | (q8(a.y, s) << 8) | (q8(b.x, s) << 16) |
           (q8(b.y, s) << 24);
  }
  return make_uint2(w[0], w[1]);
}

// r[j] holds 4 column bytes of row j; t[c] gets the 4 row bytes of column c
__device__ __forceinline__ void transpose4x4(const uint32_t* r, uint32_t* t) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// ---------------------------------------------------------------------------
// M3 / M3d: the tiled GEMM
// ---------------------------------------------------------------------------

struct GemmArgs {
  const void* x;        // int8 [M,K] (M3) or bf16 [M,K] (M3d)
  const int8_t* w;      // [K,N]
  const float* ws;      // [N]
  bf16* out;            // [M,N]
  int M, N, K;
};

template <bool DYN>
__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmArgs p) {
  __shared__ __align__(16) int8_t As[BM * LDS];      // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * LDS];      // [n][k] (transposed)
  __shared__ float xs_s[BM];                         // M3d row scales

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int warp_m = warp >> 2, warp_n = warp & 3;   // 2 x 4 warps
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = p.M, N = p.N, K = p.K;
  const int8_t* x8 = static_cast<const int8_t*>(p.x);
  const bf16* xb = static_cast<const bf16*>(p.x);

  if (DYN) {
    // prologue: each warp takes 16 rows, 8 bf16 per lane and step
    for (int r = warp * (BM / 8); r < (warp + 1) * (BM / 8); ++r) {
      const int m = m0 + r;
      float amax = 0.f;
      if (m < M) {
        const uint4* row = reinterpret_cast<const uint4*>(xb + (size_t)m * K);
        for (int c = lane; c < K / 8; c += 32) {
          const uint4 raw = row[c];
          const __nv_bfloat162* h =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
          }
        }
      }
      amax = warp_max(amax);
      if (lane == 0) xs_s[r] = m < M ? fmaxf(amax / 127.f, 1e-8f) : 1.f;
    }
    __syncthreads();
  }

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  // global -> registers. A: M3 two 16-byte int8 chunks, M3d four 16-byte
  // bf16 chunks (8 values each); B: two 4 x 4 byte blocks (lanes of a warp:
  // 8 column words x 4 row groups, 32-byte segments)
  constexpr int A_CHUNKS = DYN ? 4 : 2;
  uint4 a_reg[A_CHUNKS];
  uint32_t b_reg[2][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int row = DYN ? c >> 3 : c >> 2;
      const int col = DYN ? (c & 7) * 8 : (c & 3) * 16;
      const int m = m0 + row;
      if (m >= M) {
        a_reg[i] = make_uint4(0, 0, 0, 0);
      } else if (DYN) {
        a_reg[i] = *reinterpret_cast<const uint4*>(xb + (size_t)m * K + k0 +
                                                   col);
      } else {
        a_reg[i] = *reinterpret_cast<const uint4*>(x8 + (size_t)m * K + k0 +
                                                   col);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = warp * 64 + i * 32 + lane;           // 512 blocks
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
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      if (DYN) {
        const int row = c >> 3, col = (c & 7) * 8;
        *reinterpret_cast<uint2*>(As + row * LDS + col) =
            quant8(a_reg[i], xs_s[row]);
      } else {
        const int row = c >> 2, col = (c & 3) * 16;
        *reinterpret_cast<uint4*>(As + row * LDS + col) = a_reg[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = warp * 64 + i * 32 + lane;
      const int kg = (blk >> 7) * 4 + ((lane >> 3) & 3);
      const int ng = ((blk >> 5) & 3) * 8 + (lane & 7);
      uint32_t t[4];
      transpose4x4(b_reg[i], t);
      uint32_t* dst = reinterpret_cast<uint32_t*>(Bs) + (ng * 4) * LDW + kg;
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[c * LDW] = t[c];
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

  // epilogue: acc[mt][nt][2h + e] is row warp_m*64 + mt*16 + g + 8h,
  // column warp_n*32 + nt*8 + 2*tig + e of the block's tile
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rloc = warp_m * 64 + mt * 16 + g + 8 * h;
      const int m = m0 + rloc;
      if (m >= M) continue;
      const float xs = DYN ? xs_s[rloc] : 1.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + warp_n * 32 + nt * 8 + 2 * tig;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = (float)acc[mt][nt][2 * h + e];
          y[e] = DYN ? v * xs * p.ws[n + e] : v * p.ws[n + e];
        }
        __nv_bfloat162 o;
        o.x = __float2bfloat16_rn(y[0]);
        o.y = __float2bfloat16_rn(y[1]);
        *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)m * N + n) = o;
      }
    }
  }
}

// M3d, K <= RES_KMAX: 64 rows quantized once into shared memory, then the
// weight tiles of column tiles [t0, t1) stream past them. 8 warps as 2 x 4,
// warp tile 32 x 32. Dynamic shared memory: As [64][K + 16] int8, Bs
// [128][LDS] int8, the 64 row scales.
__global__ void __launch_bounds__(THREADS)
gemm_dyn_resident_kernel(GemmArgs p, int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char res_smem[];
  const int M = p.M, N = p.N, K = p.K;
  const int lda = K + 16, ldaw = lda / 4;
  int8_t* As = reinterpret_cast<int8_t*>(res_smem);
  int8_t* Bs = As + RBM * lda;
  float* xs_s = reinterpret_cast<float*>(Bs + BN * LDS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int m0 = blockIdx.y * RBM;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(N / BN, t0 + tiles_per_block);
  const bf16* xb = static_cast<const bf16*>(p.x);

  // prologue: each warp takes 8 rows; a lane holds up to RES_VEC vectors of
  // a row, so the row is read once for both its absmax and its rounding
  for (int r = warp * (RBM / 8); r < (warp + 1) * (RBM / 8); ++r) {
    const int m = m0 + r;
    const uint4* row = reinterpret_cast<const uint4*>(xb + (size_t)m * K);
    uint4 v[RES_VEC];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < RES_VEC; ++i) {
      const int c = lane + 32 * i;
      v[i] = (m < M && c < K / 8) ? row[c] : make_uint4(0, 0, 0, 0);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
    amax = warp_max(amax);
    const float xs = m < M ? fmaxf(amax / 127.f, 1e-8f) : 1.f;
#pragma unroll
    for (int i = 0; i < RES_VEC; ++i) {
      const int c = lane + 32 * i;
      if (c < K / 8)
        *reinterpret_cast<uint2*>(As + r * lda + c * 8) = quant8(v[i], xs);
    }
    if (lane == 0) xs_s[r] = xs;
  }

  int acc[2][4][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
  };
  zero_acc();

  // the weight tile of step `it` (column tile t0 + it / ksteps, K step
  // it % ksteps): the same 4 x 4 byte blocks as gemm_kernel's B loads
  const int ksteps = K / BK;
  const int total = (t1 - t0) * ksteps;
  uint32_t b_reg[2][4];
  auto load = [&](int it) {
    const int n0 = (t0 + it / ksteps) * BN, k0 = (it % ksteps) * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = warp * 64 + i * 32 + lane;
      const int kg = (blk >> 7) * 4 + ((lane >> 3) & 3);
      const int ng = ((blk >> 5) & 3) * 8 + (lane & 7);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          p.w + (size_t)(k0 + kg * 4) * N + n0 + ng * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) b_reg[i][r] = __ldg(src + (size_t)r * (N / 4));
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = warp * 64 + i * 32 + lane;
      const int kg = (blk >> 7) * 4 + ((lane >> 3) & 3);
      const int ng = ((blk >> 5) & 3) * 8 + (lane & 7);
      uint32_t t[4];
      transpose4x4(b_reg[i], t);
      uint32_t* dst = reinterpret_cast<uint32_t*>(Bs) + (ng * 4) * LDW + kg;
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[c * LDW] = t[c];
    }
  };

  const uint32_t* As32 = reinterpret_cast<const uint32_t*>(As);
  const uint32_t* Bs32 = reinterpret_cast<const uint32_t*>(Bs);
  if (total > 0) load(0);
  for (int it = 0; it < total; ++it) {
    store();
    __syncthreads();          // the first one also orders the prologue
    if (it + 1 < total) load(it + 1);
    const int kw0 = (it % ksteps) * (BK / 4);
#pragma unroll
    for (int kk = 0; kk < BK / 4; kk += 8) {        // two k32 steps (words)
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = warp_m * 32 + mt * 16 + g;
        a[mt][0] = As32[r0 * ldaw + kw0 + kk + tig];
        a[mt][1] = As32[(r0 + 8) * ldaw + kw0 + kk + tig];
        a[mt][2] = As32[r0 * ldaw + kw0 + kk + 4 + tig];
        a[mt][3] = As32[(r0 + 8) * ldaw + kw0 + kk + 4 + tig];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = warp_n * 32 + nt * 8 + g;
        b[nt][0] = Bs32[n * LDW + kk + tig];
        b[nt][1] = Bs32[n * LDW + kk + 4 + tig];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
    if (it % ksteps != ksteps - 1) continue;

    // the column tile is done: acc[mt][nt][2h + e] is row warp_m*32 +
    // mt*16 + g + 8h, column warp_n*32 + nt*8 + 2*tig + e of the tile
    const int n0 = (t0 + it / ksteps) * BN;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rloc = warp_m * 32 + mt * 16 + g + 8 * h;
        const int m = m0 + rloc;
        if (m >= M) continue;
        const float xs = xs_s[rloc];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + warp_n * 32 + nt * 8 + 2 * tig;
          __nv_bfloat162 o;
          o.x = __float2bfloat16_rn((float)acc[mt][nt][2 * h] * xs * p.ws[n]);
          o.y = __float2bfloat16_rn((float)acc[mt][nt][2 * h + 1] * xs *
                                    p.ws[n + 1]);
          *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)m * N + n) = o;
        }
      }
    }
    zero_acc();
  }
}

template <bool DYN>
int launch_gemm(const void* x, const void* w, const void* ws, void* out,
                int M, int K, int N, cudaStream_t st) {
  if (M < 1 || K < BK || K % BK || N < BN || N % BN ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  GemmArgs a{x, static_cast<const int8_t*>(w), static_cast<const float*>(ws),
             static_cast<bf16*>(out), M, N, K};
  if (DYN && K <= RES_KMAX) {
    // one wave of 64-row blocks: as many runs of column tiles per row block
    // as the card holds blocks beside the row blocks, at least one
    const int smem = RBM * (K + 16) + BN * LDS + RBM * 4;
    int err = (int)cudaFuncSetAttribute(
        gemm_dyn_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = (int)cudaGetDevice(&dev)) ||
        (err = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, gemm_dyn_resident_kernel, THREADS, smem)))
      return err;
    const int row_blocks = (M + RBM - 1) / RBM, tiles = N / BN;
    if (row_blocks > 65535) return (int)cudaErrorInvalidValue;
    const int runs = min(tiles, max(1, sms * max(per_sm, 1) / row_blocks));
    const int per_run = (tiles + runs - 1) / runs;
    dim3 grid((tiles + per_run - 1) / per_run, row_blocks);
    gemm_dyn_resident_kernel<<<grid, THREADS, smem, st>>>(a, per_run);
    return (int)cudaGetLastError();
  }
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<DYN><<<grid, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// M1: quantize rows, split-K tensor-core GEMV, sum and rescale
// ---------------------------------------------------------------------------

// one warp per row of the 16-row tile; rows >= M are written as zeros
__global__ void __launch_bounds__(THREADS)
gv_quant_kernel(const bf16* __restrict__ x, int8_t* __restrict__ x8,
                float* __restrict__ xs, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (m >= GV_ROWS) return;
  int8_t* out = x8 + (size_t)m * K;
  if (m >= M) {
    for (int k = lane; k < K; k += 32) out[k] = 0;
    if (lane == 0) xs[m] = 1.f;
    return;
  }
  const bf16* xr = x + (size_t)m * K;
  float amax = 0.f;
  for (int k = lane; k < K; k += 32)
    amax = fmaxf(amax, fabsf(__bfloat162float(xr[k])));
  amax = warp_max(amax);
  const float s = fmaxf(amax / 127.f, 1e-8f);
  for (int k = lane; k < K; k += 32)
    out[k] = (int8_t)(int)fminf(
        fmaxf(rintf(__bfloat162float(xr[k]) / s), -127.f), 127.f);
  if (lane == 0) xs[m] = s;
}

// grid (ceil(N / 128), nsplit); block 4 warps; split y takes k in
// [y * kc, min(K, (y + 1) * kc)); part [nsplit, 16, N] int32
__global__ void __launch_bounds__(GV_WARPS * 32)
gv_gemv_kernel(const int8_t* __restrict__ x8, const int8_t* __restrict__ w,
               int* __restrict__ part, int M, int K, int N, int kc) {
  extern __shared__ __align__(16) unsigned char gv_smem[];
  const int lda = kc + 16;                             // bytes; kc % 128 == 0
  int8_t* sA = reinterpret_cast<int8_t*>(gv_smem);     // [16][lda]
  uint32_t* sB = reinterpret_cast<uint32_t*>(gv_smem + GV_ROWS * lda) +
                 (threadIdx.x >> 5) * (32 * GV_LDB);   // this warp's stage

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int kb = blockIdx.y * kc;
  const int klen = min(kc, K - kb);
  const int nw = blockIdx.x * GV_BN + warp * 32;       // this warp's columns

  // the 16 int8 rows of this K chunk into shared memory
  for (int c = threadIdx.x; c < GV_ROWS * (klen / 16); c += GV_WARPS * 32) {
    const int r = c / (klen / 16), col = (c % (klen / 16)) * 16;
    *reinterpret_cast<uint4*>(sA + r * lda + col) =
        *reinterpret_cast<const uint4*>(x8 + (size_t)r * K + kb + col);
  }
  __syncthreads();

  // lane L loads the 4 x 4 blocks (column group L & 7, row groups
  // (L >> 3) and (L >> 3) + 4) of each k32 x 32 step
  const int cg = lane & 7;
  const bool col_live = nw + cg * 4 < N;
  uint32_t cur[2][4], nxt[2][4];
  auto load = [&](uint32_t (&dst)[2][4], int k) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kg = (lane >> 3) + 4 * i;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          w + (size_t)(kb + k + kg * 4) * N + nw + cg * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dst[i][r] = col_live ? __ldg(src + (size_t)r * (N / 4)) : 0u;
    }
  };

  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  const uint32_t* sA32 = reinterpret_cast<const uint32_t*>(sA);
  const int ldaw = lda / 4;
  load(cur, 0);
  for (int k = 0; k < klen; k += 32) {
    if (k + 32 < klen) load(nxt, k + 32);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kg = (lane >> 3) + 4 * i;
      uint32_t t[4];
      transpose4x4(cur[i], t);
#pragma unroll
      for (int c = 0; c < 4; ++c) sB[(cg * 4 + c) * GV_LDB + kg] = t[c];
    }
    __syncwarp();
    uint32_t a[4];
    const int kw = k / 4;
    a[0] = sA32[g * ldaw + kw + tig];
    a[1] = sA32[(g + 8) * ldaw + kw + tig];
    a[2] = sA32[g * ldaw + kw + 4 + tig];
    a[3] = sA32[(g + 8) * ldaw + kw + 4 + tig];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[2];
      b[0] = sB[(8 * j + g) * GV_LDB + tig];
      b[1] = sB[(8 * j + g) * GV_LDB + 4 + tig];
      mma_s8(acc[j], a, b);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) cur[i][r] = nxt[i][r];
  }

  // acc[j][2h + e]: row g + 8h, column nw + 8j + 2 tig + e
  int* out = part + (size_t)blockIdx.y * GV_ROWS * N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = nw + 8 * j + 2 * tig;
    if (n >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = g + 8 * h;
      if (m < M)
        *reinterpret_cast<int2*>(out + (size_t)m * N + n) =
            make_int2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gv_finish_kernel(const int* __restrict__ part, const float* __restrict__ xs,
                 const float* __restrict__ ws, bf16* __restrict__ y, int M,
                 int N, int nsplit) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= M * N) return;
  const int m = i / N, n = i % N;
  int acc = 0;
  for (int s = 0; s < nsplit; ++s) acc += part[((size_t)s * GV_ROWS + m) * N + n];
  y[i] = __float2bfloat16_rn((float)acc * xs[m] * ws[n]);
}

}  // namespace

// M3: x8 [M,K] int8, w [K,N] int8, s [N] fp32 -> y [M,N] bf16.
// K % 64 == 0, N % 128 == 0.
extern "C" int gvllm_int8_gemm(const void* x8, const void* w, const void* s,
                               void* y, int M, int K, int N, void* stream) {
  return launch_gemm<false>(x8, w, s, y, M, K, N,
                            static_cast<cudaStream_t>(stream));
}

// M3d: x [M,K] bf16 quantized per row in the kernel, w, s -> y [M,N] bf16.
extern "C" int gvllm_int8_gemm_dynamic(const void* x, const void* w,
                                       const void* s, void* y, int M, int K,
                                       int N, void* stream) {
  return launch_gemm<true>(x, w, s, y, M, K, N,
                           static_cast<cudaStream_t>(stream));
}

// M1: x [M<=16,K] bf16, w [K,N] int8, s [N] fp32 -> y [M,N] bf16. Scratch
// from the caller: x8 [16,K] int8, xs [16] fp32, part [ceil(K/kc),16,N]
// int32. K % 32 == 0, N % 16 == 0, kc % 128 == 0.
extern "C" int gvllm_i8i8_gemv(const void* x, const void* w, const void* s,
                               void* y, void* x8, void* xs, void* part, int M,
                               int K, int N, int kc, void* stream) {
  if (M < 1 || M > GV_ROWS || K < 32 || K % 32 || N < 16 || N % 16 ||
      kc < 128 || kc % 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nsplit = (K + kc - 1) / kc;
  gv_quant_kernel<<<GV_ROWS / (THREADS / 32), THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(x8),
      static_cast<float*>(xs), M, K);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int smem = GV_ROWS * (kc + 16) + GV_WARPS * 32 * GV_LDB * 4;
  err = (int)cudaFuncSetAttribute(
      gv_gemv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  dim3 grid((N + GV_BN - 1) / GV_BN, nsplit);
  gv_gemv_kernel<<<grid, GV_WARPS * 32, smem, st>>>(
      static_cast<const int8_t*>(x8), static_cast<const int8_t*>(w),
      static_cast<int*>(part), M, K, N, kc);
  err = (int)cudaGetLastError();
  if (err) return err;
  gv_finish_kernel<<<(M * N + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      static_cast<const int*>(part), static_cast<const float*>(xs),
      static_cast<const float*>(s), static_cast<bf16*>(y), M, N, nsplit);
  return (int)cudaGetLastError();
}
