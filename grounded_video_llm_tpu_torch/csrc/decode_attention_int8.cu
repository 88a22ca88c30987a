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
// What bounds it on an H100: every cache byte is read at most once per step
// and used for ~2 operations per head in the group, far below the ridge, so
// the cache stream is the limit. Counting every slot: 147.5 MB at B = 6,
// L = 3,840, 32 heads of 96 -> 44 us at 3.35 TB/s. Counting only the slots
// some query sees, as chip_smoke's bound does (the kernel never loads a
// chunk of 128 slots no query sees): 0.0349 ms on its ragged test mask.
//
// Design: int8_attention.cuh, the kernel K8 runs too, with S = 1 and K4's
// order of normalisation (pv = bf16(p * vs) with the cluster's global max,
// the partial denominators added in rank order at the end). A thread-block
// cluster per (b, kv head) splits the slots; each block bulk-copies its
// visible chunks of K and V into shared memory, scores them on tensor cores
// (mma.sync bf16; the int8 bytes become bf16 with two logic ops and a
// packed subtraction a pair), exchanges its row maxima through distributed
// shared memory and sums pv * v on tensor cores; the blocks' partial outputs
// are added in rank order. At B = 6, L = 3,840 a row is a cluster of 2
// blocks (384 blocks, where the one-block design had 192); at B = 1 one of 8
// (256 blocks, where it had 32). The cap on L: the one-block design kept
// G * L fp32 scores in one block (L <= 47,872 / G); a block now keeps 1/16
// of a row's scores and mask bits (L <= 827,392 at G = 1, D = 96; 102,400 at
// G = 8, D = 128; the header states the plan).

#include "int8_attention.cuh"

// q [B,H,D] bf16, k8/v8 [B,Hkv,L,D] int8, ks/vs [B,Hkv,L] fp32, valid [B,L]
// bytes, k_new/v_new [B,Hkv,D] bf16 -> out [B,H,D] bf16. H = Hkv * G,
// G in {1, 2, 4, 8}, D in {32, 64, 96, 128}.
extern "C" int gvllm_decode_attention_int8(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* valid, const void* k_new, const void* v_new,
    void* out, int B, int H, int Hkv, int L, int D, float scale,
    void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv || L < 1 || D < 32 || D % 32 || D > 128)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  if (G != 1 && G != 2 && G != 4 && G != 8) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k8 = static_cast<const int8_t*>(k8);
  a.ks = static_cast<const float*>(ks);
  a.v8 = static_cast<const int8_t*>(v8);
  a.vs = static_cast<const float*>(vs);
  a.mask = static_cast<const uint8_t*>(valid);
  a.k_new = static_cast<const bf16*>(k_new);
  a.v_new = static_cast<const bf16*>(v_new);
  a.out = static_cast<bf16*>(out);
  a.Hkv = Hkv;
  a.G = G;
  a.S = 1;
  a.L = L;
  a.scale = scale;
  return run<false>(a, B, D, static_cast<cudaStream_t>(stream));
}

namespace {

__global__ void convert_kernel(const uint32_t* in, uint32_t* out, int words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= words) return;
  uint32_t lo, hi;
  i8x4_to_bf16(in[i], lo, hi);           // (b0, b2), (b1, b3)
  out[2 * i] = __byte_perm(lo, hi, 0x5410);
  out[2 * i + 1] = __byte_perm(lo, hi, 0x7632);
}

}  // namespace

// The kernels' int8 -> bf16 conversion (i8x4_to_bf16) alone, for a check
// of every byte value on the card: n int8 (a multiple of 4) -> n bf16, in
// order.
extern "C" int gvllm_int8_to_bf16(const void* in, void* out, int n,
                                  void* stream) {
  if (n < 4 || n % 4) return (int)cudaErrorInvalidValue;
  const int words = n / 4;
  convert_kernel<<<(words + 255) / 256, 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), words);
  return (int)cudaGetLastError();
}
