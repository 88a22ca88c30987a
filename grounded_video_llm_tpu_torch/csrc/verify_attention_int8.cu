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
// 3,840 slots a launch reads at most ~148 MB -> 44 us at 3.35 TB/s (every
// slot); chip_smoke's bound counts the slots some query of the row sees
// (0.0354 ms on its ragged test mask), as the kernel loads no chunk of 128
// slots that no query sees.
//
// Design: int8_attention.cuh, with K8's order of normalisation: a thread-
// block cluster per (b, kv head) splits the slots; each block bulk-copies
// its visible chunks of K and V (cp.async.bulk, mbarriers) into shared
// memory, scores all Q = G * S queries at once on tensor cores (mma.sync
// m16n8k16 bf16: 16 slots by one n8 tile of queries, D the reduction, so
// Q = 5 pads to 8, not to 16 or 64), takes the cluster's global max and, in
// rank order, its denominator through distributed shared memory, forms pv
// and sums pv * v on tensor cores (D by queries, slots the reduction); the
// blocks' partial outputs are added in rank order and the new tokens' terms
// after them. At path D's shape a row of 3,840 slots is a cluster of 2
// blocks of 1,920 slots (384 blocks, one wave of three an SM, where the
// one-block design had 192 holding Q * L scores each). The one-block cap
// (Q * L fp32 scores plus q and the value pass's partials within 227 KB:
// L <= 9,985 at Q = 5, D = 96; 2,363 at Q = 20, D = 128) becomes 165,888
// and 38,912 (the header states the plan).

#include "int8_attention.cuh"

// q [B,S,H,D] bf16, k8/v8 [B,Hkv,L,D] int8, ks/vs [B,Hkv,L] fp32, mask
// [B,S,L] bytes, k_new/v_new [B,S,Hkv,D] bf16 -> out [B,S,H,D] bf16.
// H = Hkv * G; D in {32, 64, 96, 128}.
extern "C" int gvllm_verify_attention_int8(
    const void* q, const void* k8, const void* ks, const void* v8,
    const void* vs, const void* mask, const void* k_new, const void* v_new,
    void* out, int B, int S, int H, int Hkv, int L, int D, float scale,
    void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv || L < 1 || D < 32 || D % 32 ||
      D > 128)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k8 = static_cast<const int8_t*>(k8);
  a.ks = static_cast<const float*>(ks);
  a.v8 = static_cast<const int8_t*>(v8);
  a.vs = static_cast<const float*>(vs);
  a.mask = static_cast<const uint8_t*>(mask);
  a.k_new = static_cast<const bf16*>(k_new);
  a.v_new = static_cast<const bf16*>(v_new);
  a.out = static_cast<bf16*>(out);
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.S = S;
  a.L = L;
  a.scale = scale;
  return run<true>(a, B, D, static_cast<cudaStream_t>(stream));
}
