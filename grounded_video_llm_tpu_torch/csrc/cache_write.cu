// In-place per-row slot writes into the int8 KV cache, Hopper (sm_90a).
//
// K5 (gvllm_scatter_write): replaces grounded_video_llm_tpu/ops/
// cache_write.py scatter_write_kv (`_write_kernel`) and scatter_write_scale
// (`_write_scale_kernel`).
// K9 (gvllm_scatter_write_multi): replaces scatter_write_kv_multi and
// scatter_write_scale_multi (`_write_multi_kernel`).
//
// Contract: for up to four buffer pairs j at once (k values, k scales,
// v values, v scales) and S new slots per row,
//   dst_j[l, b, h, idx[b] + s, :] = src_j[l, b, s, h, :]
//   for every l, b, h and s < S,
// dst_j [L,B,Hkv,max_len,E_j bytes], src_j [L,B,S,Hkv,E_j bytes],
// E_j % 4 == 0 (D int8 values, or one fp32 scale). Every other byte of dst_j
// is left as it was; a slot outside [0, max_len) writes nothing. K5 is the
// S = 1 case (src_j [L,B,Hkv,E_j]); both entry points launch the same kernel.
//
// What bounds it: a few MB of 4-byte stores per decode step or verify pass,
// so launch latency, not bandwidth. The Pallas kernels rewrite the 128-lane
// tile (two tiles for S slots) around each slot because a TPU store is
// tile-granular; here each thread moves one 4-byte word straight to its
// place. In this layout the S slots of one (l, b, h) are contiguous, S * E_j
// bytes, so there is no tile straddle to handle. One launch covers all four
// buffers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Buffers {
  uint32_t* dst[4];
  const uint32_t* src[4];
  int words[4];          // 4-byte words per slot (E_j / 4)
};

__global__ void __launch_bounds__(THREADS)
scatter_kernel(Buffers bufs, const int* __restrict__ idx, int rows, int B,
               int Hkv, int S, int max_len) {
  const int j = blockIdx.y;
  const int words = bufs.words[j];
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (words == 0 || t >= (long long)rows * S * words) return;
  // t walks the destination order: row = (l, b, h), then slot s, then word
  const int w = (int)(t % words);
  const long long rs = t / words;
  const int s = (int)(rs % S);
  const int row = (int)(rs / S);
  const int h = row % Hkv;
  const int lb = row / Hkv;                      // l * B + b
  const int slot = idx[lb % B] + s;
  if (slot < 0 || slot >= max_len) return;
  bufs.dst[j][((size_t)row * max_len + slot) * words + w] =
      bufs.src[j][(((size_t)lb * S + s) * Hkv + h) * words + w];
}

int launch(void* const* dst, const void* const* src, const int* elem_bytes,
           int n, const void* idx, int rows, int B, int Hkv, int S,
           int max_len, void* stream) {
  if (n < 1 || n > 4 || rows < 1 || B < 1 || Hkv < 1 || S < 1 || S > 128 ||
      max_len < 1 || rows % (B * Hkv))
    return (int)cudaErrorInvalidValue;
  Buffers bufs;
  int most = 0;
  for (int j = 0; j < 4; ++j) {
    const bool used = j < n;
    if (used && (elem_bytes[j] < 4 || elem_bytes[j] % 4))
      return (int)cudaErrorInvalidValue;
    bufs.dst[j] = used ? static_cast<uint32_t*>(dst[j]) : nullptr;
    bufs.src[j] = used ? static_cast<const uint32_t*>(src[j]) : nullptr;
    bufs.words[j] = used ? elem_bytes[j] / 4 : 0;
    if (bufs.words[j] > most) most = bufs.words[j];
  }
  const long long total = (long long)rows * S * most;
  dim3 grid((unsigned)((total + THREADS - 1) / THREADS), n);
  scatter_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      bufs, static_cast<const int*>(idx), rows, B, Hkv, S, max_len);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. dst/src: arrays of n (<= 4) pointers; elem_bytes[j] = E_j;
// rows = L*B*Hkv; one slot per row at idx[b].
extern "C" int gvllm_scatter_write(void* const* dst, const void* const* src,
                                   const int* elem_bytes, int n,
                                   const void* idx, int rows, int B, int Hkv,
                                   int max_len, void* stream) {
  return launch(dst, src, elem_bytes, n, idx, rows, B, Hkv, 1, max_len,
                stream);
}

// K9. The same with S (1..128) contiguous slots per row from base idx[b].
extern "C" int gvllm_scatter_write_multi(void* const* dst,
                                         const void* const* src,
                                         const int* elem_bytes, int n,
                                         const void* idx, int rows, int B,
                                         int Hkv, int S, int max_len,
                                         void* stream) {
  return launch(dst, src, elem_bytes, n, idx, rows, B, Hkv, S, max_len,
                stream);
}
