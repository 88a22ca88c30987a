// In-place per-row slot writes into the int8 KV cache, Hopper (sm_90a).
//
// K5: replaces grounded_video_llm_tpu/ops/cache_write.py scatter_write_kv
// (`_write_kernel`) and scatter_write_scale (`_write_scale_kernel`).
//
// Contract: for up to four buffer pairs j at once (k values, k scales,
// v values, v scales),
//   dst_j[l, b, h, idx[b], :] = src_j[l, b, h, :]   for every l, b, h,
// dst_j [L,B,Hkv,max_len,E_j bytes], src_j [L,B,Hkv,E_j bytes], E_j % 4 == 0
// (D int8 values, or one fp32 scale). Every other byte of dst_j is left as
// it was; a slot outside [0, max_len) writes nothing.
//
// What bounds it: a few MB of scattered 4-byte stores per decode step, so
// launch latency, not bandwidth. The Pallas kernels rewrite the 128-lane
// tile around each slot because a TPU store is tile-granular; here each
// thread moves one 4-byte word straight to its place, and one launch covers
// all four buffers.

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
               int Hkv, int max_len) {
  const int j = blockIdx.y;
  const int words = bufs.words[j];
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (words == 0 || t >= (long long)rows * words) return;
  const int row = (int)(t / words), w = (int)(t % words);   // row = (l, b, h)
  const int b = (row / Hkv) % B;
  const int slot = idx[b];
  if (slot < 0 || slot >= max_len) return;
  bufs.dst[j][((size_t)row * max_len + slot) * words + w] =
      bufs.src[j][(size_t)row * words + w];
}

}  // namespace

// dst/src: arrays of n (<= 4) pointers; elem_bytes[j] = E_j; rows = L*B*Hkv.
extern "C" int gvllm_scatter_write(void* const* dst, const void* const* src,
                                   const int* elem_bytes, int n,
                                   const void* idx, int rows, int B, int Hkv,
                                   int max_len, void* stream) {
  if (n < 1 || n > 4 || rows < 1 || B < 1 || Hkv < 1 || max_len < 1)
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
  const long long total = (long long)rows * most;
  dim3 grid((unsigned)((total + THREADS - 1) / THREADS), n);
  scatter_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      bufs, static_cast<const int*>(idx), rows, B, Hkv, max_len);
  return (int)cudaGetLastError();
}
