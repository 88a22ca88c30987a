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
// What bounds it: a few MB per decode step or verify pass (path D: 12.3 MB
// read and written, a 3.7 us bound on an H100), so bandwidth once enough
// bytes are in flight, and launch latency below that. The Pallas kernels
// rewrite the 128-lane tile (two tiles for S slots) around each slot
// because a TPU store is tile-granular; here a slot's bytes go straight to
// their place. In this layout the S slots of one (l, b, h) are contiguous,
// S * E_j bytes, so there is no tile straddle to handle.
//
// Design. One launch covers all four buffers: the 1-D grid is cut into one
// run of blocks per buffer, each run sized by that buffer's own width, so
// the 4-byte scale buffers launch no idle blocks beside the 96-byte value
// rows. A block owns R_j kv heads of one (l, b) pair: (l, b) and the head
// group come from the block index (one 32-bit division per block, none per
// word), idx[b] is read once per block, and a thread walks (head, slot,
// chunk) items of one (l, b) with 32-bit arithmetic. A chunk is 16 bytes
// where E_j % 16 == 0 and both bases are 16-byte aligned (the value rows of
// every head dim used here), else 4 bytes (the scales). R_j is chosen so a
// block's items fill its 256 threads once (S = 128 value rows: one head,
// three chunks a thread).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Buffers {
  unsigned char* dst[4];
  const unsigned char* src[4];
  int bytes[4];      // E_j: bytes per slot
  int chunk[4];      // 16 or 4 bytes per copy
  int heads[4];      // R_j: kv heads per block
  int groups[4];     // ceil(Hkv / R_j): blocks per (l, b)
  int start[5];      // first block of buffer j; start[n] = grid size
};

template <typename V>
__device__ __forceinline__ void copy_items(unsigned char* dst,
                                           const unsigned char* src, int E,
                                           int heads, int h0, int Hkv, int S,
                                           int slot0, int max_len, size_t lb) {
  const int per_slot = E / (int)sizeof(V);
  const int per_head = S * per_slot;
  const int items = min(heads, Hkv - h0) * per_head;
  for (int i = threadIdx.x; i < items; i += THREADS) {
    const int hl = i / per_head;
    const int rem = i - hl * per_head;
    const int s = rem / per_slot;
    const int c = rem - s * per_slot;
    const int slot = slot0 + s;
    if (slot < 0 || slot >= max_len) continue;
    const int h = h0 + hl;
    const size_t so = (((lb * S + s) * Hkv + h) * (size_t)E) + c * sizeof(V);
    const size_t d = (((lb * Hkv + h) * (size_t)max_len + slot) * E)
                     + c * sizeof(V);
    *reinterpret_cast<V*>(dst + d) = *reinterpret_cast<const V*>(src + so);
  }
}

__global__ void __launch_bounds__(THREADS)
scatter_kernel(Buffers bufs, const int* __restrict__ idx, int n, int B,
               int Hkv, int S, int max_len) {
  int j = 0;
  while (j + 1 < n && (int)blockIdx.x >= bufs.start[j + 1]) ++j;
  const int blk = (int)blockIdx.x - bufs.start[j];
  const int lb = blk / bufs.groups[j];                 // l * B + b
  const int h0 = (blk - lb * bufs.groups[j]) * bufs.heads[j];
  const int slot0 = __ldg(idx + lb % B);
  if (bufs.chunk[j] == 16) {
    copy_items<uint4>(bufs.dst[j], bufs.src[j], bufs.bytes[j], bufs.heads[j],
                      h0, Hkv, S, slot0, max_len, (size_t)lb);
  } else {
    copy_items<uint32_t>(bufs.dst[j], bufs.src[j], bufs.bytes[j],
                         bufs.heads[j], h0, Hkv, S, slot0, max_len,
                         (size_t)lb);
  }
}

int launch(void* const* dst, const void* const* src, const int* elem_bytes,
           int n, const void* idx, int rows, int B, int Hkv, int S,
           int max_len, void* stream) {
  if (n < 1 || n > 4 || rows < 1 || B < 1 || Hkv < 1 || S < 1 || S > 128 ||
      max_len < 1 || rows % (B * Hkv))
    return (int)cudaErrorInvalidValue;
  const long long pairs = rows / Hkv;                   // L * B
  Buffers bufs = {};
  long long blocks = 0;
  for (int j = 0; j < n; ++j) {
    const int E = elem_bytes[j];
    if (E < 4 || E % 4) return (int)cudaErrorInvalidValue;
    const bool wide = E % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dst[j]) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(src[j]) % 16 == 0;
    bufs.dst[j] = static_cast<unsigned char*>(dst[j]);
    bufs.src[j] = static_cast<const unsigned char*>(src[j]);
    bufs.bytes[j] = E;
    bufs.chunk[j] = wide ? 16 : 4;
    const int per_head = S * (E / bufs.chunk[j]);
    bufs.heads[j] = max(1, min(Hkv, THREADS / per_head));
    bufs.groups[j] = (Hkv + bufs.heads[j] - 1) / bufs.heads[j];
    bufs.start[j] = (int)blocks;
    blocks += pairs * bufs.groups[j];
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bufs.start[n] = (int)blocks;
  scatter_kernel<<<(unsigned)blocks, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      bufs, static_cast<const int*>(idx), n, B, Hkv, S, max_len);
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
