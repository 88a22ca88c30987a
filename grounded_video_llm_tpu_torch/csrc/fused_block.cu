// Fused W8A8 InternVideo2-block GEMMs, Hopper (sm_90a): int8 wgmma and TMA.
//
// K10: replaces grounded_video_llm_tpu/ops/fused_block.py
//   fused_norm_quant_gemm        (`_nqg_kernel`)  -> gvllm_fused_norm_quant_gemm
//   fused_quant_gemm_ls_residual (`_qglr_kernel`) -> gvllm_fused_quant_gemm_ls_residual
//
// Contract (x [M,K] bf16, w [K,N] int8 row-major, ws [N] fp32, all fp32
// vectors below):
//   rows:  h = x * (1 / sqrt(mean(x^2) + eps)) * norm_w in fp32 (the norm is
//          skipped for the ls_residual entry), then per row
//          s = max(absmax(h) / 127, 1e-8), x8 = clamp(rint(h / s), -127, 127)
//          with no bf16 rounding in between;
//   dot:   acc = x8 @ w exactly in int32; y = float(acc) * s * ws[n] (+ bias);
//   epilogue "none": y; "gelu": 0.5 y (1 + erf(y / sqrt 2)) with the
//          Abramowitz-Stegun rational erf of the JAX kernel; "qk_norm"
//          (N = 3K): each K-wide q and k third of the fp32 row y is RMS
//          normalised, y * (1 / sqrt(mean(y^2) + eps)) * qn[third], the v
//          third passes; ls_residual: y * ls[n] + residual[m, n];
//   output bf16.
//
// What bounds it on an H100: the int8 tensor-core rate (1,979 TOP/s) for
// qkv, fc1 and fc2 at path D's 147,528 rows; proj (K = N = 1,408) is close
// to the byte bound.
//
// Design. Three launches per call, all on the caller's stream: the rows,
// the K-major weight and the GEMM of int8_wgmma.cuh (its header says how
// each is built; the microbenchmarks' M3 and M3d run the same GEMM). The
// TPU kernel keeps a quantized row tile in VMEM across the N blocks; here
// the GEMM's A operand arrives by TMA, so the rows are written once and
// read by every column block.
//  qk_norm without recomputing the GEMM: the sum of squares of a K-wide
//  fp32 third is needed before any rounding. The q and k thirds are cut
//  into CL column tiles of BN (K = CL * BN; 8 x 176 at K = 1,408) that run
//  as one thread-block cluster of CL blocks. Each block writes its rows'
//  partial sums of y^2 (its BN columns) to shared memory; after a cluster
//  barrier every block reads the CL partials of its rows through
//  distributed shared memory (mapa + ld.shared::cluster) in rank order,
//  so all CL blocks add the same numbers in the same order, normalises and
//  stores; a second cluster barrier keeps every block's shared memory
//  alive until the others have read it. The GEMM runs once.
//  The ls_residual epilogue loads every residual before its first store:
//  out may alias res as far as the compiler knows, so it would not move a
//  load above a store, and each load's latency would serialize (proj
//  1.53 -> 1.12 ms at path D's rows, NVIDIA H100 80GB HBM3, 700 W).

#include "int8_wgmma.cuh"

// x [M,K] bf16, norm_w [K] fp32, w [K,N] int8, ws [N] fp32, bias [N] fp32 or
// null, qn [2,K] fp32 (qk_norm) -> out [M,N] bf16. Scratch from the caller:
// x8 [M,K] int8, xs [M] fp32, wt [N,K] int8 (the weight, K-major). epilogue:
// 0 none, 1 gelu, 2 qk_norm (N == 3K, K a cluster of at most 8 tiles of
// 256, 176 or 128 columns). K % 64 == 0, N % 128 == 0.
extern "C" int gvllm_fused_norm_quant_gemm(
    const void* x, const void* norm_w, const void* w, const void* ws,
    const void* bias, const void* qn, void* out, void* x8, void* xs,
    void* wt, int M, int K, int N, int epilogue, float eps, void* stream) {
  if (!shapes_ok(M, K, N) || epilogue < 0 || epilogue > 2 ||
      (epilogue == 2 && (N != 3 * K || tile_qk(K) == 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_rows(x, static_cast<const float*>(norm_w),
                        static_cast<int8_t*>(x8), static_cast<float*>(xs), M, K,
                        eps, st);
  if (err) return err;
  err = launch_transpose(w, static_cast<int8_t*>(wt), K, N, st);
  if (err) return err;
  Args a{static_cast<const float*>(xs), static_cast<const float*>(ws),
         static_cast<const float*>(bias), nullptr, nullptr,
         static_cast<const float*>(qn), static_cast<bf16*>(out), M, N, K, eps};
  const int8_t* x8p = static_cast<const int8_t*>(x8);
  const int8_t* wtp = static_cast<const int8_t*>(wt);
  if (epilogue == 0) return launch_gemm<EPI_NONE>(a, x8p, wtp, st);
  if (epilogue == 1) return launch_gemm<EPI_GELU>(a, x8p, wtp, st);
  return launch_gemm<EPI_QK_NORM>(a, x8p, wtp, st);
}

// x [M,K] bf16, w [K,N] int8, ws [N], bias [N], ls [N] fp32, res [M,N] bf16
// -> out [M,N] bf16 = res + ls * (quant(x) @ w * ws + bias). Scratch x8, xs,
// wt as above.
extern "C" int gvllm_fused_quant_gemm_ls_residual(
    const void* x, const void* w, const void* ws, const void* bias,
    const void* ls, const void* res, void* out, void* x8, void* xs, void* wt,
    int M, int K, int N, void* stream) {
  if (!shapes_ok(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_rows(x, nullptr, static_cast<int8_t*>(x8),
                        static_cast<float*>(xs), M, K, 0.f, st);
  if (err) return err;
  err = launch_transpose(w, static_cast<int8_t*>(wt), K, N, st);
  if (err) return err;
  Args a{static_cast<const float*>(xs), static_cast<const float*>(ws),
         static_cast<const float*>(bias), static_cast<const float*>(ls),
         static_cast<const bf16*>(res), nullptr, static_cast<bf16*>(out), M, N,
         K, 0.f};
  return launch_gemm<EPI_LS_RES>(a, static_cast<const int8_t*>(x8),
                                 static_cast<const int8_t*>(wt), st);
}
