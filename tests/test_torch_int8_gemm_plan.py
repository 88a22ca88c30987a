"""M3 and M3d, the microbenchmarks' int8 GEMMs, on the port's one int8 GEMM
for large M (csrc/int8_wgmma.cuh, which K10 runs too), on the CPU: the
launch plan (``ops/int8_gemm.int8_gemm_plan``, the mirror of
csrc/int8_gemm.cu's launches) at every shape chip_smoke runs, its constants
against the header's, every shape the wrapper accepted before it still
accepts; M3d's plain version is K10's ls_residual function with no bias,
LayerScale 1 and residual 0, bit for bit (one GEMM serves both); the
sources: both libraries include the one GEMM and no mma.sync GEMM is left;
chip_smoke's cases, [sass] rules and the parent A/B's cases.

Tolerances: the plan's numbers are integers and the plain versions' outputs
bit patterns: equal.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from grounded_video_llm_tpu_torch.ops import fused_block as fb
from grounded_video_llm_tpu_torch.ops import int8_gemm as ig
from grounded_video_llm_tpu_torch.ops.int8_matmul import Int8Weight

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "grounded_video_llm_tpu_torch" / "csrc"
SMEM_MAX = 227 * 1024     # a block's shared memory on an H100
# chip_smoke.INT8_GEMM_CASES: the two microbench shapes, ragged M, the old
# resident-rows K, one row, K = 64, N = 384, K past 6,144
CASES = ((8192, 1408, 6144), (8192, 6144, 1408), (300, 1408, 6144),
         (300, 1792, 1408), (1, 1408, 6144), (300, 64, 6144),
         (300, 1408, 384), (300, 6208, 1408))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("M,K,N", CASES)
def test_plan_at_every_chip_smoke_shape(M, K, N, dynamic):
    """The plan holds together: the tile K10's wrapper picks for the same
    N, a grid that covers the output once, shared memory within a block's
    227 KB, at most 65,535 row blocks, the scratch the wrapper allocates,
    and 2 device kernels a call for M3 (transpose, GEMM), 3 for M3d."""
    p = ig.int8_gemm_plan(M, K, N, dynamic)
    assert p is not None
    assert p.tile_n == fb.output_tile(N) in (256, 176, 128)
    assert p.grid[0] * p.tile_n == N
    assert (p.grid[1] - 1) * 128 < M <= p.grid[1] * 128
    assert p.grid[1] <= 65535
    assert p.smem <= SMEM_MAX
    assert p.scratch == N * K + (M * K + 4 * M if dynamic else 0)
    assert p.kernels == (3 if dynamic else 2)


def test_plan_at_the_microbench_shapes():
    """fc1 takes 256-column tiles (24 x 64 blocks, 1,536 tiles), the fc2
    transpose 176-column tiles (8 x 64 = 512)."""
    fc1 = ig.int8_gemm_plan(8192, 1408, 6144, False)
    fc2t = ig.int8_gemm_plan(8192, 6144, 1408, True)
    assert (fc1.tile_n, fc1.grid, fc1.smem) == (256, (24, 64), 198272)
    assert (fc2t.tile_n, fc2t.grid, fc2t.smem) == (176, (8, 64), 157312)


def test_plan_constants_match_the_header():
    """The plan's tile constants, shared memory layout and tile widths are
    the header's."""
    src = (CSRC / "int8_wgmma.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("BM") == ig.GEMM_BM and const("BK") == ig.GEMM_STEP
    assert const("STAGES") == ig.GEMM_STAGES and const("TR") == ig.GEMM_BK
    for line in ("static constexpr int STAGE = A_BYTES + B_BYTES;",
                 "static constexpr int BAR_OFF = STAGES * STAGE;",
                 "static constexpr int PART_OFF = BAR_OFF + 128;",
                 "static constexpr int SMEM = PART_OFF + BM * 4 + 1024;",
                 "return N % 256 == 0 ? 256 : N % 176 == 0 ? 176 : "
                 "N % 128 == 0 ? 128 : 0;",
                 "(M + BM - 1) / BM <= 65535;"):
        assert line in src, line


@pytest.mark.parametrize("M,K,N", [(0, 128, 256), (8, 0, 256), (8, 96, 256),
                                   (8, 128, 192), (65535 * 128 + 1, 128, 256)])
def test_plan_refuses_with_the_wrappers_message(M, K, N):
    for dynamic, dt in ((False, torch.int8), (True, torch.bfloat16)):
        assert ig.int8_gemm_plan(M, K, N, dynamic) is None
        with pytest.raises(ValueError, match="kernel takes 1 <= M <= "):
            ig._check_gemm_args(
                "int8_gemm", torch.empty(M, K, dtype=dt, device="meta"),
                torch.empty(K, N, dtype=torch.int8, device="meta"),
                torch.empty(N, device="meta"), dt)


def _accepted_before(M, K, N, dynamic):
    """The wrapper's rule before the one GEMM (K >= 64 as its C entry
    required): M3d kept 64 rows a block for K <= 1,792."""
    bm = 64 if dynamic and K <= 1792 else 128
    return M >= 1 and K >= 64 and K % 64 == 0 and N % 128 == 0 \
        and -(-M // bm) <= 65535


def test_every_shape_accepted_before_is_still_accepted():
    """Nothing the old wrapper took is refused now; the one change is M3d's
    row cap for K <= 1,792, widened from 65,535 x 64 to 65,535 x 128."""
    widened = 0
    for M in (1, 2, 127, 128, 129, 300, 8192, 65535 * 64, 65535 * 64 + 1,
              65535 * 128, 65535 * 128 + 1):
        for K in (64, 128, 1344, 1408, 1792, 1856, 6144, 6208):
            for N in (128, 256, 384, 640, 1408, 4224, 6144):
                for dynamic in (False, True):
                    before = _accepted_before(M, K, N, dynamic)
                    now = ig.int8_gemm_plan(M, K, N, dynamic) is not None
                    assert now >= before, (M, K, N, dynamic)
                    widened += now and not before
                    assert now == (M <= 65535 * 128), (M, K, N, dynamic)
    assert widened > 0


@pytest.mark.parametrize("M,K,N", [(8, 128, 256), (37, 1408, 384),
                                   (5, 64, 1408)])
def test_dynamic_reference_is_k10_ls_residual_without_bias(M, K, N):
    """int8_gemm_dynamic_reference(x, w, s) is K10's ls_residual plain
    version with no bias, LayerScale 1 and residual 0, bit for bit: the same
    row quantization, exact dot and rescale order, so one GEMM (its plain
    epilogue) serves both functions."""
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).bfloat16()
    w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    s = torch.from_numpy((rng.random(N) * 1e-3 + 1e-4).astype(np.float32))
    got = ig.int8_gemm_dynamic_reference(x, w, s)
    k10 = fb.fused_quant_gemm_ls_residual_reference(
        x, Int8Weight(w, s), None, torch.ones(N),
        torch.zeros(M, N, dtype=torch.bfloat16))
    assert got.dtype == k10.dtype == torch.bfloat16
    assert torch.equal(got, k10)


def test_one_gemm_serves_k10_m3_and_m3d():
    """Both libraries include the one int8 GEMM; the mma.sync GEMM M3 and
    M3d ran before is gone, and so are M1's three kernels (M1 runs K3's
    w8a8 kernel in int8_matmul.cu)."""
    head = (CSRC / "int8_wgmma.cuh").read_text()
    assert "gemm_kernel(const __grid_constant__ CUtensorMap map_a" in head
    assert "EPI_STATIC" in head and "wgmma.mma_async" in head
    for name in ("fused_block.cu", "int8_gemm.cu"):
        src = (CSRC / name).read_text()
        assert '#include "int8_wgmma.cuh"' in src
        assert "gemm_kernel(" not in src and "wgmma_s8" not in src
    gemm = (CSRC / "int8_gemm.cu").read_text()
    for gone in ("GemmArgs", "gemm_dyn_resident_kernel", "RES_KMAX", "LDS"):
        assert gone not in gemm, gone
    # M1's three kernels are gone: it runs K3's w8a8 kernel
    assert "__global__" not in gemm
    for gone in ("gv_quant_kernel", "gv_gemv_kernel", "gv_finish_kernel",
                 "gvllm_i8i8_gemv", "mma_s8", "transpose4x4", "GV_"):
        assert gone not in gemm, gone
    assert ig.I8I8_GEMV.source.name == "int8_matmul.cu"
    assert "launch_gemm<EPI_STATIC>" in gemm
    assert "launch_gemm<EPI_NONE>" in gemm
    assert "fused_block.cu" not in str(ig.INT8_GEMM.source)


def test_chip_smoke_gemm_cases_reach_every_tile_width_and_rule():
    """chip_smoke runs CASES, where both entries take each of the tile
    widths 256, 176 and 128, one row, K = 64 and a K past the rows kernel's
    register-held 6,144; its [sass] rules hold libint8_gemm's GEMM to int8
    wgmma and TMA loads without mma.sync, and M1's kernel, K3's w8a8
    instantiation, to TMA loads and int8 mma.sync."""
    cs = _chip_smoke()
    assert cs.INT8_GEMM_CASES == CASES
    assert CASES[:2] == ((8192, 1408, 6144), (8192, 6144, 1408))
    for dynamic in (False, True):
        assert {ig.int8_gemm_plan(*c, dynamic).tile_n for c in CASES} \
            == {256, 176, 128}
    assert min(M for M, _, _ in CASES) == 1
    assert min(K for _, K, _ in CASES) == 64
    assert max(K for _, K, _ in CASES) > 256 * 3 * 8
    name = "11gemm_kernelILi256ELi4EEE"
    ok = dict.fromkeys(cs.SASS_OPS, 0) | {"IGMMA": 44, "UTMALDG": 2}
    assert cs.sass_ok("libint8_gemm.so", name, ok) is True
    assert cs.sass_ok("libint8_gemm.so", name, ok | {"IMMA": 1}) is False
    assert cs.sass_ok("libint8_gemm.so", name, ok | {"HMMA": 1}) is False
    assert cs.sass_ok("libint8_gemm.so", name, ok | {"UTMALDG": 0}) is False
    # M1's kernel is K3's w8a8 instantiation, held by libint8_matmul's rule
    gv = dict.fromkeys(cs.SASS_OPS, 0) | {"IMMA": 4, "UTMALDG": 2}
    assert cs.sass_ok("libint8_matmul.so", "14int8_mm_kernelILb1ELi16EEE",
                      gv) is True
    assert cs.sass_ok("libint8_matmul.so", "14int8_mm_kernelILb1ELi16EEE",
                      gv | {"IMMA": 0}) is False
    assert not any("gv_gemv" in frag for _, frag, *_ in cs.SASS_REQUIRED)
    assert cs.sass_ok("libint8_gemm.so", "16transpose_kernelE", gv) is None


def test_int8_matmul_ab_times_m3_m3d_and_k10_of_another_checkout():
    """microbench/int8_matmul_ab also loads the other checkout's
    ops.int8_gemm and ops.fused_block (here this checkout: on CPU tensors
    both run the plain versions, bit-equal) and times M3 and M3d at
    microbench/int8_gemm's two shapes and K10's four GEMMs of an IV2 block
    at path D's rows."""
    import importlib

    from grounded_video_llm_tpu_torch.core.config import vlm_config
    from grounded_video_llm_tpu_torch.microbench import int8_gemm as mb_gemm
    from grounded_video_llm_tpu_torch.microbench import int8_matmul_ab as ab

    other_mm = ab.load_other(REPO)
    other = importlib.import_module("gvllm_other.ops.int8_gemm")
    other_fb = importlib.import_module("gvllm_other.ops.fused_block")
    assert other.INT8_GEMM is not ig.INT8_GEMM
    assert other_fb.FUSED_NORM_QUANT_GEMM is not fb.FUSED_NORM_QUANT_GEMM
    cfg = vlm_config("phi3.5", stage="inference")
    D, I = cfg.video.embed_dim, cfg.video.mlp_hidden
    assert ab.fused_cases(cfg) == (
        ("qkv", "fused_norm_quant_gemm", "qk_norm", D, 3 * D),
        ("fc1", "fused_norm_quant_gemm", "gelu", D, I),
        ("proj", "fused_quant_gemm_ls_residual", None, D, D),
        ("fc2", "fused_quant_gemm_ls_residual", None, I, D))
    assert ab.PATH_D_VIDEOS * cfg.num_segs * cfg.video.seq_len == 147528
    rng = np.random.default_rng(11)
    xr = torch.from_numpy(rng.standard_normal((6, 128)).astype(np.float32)
                          ).bfloat16()
    q = torch.from_numpy(rng.integers(-127, 128, (128, 128)).astype(np.int8))
    sc = torch.from_numpy(rng.random(128).astype(np.float32) + 1e-3)
    vec = torch.ones(128)
    assert torch.equal(
        other_fb.fused_quant_gemm_ls_residual(xr, other_mm.Int8Weight(q, sc),
                                              vec, vec, xr),
        fb.fused_quant_gemm_ls_residual(xr, Int8Weight(q, sc), vec, vec, xr))
    g = torch.Generator().manual_seed(3)
    x = torch.randn(6, 128, generator=g).bfloat16()
    x8 = torch.randint(-127, 128, (6, 128), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (128, 256), generator=g, dtype=torch.int8)
    s = torch.rand(256, generator=g)
    assert torch.equal(other.int8_gemm(x8, w, s), ig.int8_gemm(x8, w, s))
    assert torch.equal(other.int8_gemm_dynamic(x, w, s),
                       ig.int8_gemm_dynamic(x, w, s))
    assert tuple(c[1:] for c in ab.gemm_cases()) == mb_gemm.SHAPES
