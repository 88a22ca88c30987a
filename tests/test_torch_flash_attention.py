"""The port's flash_fwd (plain version on CPU) against the JAX _flash_fwd in
Pallas interpret mode: o AND lse, over bias / bounded / causal / window /
GQA / ragged S / head-dim cases. fp32, at the repo's kernel bar (rtol 2e-4,
atol 2e-5, as tests/test_flash_attention.py)."""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_llm_tpu.ops.flash_attention import _flash_fwd
from grounded_video_llm_tpu_torch.core.config import vlm_config
from grounded_video_llm_tpu_torch.ops.flash_attention import (NEG_INF,
                                                              flash_fwd,
                                                              flash_mha)

RTOL, ATOL = 2e-4, 2e-5

# (B, Sq, Sk, H, Hkv, D, causal, bounded, has_bias, window, pad_rows)
# pad_rows: per batch row, how many leading keys the mask removes
CASES = {
    "noncausal": (2, 64, 64, 4, 4, 16, False, False, False, None, (0, 0)),
    "noncausal_bias": (2, 64, 64, 4, 4, 16, False, False, True, None,
                       (0, 9)),
    "noncausal_bias_deadrow": (2, 40, 40, 2, 2, 16, False, False, True, None,
                               (0, 40)),
    "bounded": (2, 129, 129, 4, 4, 88, False, True, False, None, (0, 0)),
    "bounded_bias": (2, 37, 37, 4, 4, 16, False, True, True, None, (0, 5)),
    "causal": (2, 37, 37, 4, 4, 16, True, False, False, None, (0, 0)),
    "causal_leftpad": (2, 48, 48, 4, 4, 16, True, False, True, None, (0, 11)),
    "causal_window": (2, 129, 129, 4, 4, 16, True, False, True, 7, (0, 3)),
    "gqa_causal": (2, 37, 37, 4, 2, 16, True, False, True, None, (0, 4)),
    "gqa_noncausal": (1, 129, 129, 4, 2, 88, False, False, False, None, (0,)),
    "causal_d88": (1, 129, 129, 2, 2, 88, True, False, True, None, (5,)),
    "causal_rect": (1, 16, 40, 2, 2, 16, True, False, True, None, (2,)),
}


def _inputs(B, Sq, Sk, H, Hkv, D, pad_rows, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    mask = np.ones((B, Sk), np.int32)
    for b, n in enumerate(pad_rows):
        mask[b, :n] = 0
    bias = np.where(mask > 0, 0.0, NEG_INF).astype(np.float32)
    return q, k, v, mask, bias


@pytest.mark.parametrize("name", list(CASES))
def test_flash_fwd_matches_jax(name):
    (B, Sq, Sk, H, Hkv, D, causal, bounded, has_bias, window,
     pad_rows) = CASES[name]
    q, k, v, _, bias = _inputs(B, Sq, Sk, H, Hkv, D, pad_rows, seed=len(name))
    if not has_bias and not causal:
        bias = np.zeros_like(bias)
    scale = D ** -0.5
    o_j, lse_j = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(bias), scale, causal, bounded=bounded,
                            window=window, has_bias=has_bias)
    o_t, lse_t = flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(bias), scale,
                           causal, bounded=bounded, window=window,
                           has_bias=has_bias)
    assert o_t.shape == (B, Sq, H, D) and lse_t.shape == (B, H, Sq)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=RTOL,
                               atol=ATOL)
    assert not np.isnan(o_t.numpy()).any()


def test_dead_rows_are_zero_with_infinite_lse():
    """Left-padded causal rows whose keys are all masked: o == 0 exactly and
    lse == +inf, in both packages."""
    B, S, H, D = 2, 48, 4, 16
    q, k, v, _, bias = _inputs(B, S, S, H, H, D, (0, 11), seed=3)
    o_j, lse_j = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(bias), D ** -0.5, True)
    o_t, lse_t = flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(bias),
                           D ** -0.5, True)
    for o, lse in ((o_t.numpy(), lse_t.numpy()),
                   (np.asarray(o_j), np.asarray(lse_j))):
        assert np.all(o[1, :11] == 0.0)
        assert np.all(np.isposinf(lse[1, :, :11]))
        assert np.all(np.isfinite(lse[1, :, 11:]))
        assert np.all(np.isfinite(lse[0]))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_mha_keep_mask_matches_jax(causal):
    from grounded_video_llm_tpu.ops.flash_attention import (
        flash_mha as jax_flash_mha)

    B, S, H, D = 2, 33, 4, 16
    q, k, v, mask, _ = _inputs(B, S, S, H, 2, D, (0, 6), seed=11)
    out_j = jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, mask=jnp.asarray(mask))
    out_t = flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), causal=causal,
                      mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL,
                               atol=ATOL)


REPO = Path(__file__).resolve().parents[1]
FLASH_SOURCE = (REPO / "grounded_video_llm_tpu_torch" / "csrc"
                / "flash_fwd.cu")
KERNEL_MODES = {"kOnline": 0, "kFixed": 1, "kNoExp": 2, "kSumDot": 3}


def _compiled_instantiations():
    """(D, causal, mode) of every flash_fwd_kernel that the two C entries
    compile: the head dims each entry dispatches on, times the launches its
    dispatch function makes."""
    src = FLASH_SOURCE.read_text()
    got = set()
    for entry, fn in (("gvllm_flash_fwd", "dispatch"),
                      ("gvllm_flash_variant", "dispatch_variant")):
        body = src[src.index(f"cudaError_t {fn}("):]
        body = body[:body.index("\n}\n")]
        launches = re.findall(r"launch<D, (true|false), (k\w+)>", body)
        entry_body = src[src.index(f'extern "C" int {entry}('):]
        entry_body = entry_body[:entry_body.index("\n}\n")]
        dims = re.findall(rf"\b{fn}<(\d+)>", entry_body)
        assert launches and dims, entry
        got |= {(int(D), c == "true", KERNEL_MODES[m])
                for D in dims for c, m in launches}
    return got


def test_chip_smoke_flash_cases_reach_every_instantiation():
    """chip_smoke's flash and variant cases launch every flash_fwd_kernel
    instantiation the library compiles, so the card checks each against
    the plain version (and its [sass] line covers each)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    compiled = _compiled_instantiations()
    assert len(compiled) == 20     # 4 head dims x (causal + 4 modes)
    cfg = vlm_config("phi3.5", stage="inference")
    assert cs.flash_instantiations(cfg, 3709) == compiled
    # the tile-aligned causal square: q_offset off the 128-key tile grid
    aligned = dict(cs.FLASH_EDGE_CASES)["aligned_q_offset"]
    assert aligned["Sq"] % 128 == 0 and aligned["q_offset"] % 128


def test_chip_smoke_reads_sass_opcodes():
    """The [sass] parser counts wgmma, TMA loads and mma.sync per kernel
    from cuobjdump's listing (predicated lines included)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    text = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_116flash_fwd_kernelILi88ELb0ELi1EEEvNS_4MapsEPKfP13__nv_bfloat16PfiiiiffiifNS_7StridesE
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0020*/              @!P0 UTMALDG.4D [UR16], [UR4] ;
        /*0030*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
		Function : _ZN12_GLOBAL__N_114scatter_kernelENS_7BuffersEPKiiiiii
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""
    got = cs.sass_counts(text)
    assert got["16flash_fwd_kernelILi88ELb0ELi1EEE"] == {
        "HGMMA": 1, "IGMMA": 0, "UTMALDG": 2, "UBLKCP": 0, "HMMA": 0,
        "IMMA": 0}
    assert got["14scatter_kernelE"]["HMMA"] == 1


def test_chip_smoke_reads_int8_wgmma_and_holds_each_rule():
    """The parser counts int8 wgmma (IGMMA); the [sass] rules hold the flash
    forward and backward to HGMMA, the int8 GEMM for large M (K10 in
    libfused_block, M3 / M3d in libint8_gemm) to IGMMA, each with TMA loads
    and without mma.sync, and name no other kernel."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    text = """
		Function : _ZN12_GLOBAL__N_111gemm_kernelILi176ELi2EEEv14CUtensorMap_stS1_NS_4ArgsE
        /*0000*/                   UTMALDG.2D [UR8], [UR4] ;
        /*0010*/                   IGMMA.64x176x32.S8.S8 R24, gdesc[UR4], R24 ;
        /*0020*/                   IGMMA.64x176x32.S8.S8 R24, gdesc[UR8], R24 ;
		Function : _ZN12_GLOBAL__N_120flash_bwd_dkv_kernelILi96ELb1EEEvNS_4MapsENS_6ParamsE
        /*0000*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
		Function : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi96ELb1EEEvNS_4MapsENS_6ParamsE
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""
    got = cs.sass_counts(text)
    gemm = got["11gemm_kernelILi176ELi2EEE"]
    assert gemm == {"HGMMA": 0, "IGMMA": 2, "UTMALDG": 1, "UBLKCP": 0,
                    "HMMA": 0, "IMMA": 0}
    assert cs.sass_ok("libfused_block.so", "11gemm_kernelILi176ELi2EEE",
                      gemm) is True
    dkv = got["20flash_bwd_dkv_kernelILi96ELb1EEE"]
    assert cs.sass_ok("libflash_bwd.so", "20flash_bwd_dkv_kernelILi96ELb1EEE",
                      dkv) is True
    # mma.sync and no wgmma or TMA: refused
    assert cs.sass_ok("libflash_bwd.so", "19flash_bwd_dq_kernelILi96ELb1EEE",
                      got["19flash_bwd_dq_kernelILi96ELb1EEE"]) is False
    # bf16 wgmma where the int8 GEMM needs IGMMA: refused
    assert cs.sass_ok("libfused_block.so", "11gemm_kernelILi176ELi2EEE",
                      dict(gemm, HGMMA=2, IGMMA=0)) is False
    # kernels no rule names are only reported
    assert cs.sass_ok("libfused_block.so", "16row_quant_kernelE", gemm) is None
    # the same GEMM behind M3 / M3d in libint8_gemm: held to the same rule,
    # int8 wgmma and TMA loads, no mma.sync
    assert cs.sass_ok("libint8_gemm.so", "11gemm_kernelILi176ELi2EEE",
                      gemm) is True
    assert cs.sass_ok("libint8_gemm.so", "11gemm_kernelILi176ELi2EEE",
                      dict(gemm, IMMA=8)) is False
