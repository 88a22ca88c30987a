"""The microbenchmark kernels' plain versions against the JAX package's TPU
scripts on the CPU, and the port's microbenchmark modules at tiny sizes.

  M2  flash_variant_reference against scripts/microbench_encoder_attn.py's
      flash_variant in interpret mode (the script passes no interpret flag,
      so its module's `pl` is swapped for one whose pallas_call interprets;
      its import reads sys.argv[1], so argv is set while importing), every
      mode, S ragged against block_q, Dh 88 (dh128: the script pads to 128):
      rtol 2**-7, atol 1e-3 on bf16 outputs. For "noexp" (p = s) a row's
      output is a ratio of sums that can cancel, so rows are held to the bar
      only where |sum(s)| >= 1e-2 * sum(|s|).
  M3  int8_gemm_reference bit-equal to `_pl_kernel`'s body (a closure inside
      the script's main, :120-125) written with the same jax.lax ops.
  M3d and M1: bit-equal to the JAX dynamic_int8_matmul with bf16 x.
  The script's M1 (`i8i8_matmul`) returns zeros and fails for a batch that
  is not a multiple of 32: pinned here, the reason the port computes the
  documented function instead.
"""

import functools
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as real_pl

from grounded_video_llm_tpu.ops.int8_matmul import (dynamic_int8_matmul,
                                                    quantize_weights_int8)
from grounded_video_llm_tpu_torch.microbench import decode as mb_decode
from grounded_video_llm_tpu_torch.microbench import encoder_attn as mb_attn
from grounded_video_llm_tpu_torch.microbench import flash_bwd as mb_bwd
from grounded_video_llm_tpu_torch.microbench import int8_gemm as mb_gemm
from grounded_video_llm_tpu_torch.microbench import int8_matmul_ab as mb_ab
from grounded_video_llm_tpu_torch.microbench import iv2_block as mb_iv2
from grounded_video_llm_tpu_torch.microbench import \
    static_scales as mb_static
from grounded_video_llm_tpu_torch.ops import flash_attention as fa
from grounded_video_llm_tpu_torch.ops import int8_gemm as ig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M2_TOL = dict(rtol=2 ** -7, atol=1e-3)


def _load_script(name, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name])
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def attn_script(monkeypatch):
    mod = _load_script("microbench_encoder_attn", monkeypatch)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(real_pl.pallas_call, interpret=True),
        BlockSpec=real_pl.BlockSpec, ds=real_pl.ds)
    return mod


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("mode", sorted(fa.VARIANT_MODES))
def test_flash_variant_plain_matches_script(attn_script, mode):
    rng = np.random.default_rng(len(mode))
    S, D = 37, 88                    # 3 q blocks of 16: a ragged, odd tail
    q, k, v = (_normal(rng, (1, 2, S, D)) for _ in range(3))
    if mode == "dh128":              # the script pads q/k/v to 128
        q, k, v = (np.pad(t, ((0, 0), (0, 0), (0, 0), (0, 40)))
                   for t in (q, k, v))
    want = np.asarray(attn_script.flash_variant(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), mode,
        block_q=16), np.float32)
    qt, kt, vt = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    got = fa.flash_variant(qt, kt, vt, mode)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == q.shape
    assert torch.equal(got, fa.flash_variant_reference(qt, kt, vt, mode))
    got = got.float().numpy()
    if mode == "noexp":
        s = np.einsum("bhqd,bhkd->bhqk", qt.float().numpy(),
                      kt.float().numpy())
        keep = np.abs(s.sum(-1)) >= 1e-2 * np.abs(s).sum(-1)
        assert keep.mean() > 0.5
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, **M2_TOL)


def test_flash_variant_modes_differ_where_they_should():
    """full and the offset modes agree (softmax is offset-invariant) up to
    one bf16 ulp of the output (P rounds to bf16 at another scale); noexp
    does not; an unknown mode raises."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 2, 20, 64))).bfloat16()
               for _ in range(3))
    full = fa.flash_variant(q, k, v, "full").float()
    for mode in ("nomax", "exp2", "sumdot"):
        torch.testing.assert_close(fa.flash_variant(q, k, v, mode).float(),
                                   full, rtol=2 ** -7, atol=2 ** -8)
    assert not torch.allclose(fa.flash_variant(q, k, v, "noexp").float(),
                              full, atol=0.1)
    with pytest.raises(ValueError, match="mode"):
        fa.flash_variant(q, k, v, "relu")


def _pl_kernel_body(x8, w, s):
    """`_pl_kernel` of scripts/microbench_int8_gemm.py:120-125 on whole
    arrays."""
    y = jax.lax.dot_general(x8, w, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    return (y.astype(jnp.float32) * s[None, :]).astype(jnp.bfloat16)


@pytest.mark.parametrize("M,K,N", [(40, 128, 256), (7, 1408, 128)])
def test_int8_gemm_plain_bit_equal_script(M, K, N):
    rng = np.random.default_rng(M)
    x8 = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s = (np.abs(rng.normal(size=N)) * 1e-3 + 1e-4).astype(np.float32)
    want = np.asarray(_pl_kernel_body(jnp.asarray(x8), jnp.asarray(w),
                                      jnp.asarray(s)), np.float32)
    got = ig.int8_gemm(torch.from_numpy(x8), torch.from_numpy(w),
                       torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("fn", ["int8_gemm_dynamic", "i8i8_matmul"])
@pytest.mark.parametrize("M", [1, 6, 16])
def test_dynamic_plain_bit_equal_jax(fn, M):
    rng = np.random.default_rng(M)
    K, N = 256, 384
    x = rng.normal(size=(M, K)).astype(np.float32)
    wq, ws = quantize_weights_int8(jnp.asarray(rng.normal(size=(K, N)) * 0.1,
                                               jnp.float32))
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(dynamic_int8_matmul(xj, wq, ws), np.float32)
    got = getattr(ig, fn)(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(np.array(wq)),
                          torch.from_numpy(np.array(ws)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_script_m1_prototype_returns_zeros(monkeypatch):
    """scripts/microbench_decode.py:85 multiplies its output by a zeros
    "placeholder" (:69-70, :90, :97): all zeros at M = 32, and a batch that
    is not a multiple of 32 (its default, 6) fails on the padded x scales
    (:99). The port's M1 computes the docstring's function."""
    script = _load_script("microbench_decode", monkeypatch)
    rng = np.random.default_rng(0)
    wq, ws = quantize_weights_int8(jnp.asarray(rng.normal(size=(64, 512))
                                               * 0.1, jnp.float32))
    x = jnp.asarray(rng.normal(size=(32, 64)), jnp.bfloat16)
    assert float(jnp.abs(script.i8i8_matmul(x, wq, ws)).max()) == 0.0
    want = np.asarray(dynamic_int8_matmul(x, wq, ws), np.float32)
    assert np.abs(want).max() > 1.0
    got = ig.i8i8_matmul(torch.from_numpy(np.asarray(x, np.float32))
                         .bfloat16(), torch.from_numpy(np.array(wq)),
                         torch.from_numpy(np.array(ws)))
    np.testing.assert_array_equal(got.float().numpy(), want)
    with pytest.raises(TypeError, match="broadcast"):
        script.i8i8_matmul(x[:6], wq, ws)


# ---------------------------------------------------------------------------
# The microbenchmark modules on CPU tensors (their plain versions)
# ---------------------------------------------------------------------------


def test_int8_gemm_variants_compute_one_function():
    x, w, xq, wq, xs, ws = mb_gemm.inputs(24, 128, 256, "cpu")
    fns = mb_gemm.variants(x, w, xq, wq, xs, ws)
    assert list(fns) == ["bf16", "i8i8", "i8i8_rescale", "i8i8_dynamic",
                         "m3_static", "m3_dynamic"]
    acc = fns["i8i8"]()
    assert acc.dtype == torch.int32
    assert torch.equal(fns["m3_static"](),
                       (acc.float() * ws).to(torch.bfloat16))
    torch.testing.assert_close(fns["i8i8_rescale"](), acc.float() * xs * ws)
    assert torch.equal(fns["m3_dynamic"](), fns["i8i8_dynamic"]())
    assert fns["bf16"]().shape == (24, 256)
    assert mb_gemm.SHAPES == ((8192, 1408, 6144), (8192, 6144, 1408))


def test_decode_variants_compute_one_function():
    """M1 and K3's w8a8 branch compute one function (bit-equal plain
    versions); the weight-only GEMV and bf16 agree to bf16 level."""
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(2, 256, 128, generator=g) * 0.02).bfloat16()
    wq, ws = mb_decode.quantize_weights_int8(w)
    x = (torch.randn(6, 256, generator=g) * 0.1).bfloat16()
    fns = {k: mb_decode.cycle(f, 2) for k, f in
           mb_decode.gemv_variants(x, w, wq, ws).items()}
    assert torch.equal(fns["gemv_i8i8"](), fns["gemv_w8a8"]())
    torch.testing.assert_close(fns["gemv_int8"]().float(),
                               fns["gemv_bf16"]().float(), rtol=0.05,
                               atol=0.02)
    assert mb_decode.copies(28 * 2 ** 20) == 6
    assert mb_decode.copies(10 ** 9) == 2


def test_decode_attention_variants_agree():
    B, L, Hkv, D = 2, 40, 2, 32
    g = torch.Generator().manual_seed(1)
    r = lambda *s: (torch.randn(*s, generator=g) * 0.3).bfloat16()  # noqa
    q, kn, vn = r(B, 1, Hkv, D), r(B, 1, Hkv, D), r(B, 1, Hkv, D)
    kc, vc = r(1, B, L, Hkv, D), r(1, B, L, Hkv, D)
    k8, ks = mb_decode.quantize_kv(kc.transpose(2, 3))
    v8, vs = mb_decode.quantize_kv(vc.transpose(2, 3))
    k8, ks, v8, vs = (t.contiguous() for t in (k8, ks, v8, vs))
    mask = torch.ones(B, L, dtype=torch.bool)
    fns = mb_decode.attention_variants(q, kc, vc, k8, ks, v8, vs, mask, kn,
                                       vn)
    torch.testing.assert_close(fns["attn_int8"](0).float(),
                               fns["attn_bf16"](0).float(), rtol=0.05,
                               atol=0.02)


def test_static_scales_summary_has_the_scripts_keys():
    best = {"dynamic": 2.0, "static_fc2": 1.9, "static_f2p": 1.8,
            "static_all": 1.7}
    out = mb_static.summary(best, 72, 39, "card, 700.00 W")
    assert set(out) == {"metric", "clips", "dynamic", "static_fc2",
                        "static_f2p", "static_all", "delta_ms_per_block",
                        "speedup", "card"}
    assert out["metric"] == "iv2_static_scales_sec_per_forward"
    assert out["delta_ms_per_block"]["static_all"] == round(300 / 39, 2)
    assert out["speedup"]["static_fc2"] == round(2.0 / 1.9, 4)
    assert [n for n, _ in mb_static.VARIANTS] == list(best)


def test_flash_bwd_variants_compute_one_function():
    """K7 alone, K2 + K7 through autograd and SDPA's backward give one
    gradient on CPU tensors (plain versions; bf16 inputs)."""
    q, k, do = mb_bwd.inputs(1, 40, 2, 2, 32, "cpu")
    fns = mb_bwd.variants(q, k, do)
    assert list(fns) == list(mb_bwd.VARIANTS)
    dq, dk, dv = fns["k7_bwd"]()
    for a, b in zip(fns["k2_k7_fwd_bwd"](), (dq, dk, dv)):
        assert torch.equal(a, b)
    for a, b in zip(fns["sdpa_fwd_bwd"](), (dq, dk, dv)):
        torch.testing.assert_close(a.transpose(1, 2).float(), b.float(),
                                   rtol=0.05, atol=0.05)
    torch.testing.assert_close(fns["sdpa_fwd"]().transpose(1, 2).float(),
                               fns["k2_fwd"]()[0].float(), rtol=0.02,
                               atol=0.02)
    out = mb_bwd.summary({n: 1.0 + i for i, n in enumerate(mb_bwd.VARIANTS)},
                         "card, 700.00 W")
    assert out["sdpa_bwd"] == 1.0 and out["k7_vs_sdpa_bwd"] == 0.5
    assert (mb_bwd.B, mb_bwd.S, mb_bwd.H, mb_bwd.KV, mb_bwd.D) == (
        1, 7515, 32, 32, 96)


def test_iv2_block_variants_compute_one_block():
    """The three blocks and the four GEMM legs on a micro IV2 config (CPU,
    plain versions): the W8A8 blocks near the bf16 one, each leg's
    quantized variants near its bf16 dot, the attention stub restored."""
    from grounded_video_llm_tpu_torch.core.config import InternVideo2Config
    from grounded_video_llm_tpu_torch.models import internvideo2

    cfg = InternVideo2Config(embed_dim=128, depth=2, num_heads=2,
                             mlp_ratio=4.0, image_size=28, patch_size=14,
                             num_frames=2, num_blocks_used=1,
                             layerscale_init=1.0)
    bp, bq = mb_iv2.block_params(cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, cfg.seq_len, 128, generator=g).bfloat16()
    out = {k: f().float() for k, f in
           mb_iv2.block_variants(x, bp, bq, cfg).items()}
    assert list(out) == list(mb_iv2.BLOCKS)
    for name in ("block_w8a8", "block_w8a8_fused"):
        rel = (out[name] - out["block_bf16"]).norm() / out["block_bf16"].norm()
        assert rel < 0.05, (name, rel)
    real = internvideo2.mha
    with mb_iv2.no_attention():
        assert internvideo2.mha is not real
        stubbed = mb_iv2.block_variants(x, bp, bq, cfg)["block_bf16"]()
    assert internvideo2.mha is real
    assert not torch.equal(stubbed.float(), out["block_bf16"])
    h = torch.randn(x.shape[0] * x.shape[1], 512, generator=g).bfloat16()
    legs = mb_iv2.leg_variants(x.reshape(-1, 128), h, bp, bq, cfg)
    assert list(legs) == list(mb_iv2.LEGS)
    for leg, fns in legs.items():
        ref = fns["dot_bf16"]().float()
        w8 = fns["w8a8"]().float()
        assert (w8 - ref).norm() / ref.norm() < 0.05, leg
        assert fns["dot_i8i8"]().dtype == torch.int32
        assert fns["fused"]().shape == ref.shape


@pytest.mark.parametrize("module", [mb_gemm, mb_decode, mb_attn, mb_static,
                                    mb_bwd, mb_iv2, mb_ab])
def test_microbench_mains_refuse_the_cpu(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_microbench_counts_follow_the_modules():
    """The launch counts chip_smoke holds the microbenchmark path to, derived
    from the modules' shapes, variants and repetitions, are the counts an
    H100 run of the six mains gave."""
    from grounded_video_llm_tpu_torch.core.config import vlm_config

    cs = _chip_smoke()
    names = ("flash_fwd", "flash_bwd", "int8_gemv", "int8_matmul",
             "decode_attention_int8", "scatter_write", "i8i8_gemv",
             "flash_variant", "int8_gemm", "int8_gemm_dynamic",
             "fused_norm_quant_gemm", "fused_quant_gemm_ls_residual")
    want = cs.microbench_expect(vlm_config("phi3.5", stage="inference"),
                                dict.fromkeys(names, 0))
    assert want == {"flash_fwd": 325, "flash_bwd": 22, "int8_gemv": 156,
                    "int8_matmul": 156, "decode_attention_int8": 52,
                    "scatter_write": 0, "i8i8_gemv": 156,
                    "flash_variant": 369, "int8_gemm": 42,
                    "int8_gemm_dynamic": 42, "fused_norm_quant_gemm": 54,
                    "fused_quant_gemm_ls_residual": 54}


@pytest.mark.parametrize("scale,rejected", [(1.0, True), (0.1, False)])
def test_chip_smoke_m2_bars_need_unit_normal_inputs(scale, rejected):
    """The wrong softmaxes chip_smoke shows M2's bars (exp2 for exp; no
    rescale of earlier key tiles) read far above the relative bar on unit
    normal q/k/v, and below it on inputs × 0.1, where the softmax is nearly
    uniform: the reason M2 is checked on unit normal inputs."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    q, k, v = ((torch.randn(1, 2, 1025, 88, generator=g) * scale).bfloat16()
               for _ in range(3))
    ref = fa.flash_variant_reference(q, k, v, "full").float()
    for _, y in cs.wrong_softmaxes(torch, q, k, v):
        rel = float(torch.linalg.vector_norm(y.to(q.dtype).float() - ref)
                    / torch.linalg.vector_norm(ref))
        assert (rel > cs.BOUND_O_REL) == rejected, rel
        if rejected:
            assert rel > 20 * cs.BOUND_O_REL


def test_chip_smoke_m2_wrong_rescale_is_right_within_one_key_tile():
    """The no-rescale softmax differs from the right one only across key
    tiles: over one 64-key tile it is the online softmax itself."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 64, 88, generator=g).bfloat16()
               for _ in range(3))
    ref = fa.flash_variant_reference(q, k, v, "full").float()
    _, no_rescale = list(cs.wrong_softmaxes(torch, q, k, v))
    torch.testing.assert_close(no_rescale[1].to(q.dtype).float(), ref,
                               **M2_TOL)
