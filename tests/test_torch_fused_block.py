"""K10, the fused W8A8 InternVideo2-block GEMMs, against the JAX package on
the CPU: the plain versions against fused_norm_quant_gemm (epilogues none,
gelu with bias, qk_norm) and fused_quant_gemm_ls_residual in interpret mode,
and the port's fused block and trunk against JAX's with GVLLM_FUSED_IV2=1.

Tolerances: the dot is exact on both sides and the activations quantize to
the same int8 values on these inputs, so what is left is fp32 arithmetic
in another order (the norm's sum, rsqrt against the reciprocal of sqrt):
rtol 1e-5, atol 1e-5 for the GEMMs on fp32 inputs. The block and the trunk
chain four GEMMs and the attention, where one int8 element moved at a .5
tie shifts an output by a quantization step: rtol 1e-3, atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_llm_tpu.core.config import InternVideo2Config
from grounded_video_llm_tpu.models import internvideo2 as jiv2
from grounded_video_llm_tpu.ops import fused_block as jfb
from grounded_video_llm_tpu.ops.int8_matmul import quantize_weights_int8
from grounded_video_llm_tpu.serve.quantize import \
    quantize_video_encoder_for_serving as j_quantize_iv2
from grounded_video_llm_tpu_torch.models import internvideo2 as tiv2
from grounded_video_llm_tpu_torch.models.param_utils import layer_slice
from grounded_video_llm_tpu_torch.ops import fused_block as tfb
from grounded_video_llm_tpu_torch.ops.int8_matmul import Int8Weight
from grounded_video_llm_tpu_torch.serve.quantize import \
    quantize_video_encoder_for_serving as t_quantize_iv2

EPS = 1e-6
GEMM_TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-3, atol=1e-4)


def _weight(d_in, d_out, seed):
    w = np.random.default_rng(seed).normal(size=(d_in, d_out)) * 0.1
    wq, ws = quantize_weights_int8(jnp.asarray(w, jnp.float32))
    return wq, ws, Int8Weight(torch.from_numpy(np.array(wq)),
                              torch.from_numpy(np.array(ws)))


def _vec(rng, n, scale=0.1, shift=0.0):
    return (rng.normal(size=n) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("epilogue,O", [("none", 256), ("gelu", 512),
                                        ("qk_norm", 384)])
def test_fused_norm_quant_gemm_matches_jax(epilogue, O):
    rng = np.random.default_rng(O)
    M, D = 40, 128
    x = rng.normal(size=(M, D)).astype(np.float32)
    nw = _vec(rng, D, 0.1, 1.0)
    bias = _vec(rng, O) if epilogue == "gelu" else None
    qn = _vec(rng, (2, D), 0.1, 1.0)
    wq, ws, tw = _weight(D, O, O + 1)
    yj = jfb.fused_norm_quant_gemm(
        jnp.asarray(x), jnp.asarray(nw), wq, ws, eps=EPS, epilogue=epilogue,
        bias=None if bias is None else jnp.asarray(bias),
        qk_norm_w=jnp.asarray(qn), block_o=128)
    before = tfb.FUSED_NORM_QUANT_GEMM.launches
    yt = tfb.fused_norm_quant_gemm(
        torch.from_numpy(x), torch.from_numpy(nw), tw, eps=EPS,
        epilogue=epilogue,
        bias=None if bias is None else torch.from_numpy(bias),
        qk_norm_w=torch.from_numpy(qn))
    assert tfb.FUSED_NORM_QUANT_GEMM.launches == before
    assert yt.dtype == torch.float32 and tuple(yt.shape) == (M, O)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **GEMM_TOL)
    # the plain version quantizes exactly what the JAX kernel does
    x8, xs = tfb.norm_quant(torch.from_numpy(x), torch.from_numpy(nw), EPS)
    j8, js = jfb._norm_quant(jnp.asarray(x), jnp.asarray(nw), EPS)
    np.testing.assert_array_equal(x8.numpy(), np.asarray(j8))
    np.testing.assert_allclose(xs.numpy(), np.asarray(js), rtol=1e-6)


def test_fused_quant_gemm_ls_residual_matches_jax():
    rng = np.random.default_rng(3)
    M, D, O = 16, 256, 128
    x = rng.normal(size=(2, M // 2, D)).astype(np.float32)
    bias, ls = _vec(rng, O), _vec(rng, O, 0.01)
    res = rng.normal(size=(2, M // 2, O)).astype(np.float32)
    wq, ws, tw = _weight(D, O, 4)
    yj = jfb.fused_quant_gemm_ls_residual(jnp.asarray(x), wq, ws,
                                          jnp.asarray(bias), jnp.asarray(ls),
                                          jnp.asarray(res), block_o=128)
    before = tfb.FUSED_QUANT_GEMM_LS_RESIDUAL.launches
    yt = tfb.fused_quant_gemm_ls_residual(
        torch.from_numpy(x), tw, torch.from_numpy(bias), torch.from_numpy(ls),
        torch.from_numpy(res))
    assert tfb.FUSED_QUANT_GEMM_LS_RESIDUAL.launches == before
    assert tuple(yt.shape) == (2, M // 2, O)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **GEMM_TOL)


def test_erf_rational_matches_jax_and_erf():
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    got = tfb.erf_rational(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfb._erf(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    # A&S 7.1.26: |error| <= 1.5e-7, plus fp32 rounding of the polynomial
    np.testing.assert_allclose(got, torch.erf(torch.from_numpy(x)).numpy(),
                               atol=5e-7)


def _aligned_cfg():
    # the aligned config of the JAX package's tests/test_fused_block.py
    return InternVideo2Config(
        embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0,
        image_size=28, patch_size=14, num_frames=2, num_blocks_used=2)


def _to_port(tree):
    """The JAX IV2 tree (quantized pairs {"q", "scale"}) as the port's."""
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return Int8Weight(torch.from_numpy(np.array(tree["q"])),
                          torch.from_numpy(np.array(tree["scale"])))
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


@pytest.fixture(scope="module")
def iv2():
    cfg = _aligned_cfg()
    params = jiv2.init_params(jax.random.key(0), cfg)
    qparams = j_quantize_iv2(params)
    return cfg, params, qparams, _to_port(qparams)


def test_port_quantization_gives_the_same_tree(iv2):
    _, params, _, tq = iv2
    ours = t_quantize_iv2(_to_port(params))
    for name in ("qkv_kernel",):
        assert torch.equal(ours["blocks"][name].q, tq["blocks"][name].q)
    for name in ("proj", "fc1", "fc2"):
        assert torch.equal(ours["blocks"][name]["kernel"].q,
                           tq["blocks"][name]["kernel"].q)
        assert torch.equal(ours["blocks"][name]["kernel"].scale,
                           tq["blocks"][name]["kernel"].scale)


def test_fused_block_matches_jax(iv2, monkeypatch):
    monkeypatch.setenv("GVLLM_FUSED_IV2", "1")
    cfg, _, jq, tq = iv2
    jbp = jax.tree_util.tree_map(lambda a: a[0], jq["blocks"])
    tbp = layer_slice(tq["blocks"], 0)
    assert jiv2._fused_int8_ok(jbp, cfg) and tiv2._fused_int8_ok(tbp, cfg)
    x = np.random.default_rng(4).normal(size=(2, 16, cfg.embed_dim)).astype(
        np.float32)
    calls = []
    fused = tiv2._block_fused_int8
    monkeypatch.setattr(tiv2, "_block_fused_int8",
                        lambda *a: calls.append(1) or fused(*a))
    before = (tfb.FUSED_NORM_QUANT_GEMM.launches,
              tfb.FUSED_QUANT_GEMM_LS_RESIDUAL.launches)
    got = tiv2._block(torch.from_numpy(x), tbp, cfg)
    want = jiv2._block(jnp.asarray(x), jbp, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    assert calls == [1]
    assert (tfb.FUSED_NORM_QUANT_GEMM.launches,
            tfb.FUSED_QUANT_GEMM_LS_RESIDUAL.launches) == before
    # the switch off: the port's unfused W8A8 block, as before this slice
    monkeypatch.setenv("GVLLM_FUSED_IV2", "0")
    assert not tiv2._fused_int8_ok(tbp, cfg)
    unfused = tiv2._block(torch.from_numpy(x), tbp, cfg)
    want_unfused = jiv2._block(jnp.asarray(x), jbp, cfg)
    np.testing.assert_allclose(unfused.numpy(), np.asarray(want_unfused),
                               **BLOCK_TOL)
    assert calls == [1]


def test_fused_features_match_jax(iv2, monkeypatch):
    monkeypatch.setenv("GVLLM_FUSED_IV2", "1")
    cfg, params, jq, tq = iv2
    pixels = np.asarray(jax.random.normal(
        jax.random.key(1), (1, cfg.num_frames, cfg.image_size,
                            cfg.image_size, 3), jnp.float32)) * 0.5
    got = tiv2.features(tq, cfg, torch.from_numpy(pixels))
    want = jiv2.features(jq, cfg, jnp.asarray(pixels))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    ref = np.asarray(jiv2.features(params, cfg, jnp.asarray(pixels)))
    g = got.numpy().ravel()
    cos = float(g @ ref.ravel() / (np.linalg.norm(g) * np.linalg.norm(ref)))
    assert cos > 0.995, cos


def test_dense_blocks_never_take_the_fused_path(iv2, monkeypatch):
    monkeypatch.setenv("GVLLM_FUSED_IV2", "1")
    cfg, params, _, _ = iv2
    dense = _to_port(jax.tree_util.tree_map(lambda a: a[0], params["blocks"]))
    assert not tiv2._fused_int8_ok(dense, cfg)
    odd = InternVideo2Config(embed_dim=96, depth=1, num_heads=2,
                             mlp_ratio=4.0, image_size=28, patch_size=14,
                             num_frames=2, num_blocks_used=1)
    q = t_quantize_iv2({"blocks": {
        "qkv_kernel": torch.zeros(1, 96, 288),
        "proj": {"kernel": torch.zeros(1, 96, 96)},
        "fc1": {"kernel": torch.zeros(1, 96, 384)},
        "fc2": {"kernel": torch.zeros(1, 384, 96)}}})["blocks"]
    assert not tiv2._fused_int8_ok({"qkv_kernel": q["qkv_kernel"].layer(0)},
                                   odd)
