"""Static W8A8 activation scales of the port against the JAX package on the
CPU: static_int8_matmul and matmul_any's dispatch, the calibration pass
(internvideo2.features_absmax), serve/calibrate (scales, the padded tree,
its refusals), the engine's lazy calibration with greedy tokens equal to
the JAX engine's, serve/quant_ab, and the weight bridge's x_scale leaves.

Tolerances: static_int8_matmul is the same arithmetic op for op (bit-equal).
features_absmax on fp32 weights: rtol 2e-4 (the per-module bar; the
attention's plain versions differ in summation order). On W8A8 weights a
GEMM input that moves by one fp32 ulp across a .5 rounding tie moves one
int8 value, and the chain after it by up to a quantization step: rtol 1e-3,
atol 1e-4, the fused-block bar. The engine runs the widened micro LLM of
tests/test_torch_int8_serving.py (every projection meets the Pallas tiling
of the JAX int8 kernels), and greedy tokens are exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from grounded_video_llm_tpu.core.config import micro_vlm_config, replace
from grounded_video_llm_tpu.models import internvideo2 as jiv2
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.ops import int8_matmul as jmm
from grounded_video_llm_tpu.serve import calibrate as jcal
from grounded_video_llm_tpu.serve import engine as jengine
from grounded_video_llm_tpu.serve import quant_ab as jab
from grounded_video_llm_tpu.serve import quantize as jq
from grounded_video_llm_tpu.text.tokenizer import build_test_tokenizer
from grounded_video_llm_tpu_torch.core.config import GenerateConfig
from grounded_video_llm_tpu_torch.models import internvideo2 as tiv2
from grounded_video_llm_tpu_torch.models import vlm as tvlm
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.models.param_utils import layer_slice
from grounded_video_llm_tpu_torch.ops import int8_matmul as tmm
from grounded_video_llm_tpu_torch.serve import calibrate as tcal
from grounded_video_llm_tpu_torch.serve import quant_ab as tab
from grounded_video_llm_tpu_torch.serve import quantize as tq
from grounded_video_llm_tpu_torch.serve.engine import \
    InferenceEngine as TEngine

MODULE_TOL = dict(rtol=2e-4, atol=1e-6)
W8A8_TOL = dict(rtol=1e-3, atol=1e-4)
FEATURES_REL_L2 = 3e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _clips(vcfg, n=2, seed=3):
    return (np.random.default_rng(seed).normal(
        size=(n, vcfg.num_frames, vcfg.image_size, vcfg.image_size, 3))
        * 0.5).astype(np.float32)


def _uint8_video(cfg, b=1, seed=2):
    return np.random.default_rng(seed).integers(
        0, 256, size=(b, cfg.num_frames, cfg.video.image_size,
                      cfg.video.image_size, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def iv2():
    """The micro IV2 trunk, dense and W8A8, in both packages; and its
    early-exit twin (3 blocks stacked, 2 run)."""
    out = {}
    for name, vcfg in (("full", micro_vlm_config("phi3.5").video),
                       ("early_exit", replace(micro_vlm_config("phi3.5").video,
                                              depth=3))):
        dense = jiv2.init_params(jax.random.key(0), vcfg)
        qj = jq.quantize_video_encoder_for_serving(dense)
        out[name] = (vcfg, dense, qj, _port_iv2(dense), _port_iv2(qj))
    return out


def _port_iv2(tree):
    if isinstance(tree, dict) and {"q", "scale"} <= set(tree):
        xs = tree.get("x_scale")
        return tmm.Int8Weight(torch.from_numpy(np.array(tree["q"])),
                              torch.from_numpy(np.array(tree["scale"])),
                              False, None if xs is None
                              else torch.from_numpy(np.array(xs)))
    if isinstance(tree, dict):
        return {k: _port_iv2(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


# ---------------------------------------------------------------------------
# static_int8_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_int8_matmul_bit_equal_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 40, 128)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(128, 96)) * 0.1).astype(np.float32)
    wq, ws = jmm.quantize_weights_int8(jnp.asarray(w))
    # a scale below the max: some inputs saturate
    xs = np.float32(np.abs(x).max() * 0.8 / 127.0)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = jmm.static_int8_matmul(xj, wq, ws, jnp.asarray(xs))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tmm.static_int8_matmul(xt, torch.from_numpy(np.array(wq)),
                                 torch.from_numpy(np.array(ws)),
                                 torch.tensor(xs))
    assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_static_scale_saturates_at_127():
    """Inputs past the calibrated max clip to ±127: a bounded error, no
    wrap (the JAX package's test, on the port)."""
    x = torch.tensor([[100.0, -100.0, 1.0, 0.0]])
    q, s = tmm.quantize_weights_int8(torch.eye(4))
    got = tmm.static_int8_matmul(x, q, s, torch.tensor(10.0 / 127.0))
    np.testing.assert_allclose(got[0, :2].numpy(), [10.0, -10.0], rtol=0.02)
    np.testing.assert_allclose(float(got[0, 2]), 1.0, rtol=0.05)
    x8 = torch.round(x / (10.0 / 127.0)).clamp(-127, 127)
    assert x8[0, :2].tolist() == [127.0, -127.0]


def test_matmul_any_dispatches_on_x_scale(monkeypatch):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(8, 32)).astype(np.float32))
    q, s = tmm.quantize_weights_int8(torch.from_numpy(
        (rng.normal(size=(32, 16)) * 0.2).astype(np.float32)))
    xs = x.abs().max() / 127.0
    assert torch.equal(tmm.matmul_any(x, tmm.Int8Weight(q, s, False, xs)),
                       tmm.static_int8_matmul(x, q, s, xs))
    assert torch.equal(tmm.matmul_any(x, tmm.Int8Weight(q, s)),
                       tmm.dynamic_int8_matmul(x, q, s))
    w = tmm.Int8Weight(q[None].expand(3, -1, -1), s[None].expand(3, -1),
                       False, torch.tensor([1.0, 2.0, 3.0]))
    assert float(w.layer(2).x_scale) == 3.0
    assert layer_slice({"k": tmm.Int8Weight(q[None], s[None])},
                       0)["k"].x_scale is None


# ---------------------------------------------------------------------------
# The calibration pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", ["full", "early_exit"])
@pytest.mark.parametrize("weights", ["dense", "w8a8"])
def test_features_absmax_matches_jax(iv2, depth, weights):
    vcfg, dense, qj, tdense, tqp = iv2[depth]
    jp, tp = (dense, tdense) if weights == "dense" else (qj, tqp)
    tol = MODULE_TOL if weights == "dense" else W8A8_TOL
    clips = _clips(vcfg)
    xj, sj = jiv2.features_absmax(jp, vcfg, jnp.asarray(clips))
    xt, st = tiv2.features_absmax(tp, vcfg, torch.from_numpy(clips))
    assert set(st) == set(tcal.LEGS)
    for leg in tcal.LEGS:
        want = (vcfg.num_blocks_used,
                vcfg.mlp_hidden if leg == "fc2" else vcfg.embed_dim)
        assert tuple(st[leg].shape) == want
        np.testing.assert_allclose(st[leg].numpy(), np.asarray(sj[leg]),
                                   **tol)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **tol)
    # the calibration pass is the serving forward plus the statistics
    assert torch.equal(xt, tiv2.features(tp, vcfg, torch.from_numpy(clips)))


def test_apply_static_scales_pads_like_jax(iv2):
    vcfg, _, qj, _, tqp = iv2["early_exit"]
    rng = np.random.default_rng(5)
    calib = {leg: np.abs(rng.normal(size=(
        vcfg.num_blocks_used,
        vcfg.mlp_hidden if leg == "fc2" else vcfg.embed_dim))).astype(
            np.float32) for leg in tcal.LEGS}
    for legs in (tcal.DEFAULT_LEGS, tcal.LEGS, ("fc2",)):
        jtree = jcal.apply_static_scales(qj, calib, legs=legs, margin=1.1)
        ttree = tcal.apply_static_scales(tqp, calib, legs=legs, margin=1.1)
        want = _port_iv2(_np(jtree))
        for leg in tcal.LEGS:
            node = "qkv_kernel" if leg == "qkv" else leg
            got_w = (ttree["blocks"][node] if leg == "qkv"
                     else ttree["blocks"][node]["kernel"])
            want_w = (want["blocks"][node] if leg == "qkv"
                      else want["blocks"][node]["kernel"])
            if leg in legs:
                assert tuple(got_w.x_scale.shape) == (vcfg.depth,)
                assert float(got_w.x_scale[-1]) == 1.0        # padded
                assert torch.equal(got_w.x_scale, want_w.x_scale)
            else:
                assert got_w.x_scale is None and want_w.x_scale is None
    # the input tree is not modified
    assert tqp["blocks"]["fc2"]["kernel"].x_scale is None
    np.testing.assert_array_equal(
        tcal.static_scales_from_absmax(calib)["fc2"],
        jcal.static_scales_from_absmax(calib)["fc2"])


def test_apply_static_scales_refuses_unquantized_legs(iv2):
    vcfg, dense, _, tdense, _ = iv2["full"]
    fake = {leg: np.ones((vcfg.num_blocks_used, 8), np.float32)
            for leg in tcal.LEGS}
    with pytest.raises(ValueError, match="not W8A8-quantized"):
        jcal.apply_static_scales(dense, fake)
    with pytest.raises(ValueError, match="not W8A8-quantized"):
        tcal.apply_static_scales(tdense, fake)


def test_fused_switch_refuses_static_scales(iv2, monkeypatch):
    """GVLLM_FUSED_IV2=1 with static scales raises on every device (the JAX
    fused route drops them); with the switch off the static block runs."""
    vcfg, _, _, _, tqp = iv2["full"]
    calib = {leg: np.ones((vcfg.num_blocks_used,
                           vcfg.mlp_hidden if leg == "fc2"
                           else vcfg.embed_dim), np.float32)
             for leg in tcal.LEGS}
    static = tcal.apply_static_scales(tqp, calib)
    bp = layer_slice(static["blocks"], 0)
    monkeypatch.setenv("GVLLM_FUSED_IV2", "1")
    with pytest.raises(ValueError, match="static"):
        tiv2._fused_int8_ok(bp, vcfg)
    monkeypatch.setenv("GVLLM_FUSED_IV2", "0")
    assert not tiv2._fused_int8_ok(bp, vcfg)


# ---------------------------------------------------------------------------
# The VLM: calibrate_and_apply, the engine, the weight bridge, quant_ab
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vlm_model():
    cfg = micro_vlm_config("phi3.5")
    cfg = replace(cfg, llm=replace(cfg.llm, hidden_size=512,
                                   intermediate_size=512, num_heads=8,
                                   num_kv_heads=8, head_dim=64))
    jp = jvlm.init_params(jax.random.key(2), cfg)
    # LayerScale 1 (its init of 1e-5 lets no block move the bf16 residual,
    # so no activation scale could change an output)
    blocks = dict(jp["video_encoder"]["blocks"])
    for name in ("ls1", "ls2"):
        blocks[name] = jnp.ones_like(blocks[name])
    jp = dict(jp, video_encoder=dict(jp["video_encoder"], blocks=blocks))
    fp32 = params_from_jax(_np(jp), cfg, "cpu")
    tok = build_test_tokenizer("phi3.5")
    rng = np.random.default_rng(4)
    spatial = rng.integers(0, 256, (cfg.num_segs, 336, 336, 3),
                           dtype=np.uint8)
    temporal = rng.integers(0, 256, (cfg.num_frames, 224, 224, 3),
                            dtype=np.uint8)
    return cfg, jp, fp32, tok, spatial, temporal


def _j_int8_full(jp):
    out = dict(jp)
    out["llm"] = jq.quantize_llm_for_serving(jp["llm"], w8a8=True)
    out["video_encoder"] = jq.quantize_video_encoder_for_serving(
        jp["video_encoder"])
    out["clip"] = jq.quantize_clip_for_serving(jp["clip"])
    return out


def test_calibrate_and_apply_encode_video_matches_jax(vlm_model):
    cfg, jp, fp32, *_ = vlm_model
    jfull = _j_int8_full(jp)
    tfull = params_from_jax(_np(jfull), cfg, "cpu")
    px = _uint8_video(cfg)
    jstatic = jcal.calibrate_and_apply(jfull, cfg, [px])
    tstatic = tcal.calibrate_and_apply(tfull, cfg, [px])
    for leg in ("fc2", "proj"):
        np.testing.assert_allclose(
            tstatic["video_encoder"]["blocks"][leg]["kernel"].x_scale.numpy(),
            np.asarray(jstatic["video_encoder"]["blocks"][leg]["kernel"]
                       ["x_scale"]), **W8A8_TOL)
    assert tstatic["video_encoder"]["blocks"]["fc1"]["kernel"].x_scale is None
    assert tfull["video_encoder"]["blocks"]["fc2"]["kernel"].x_scale is None
    sp = np.zeros((1, cfg.num_segs, 336, 336, 3), np.uint8)
    fj = np.asarray(jvlm.encode_video(jstatic, cfg, jnp.asarray(sp),
                                      jnp.asarray(px)), np.float64)
    with torch.inference_mode():
        ft = tvlm.encode_video(tstatic, cfg, torch.from_numpy(sp),
                               torch.from_numpy(px)).double().numpy()
    assert np.isfinite(ft).all() and ft.shape == fj.shape
    rel = np.linalg.norm(ft - fj) / np.linalg.norm(fj)
    assert rel <= FEATURES_REL_L2, rel
    with torch.inference_mode():       # the static scales reach the output
        fd = tvlm.encode_video(tfull, cfg, torch.from_numpy(sp),
                               torch.from_numpy(px)).double().numpy()
    assert not np.array_equal(fd, ft)


def test_params_from_jax_carries_x_scale(vlm_model):
    cfg, jp, *_ = vlm_model
    jfull = _j_int8_full(jp)
    n = cfg.video.depth
    calib = {leg: np.full((cfg.video.num_blocks_used,
                           cfg.video.mlp_hidden if leg == "fc2"
                           else cfg.video.embed_dim), 2.0, np.float32)
             for leg in tcal.LEGS}
    jfull["video_encoder"] = jcal.apply_static_scales(
        jfull["video_encoder"], calib, legs=tcal.LEGS)
    tp = params_from_jax(_np(jfull), cfg, "cpu")
    blocks = tp["video_encoder"]["blocks"]
    for w in (blocks["qkv_kernel"], blocks["proj"]["kernel"],
              blocks["fc1"]["kernel"], blocks["fc2"]["kernel"]):
        assert w.x_scale.dtype == torch.float32
        assert tuple(w.x_scale.shape) == (n,)
        np.testing.assert_array_equal(w.x_scale.numpy(), np.full(
            n, np.float32(2.0 / 127.0)))
    assert tp["clip"]["layers"]["q"]["kernel"].x_scale is None
    bad = _np(jfull)
    bad["llm"]["layers"]["qkv_kernel"]["x_scale"] = np.ones(
        cfg.llm.num_layers, np.float32)
    with pytest.raises(ValueError, match="encoders only"):
        params_from_jax(bad, cfg, "cpu")
    bad = _np(jfull)
    bad["video_encoder"]["blocks"]["fc2"]["kernel"]["x_scale"] = np.ones(
        n + 1, np.float32)
    with pytest.raises(ValueError, match="x_scale"):
        params_from_jax(bad, cfg, "cpu")


def test_engine_static_scales_greedy_equals_jax_engine(vlm_model,
                                                       monkeypatch):
    """int8_full + static_scales=True, both engines, 8 greedy tokens: one
    calibration on the first request's pixels, the same scales, the same
    tokens; the int8 cache as the JAX engine runs it."""
    cfg, jp, fp32, tok, spatial, temporal = vlm_model
    prompts = ["<image>\nwhen does it happen?",
               "describe <image> briefly please"]
    captured = {}
    j_gen = jengine.generate_tokens

    def capture(*a, **kw):
        out = j_gen(*a, **kw)
        captured["tokens"] = np.asarray(out[0])
        return out

    monkeypatch.setattr(jengine, "generate_tokens", capture)
    from grounded_video_llm_tpu.core.config import \
        GenerateConfig as JGenerateConfig
    jeng = jengine.InferenceEngine(jp, cfg, tok, quantize="int8_full",
                                   static_scales=True)
    jeng.generate(prompts, temporal, spatial, JGenerateConfig(
        max_new_tokens=8, do_sample=False, quantize_cache=True))
    teng = TEngine(fp32, cfg, tok, quantize="int8_full", static_scales=True)
    assert teng.calibrations == 0
    teng.generate(prompts, temporal, spatial, GenerateConfig(
        max_new_tokens=8, do_sample=False, quantize_cache=True))
    assert teng.calibrations == 1 and teng.last_timings["calibrate"] > 0
    jb = jeng.params["video_encoder"]["blocks"]
    tb = teng.params["video_encoder"]["blocks"]
    for leg in ("fc2", "proj"):
        np.testing.assert_allclose(tb[leg]["kernel"].x_scale.numpy(),
                                   np.asarray(jb[leg]["kernel"]["x_scale"]),
                                   **W8A8_TOL)
    np.testing.assert_array_equal(teng.last_tokens[0].numpy(),
                                  captured["tokens"])
    # calibrated once: the second request keeps the same tree
    scales = tb["fc2"]["kernel"].x_scale
    teng.generate(prompts[:1], temporal, spatial, GenerateConfig(
        max_new_tokens=2, do_sample=False, quantize_cache=True))
    assert teng.calibrations == 1 and "calibrate" not in teng.last_timings
    assert teng.params["video_encoder"]["blocks"]["fc2"]["kernel"].x_scale \
        is scales


def test_prepare_ab_inputs_matches_jax(vlm_model, monkeypatch):
    """Annotation items → the same ids, mask and stacked pixels as the JAX
    helper, through each engine's prompt template and batching (the video
    read is replaced by fixed frames)."""
    cfg, jp, fp32, tok, spatial, temporal = vlm_model
    items = [{"video": "a.mp4", "query": "when does it happen?"},
             {"video": "b.mp4", "question": "what is shown?"}]
    jeng = jengine.InferenceEngine(jp, cfg, tok)
    teng = TEngine(fp32, cfg, tok)
    for eng in (jeng, teng):
        monkeypatch.setattr(eng, "preprocess_video",
                            lambda path: (temporal, spatial, 30.0))
    got = tab.prepare_ab_inputs(teng, items, video_root="/videos")
    want = jab.prepare_ab_inputs(jeng, items, video_root="/videos")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[3].shape == (2, *temporal.shape)


def test_engine_refuses_static_scales_without_int8_full(vlm_model):
    cfg, _, fp32, tok, *_ = vlm_model
    for quantize in (None, "int8"):
        with pytest.raises(ValueError, match="int8_full"):
            TEngine(fp32, cfg, tok, quantize=quantize, static_scales=True)


def test_compare_metrics_equal_jax():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(2, 6, 50)).astype(np.float32)
    b = a + rng.normal(size=a.shape).astype(np.float32) * 0.3
    mask = np.ones((2, 6), np.int32)
    mask[1, :2] = 0
    assert tab.compare_logits(a, b, mask) == jab.compare_logits(a, b, mask)
    ta = np.array([[1, 2, 3, 0], [5, 6, 7, 8], [4, 4, 4, 4]])
    la = np.array([3, 4, 0])
    tb_ = np.array([[1, 2, 3, 0], [5, 9, 7, 8], [4, 4, 1, 1]])
    lb = np.array([3, 4, 4])
    got = tab.compare_greedy(ta, la, tb_, lb)
    assert got == jab.compare_greedy(ta, la, tb_, lb)
    assert got["greedy_exact_rate"] == pytest.approx(1 / 3)
    assert (tab.DEFAULT_MAX_KL, tab.DEFAULT_MIN_TOP1,
            tab.DEFAULT_MIN_GREEDY) == (jab.DEFAULT_MAX_KL,
                                        jab.DEFAULT_MIN_TOP1,
                                        jab.DEFAULT_MIN_GREEDY)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _ab_inputs(cfg, B=2, S=10, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 60, size=(B, S)).astype(np.int64)
    ids[:, 1] = -200
    mask = np.ones((B, S), np.int64)
    spatial = rng.integers(0, 255, size=(B, cfg.num_segs, 336, 336, 3)
                           ).astype(np.uint8)
    temporal = rng.integers(0, 255, size=(B, cfg.num_frames, 224, 224, 3)
                            ).astype(np.uint8)
    return ids, mask, spatial, temporal


def test_run_quant_ab_passes_sound_and_fails_broken_tree():
    """bf16 vs int8_full with static scales passes the committed bar on the
    micro pipeline, as bf16 vs int8_full does in the JAX package's test (same
    config, bf16 weights); a catastrophic lm_head mis-scale fails it."""
    cfg = micro_vlm_config("phi3.5")
    bf16 = _cast(params_from_jax(
        _np(jvlm.init_params(jax.random.key(0), cfg)), cfg, "cpu"),
        torch.bfloat16)
    ids, mask, sp, tp = _ab_inputs(cfg)
    quant = TEngine(bf16, cfg, object(), quantize="int8_full").params
    quant = tcal.calibrate_and_apply(quant, cfg, [tp])
    report = tab.run_quant_ab(bf16, quant, cfg, ids, mask, sp, tp,
                              max_new_tokens=8)
    assert report["pass"], report
    assert report["mean_kl_nats"] < tab.DEFAULT_MAX_KL
    broken = dict(quant, llm=dict(quant["llm"]))
    head = broken["llm"]["lm_head"]
    broken["llm"]["lm_head"] = head._replace(
        scale=torch.full_like(head.scale, 1e-4))
    report = tab.run_quant_ab(bf16, broken, cfg, ids, mask, sp, tp,
                              max_new_tokens=8)
    assert not report["pass"], report


def test_port_quantization_keeps_static_scales_off(vlm_model):
    """Serving quantization alone never sets x_scale: static scales come
    from calibration only."""
    cfg, _, fp32, *_ = vlm_model
    enc = tq.quantize_video_encoder_for_serving(fp32["video_encoder"])
    assert enc["blocks"]["qkv_kernel"].x_scale is None
    assert all(enc["blocks"][n]["kernel"].x_scale is None
               for n in ("proj", "fc1", "fc2"))
