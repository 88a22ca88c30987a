"""obs/profiler, cli/phase_profile's build_stages and the device route of
ops/preprocess on the CPU, against the JAX package where it has the same
function.

- PhaseTimer: summary() and report() equal to JAX's under the same clock.
- sync: nothing for None, CPU tensors or trees of them.
- device_trace: a Chrome trace file that names an annotate region.
- build_stages: every stage once at micro size, B = 2, int8_full (the int8
  cache) and bf16.
- preprocess_frames_device / dual_stream_preprocess_device against JAX's
  preprocess_frames_xla / dual_stream_preprocess_xla, fp32 out, downscale
  and upscale. Op by op (jax.disable_jit) the bar is rtol 1e-5 with an atol
  of 2e-6 for outputs near 0 (the outputs span about ±2.6; measured 1.3e-6
  at most). Jitted, XLA's CPU compiler folds the resampling kernel's
  constants into its distance computation and moves JAX's own weights by
  up to 9e-6, so the jitted function is held at atol 2e-4 (measured 9.3e-5
  at most).
"""

import glob
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_llm_tpu.obs import profiler as jprof
from grounded_video_llm_tpu.ops import preprocess as jpre
from grounded_video_llm_tpu_torch.cli import phase_profile as pp
from grounded_video_llm_tpu_torch.core.config import micro_vlm_config
from grounded_video_llm_tpu_torch.obs import profiler as tprof
from grounded_video_llm_tpu_torch.ops import preprocess as tpre


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run beside the other test workers,
    where torch's default of one thread per core oversubscribes the
    machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_phases(mod, monkeypatch):
    ticks = iter(np.arange(0.0, 100.0, 0.125).tolist())
    monkeypatch.setattr(time, "time", lambda: next(ticks))
    timer = mod.PhaseTimer()
    for name in ("decode", "encode", "decode", "prefill", "encode",
                 "decode"):
        with timer.phase(name):
            pass
    return timer.summary(), timer.report()


def test_phase_timer_equals_jax(monkeypatch):
    got = _run_phases(tprof, monkeypatch)
    want = _run_phases(jprof, monkeypatch)
    assert got == want
    assert got[0]["decode"]["count"] == 3


def test_sync_is_a_no_op_off_the_card(monkeypatch):
    def fail(*_):
        raise AssertionError("no CUDA device to synchronise")

    monkeypatch.setattr(torch.cuda, "synchronize", fail)
    x = torch.ones(3)
    for tree in (None, x, {"a": [x, (x, None)], "b": 1.0}, []):
        tprof.sync(tree)
    timer = tprof.PhaseTimer()
    with timer.phase("host", barrier_on={"x": x}):
        pass
    assert timer.counts["host"] == 1


def test_device_trace_names_the_annotated_region(tmp_path):
    with tprof.device_trace(str(tmp_path)) as log_dir:
        with tprof.annotate("gvllm_region"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    assert log_dir == str(tmp_path)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "gvllm_region" for e in events)
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.mark.parametrize("quantize", ["int8_full", "bf16"])
def test_build_stages_runs_every_stage(quantize):
    cfg = micro_vlm_config("phi3.5")
    params = pp.build_tree(cfg, quantize, "cpu", torch.float32)
    B = 2
    with torch.inference_mode():
        stages = pp.build_stages(params, cfg, B)
        assert [s.name for s in stages] == list(pp.STAGES)
        out = {s.name: s.fn() for s in stages}
        walls = pp.time_stages(stages[-1:], warm=0, repeats=1)
    clips = B * cfg.num_segs
    V = cfg.llm.padded_vocab_size
    assert out["internvideo2"].shape[0] == clips
    assert out["clip"].shape[0] == clips
    assert tuple(out["encode"].shape) == (B, cfg.num_video_tokens,
                                          cfg.llm.hidden_size)
    logits, cache = out["prefill"]
    assert tuple(logits.shape) == (B, V)
    S = pp.PROMPT_TOKENS - 1 + cfg.num_video_tokens
    assert cache.max_len == S + pp.CACHE_MARGIN
    assert isinstance(cache, pp.llm.QuantKVCache) is (quantize != "bf16")
    assert tuple(out["decode"].shape) == (B, V)
    assert all(bool(torch.isfinite(t).all()) for t in
               (out["encode"], logits, out["decode"]))
    assert len(walls) == 1 and walls[0] > 0
    assert stages[-1].per == pp.DECODE_STEPS


def test_build_stages_and_main_refusals():
    cfg = micro_vlm_config("phi3.5")
    params = pp.build_tree(cfg, "bf16", "cpu", torch.float32)
    with pytest.raises(ValueError, match="unknown stages"):
        pp.build_stages(params, cfg, 1, ["encode", "vision"])
    with pytest.raises(ValueError, match="int4"):
        pp.build_tree(cfg, "int4", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            pp.main([])


# (frames shape, size): a downscale (240x320 to 224, long edge 298), an
# upscale (100x130 to 224) and a wide frame whose short edge is already the
# size (only the width is resampled)
CASES = (((2, 240, 320, 3), 224), ((2, 100, 130, 3), 224),
         ((2, 224, 400, 3), 224))


@pytest.mark.parametrize("shape,size", CASES,
                         ids=["down", "up", "width-only"])
def test_device_preprocess_matches_jax(shape, size):
    f = np.random.default_rng(size + shape[1]).integers(0, 256, shape,
                                                        np.uint8)
    got = tpre.preprocess_frames_device(
        torch.from_numpy(f), size, tpre.INTERNVIDEO_MEAN, tpre.INTERNVIDEO_STD,
        torch.float32).numpy()
    args = (jnp.asarray(f), size, jpre.INTERNVIDEO_MEAN, jpre.INTERNVIDEO_STD,
            jnp.float32)
    with jax.disable_jit():
        eager = np.asarray(jpre.preprocess_frames_xla(*args))
    np.testing.assert_allclose(got, eager, rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(got, np.asarray(
        jpre.preprocess_frames_xla(*args)), rtol=0, atol=2e-4)


def test_dual_stream_device_matches_jax():
    """Four 240x320 frames: the temporal stream downscales them to 224, the
    spatial one upscales its two to 336."""
    cfg = micro_vlm_config("phi3.5")
    f = np.random.default_rng(1).integers(0, 256, (4, 240, 320, 3), np.uint8)
    got = tpre.dual_stream_preprocess_device(torch.from_numpy(f),
                                             cfg.num_segs,
                                             out_dtype=torch.float32)
    with jax.disable_jit():
        want = jpre.dual_stream_preprocess_xla(jnp.asarray(f), cfg.num_segs,
                                               out_dtype=jnp.float32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=2e-6)
    bf16 = tpre.dual_stream_preprocess_device(torch.from_numpy(f),
                                              cfg.num_segs)
    assert all(t.dtype == torch.bfloat16 for t in bf16)
    assert tuple(bf16[1].shape) == (cfg.num_segs, 336, 336, 3)
