"""Each cell end to end on the CPU at the program's micro sizes, through
its plain paths; the check against the reference; the faults the check
must catch; the imports the benchmark must not hold."""

import subprocess
import sys
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from gvbench import check, harness
from gvbench.drivers import serve
from gvbench.reference import resize as ref_resize
from gvbench.reference.vlm import grounding_prompt_ids
from gvbench.tests.util import micro_config, small_mix

BENCH = harness.benchmark()
CELLS = [w for w in BENCH["workloads"]]
SEED = 2 ** 31 + 17


def run_cell(cell, trace=False, seconds=2.0, limits=None):
    conf = micro_config(harness.config(cell["config"]))
    mix = small_mix(harness.traffic(cell["traffic"]))
    torch.set_num_threads(2)
    return serve.run_cell(cell, conf, mix, SEED, seconds, trace, "cpu",
                          __import__("time").perf_counter(), BENCH,
                          limits or harness.limits(cell["name"]),
                          log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_cell_dry_run(cell):
    res = run_cell(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    names = {m["name"] for m in harness.metrics_of(cell["name"],
                                                   "end_to_end", BENCH)}
    assert set(res["metrics"]) == names
    assert list(res)[-1] == "checks"
    assert res["checks"]["max_logit_gap"]["value"] <= 1e-3


@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_cell_traced_dry_run(cell):
    res = run_cell(cell, trace=True)
    assert res["correct"]
    got = set(res["metrics"])
    # no device here: the trace's readers find nothing or only idle time
    assert {"submit_ms.serve", "admit_ms.serve", "mfu.serve"} <= got
    assert "attn_fwd_roofline" not in got
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def test_altered_token_fails_the_check():
    """A token altered where it is produced: the pool's sampler gives the
    next id after its argmax."""
    from grounded_video_llm_tpu_torch.serve import continuous

    sample = continuous.sample_logits

    def off_by_one(logits, *a, **k):
        return (sample(logits, *a, **k) + 1) % logits.shape[-1]

    cell = CELLS[0]
    with patched(continuous, "sample_logits", off_by_one):
        res = run_cell(cell)
    assert not res["correct"]
    gap = res["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"]


def test_unchanged_state_fails_the_check():
    """A decode step that returns the pool's state unchanged: every step of
    a chunk emits the row's last token again."""
    from grounded_video_llm_tpu_torch.serve import continuous

    def frozen_chunk(params, cs, cfg, *, chunk, **k):
        cs.toks.copy_(cs.pool.cur_token[:, None].expand(-1, chunk))
        return cs

    with patched(continuous, "_decode_chunk", frozen_chunk):
        res = run_cell(CELLS[0])
    assert not res["correct"]


@pytest.mark.parametrize("h,w", [(240, 320), (480, 640)])
def test_reference_resize_is_the_programs(h, w):
    """At a small size and at the mixes' own frame size."""
    from grounded_video_llm_tpu_torch.ops.preprocess import \
        dual_stream_resize_host

    frames = np.random.default_rng(0).integers(0, 256, (8, h, w, 3),
                                               dtype=np.uint8)
    want = dual_stream_resize_host(frames, 2)
    got = ref_resize.dual_stream(torch.from_numpy(frames), 2)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)


def test_reference_prompt_is_the_programs():
    from grounded_video_llm_tpu_torch.core.config import vlm_config
    from grounded_video_llm_tpu_torch.serve.engine import InferenceEngine
    from grounded_video_llm_tpu_torch.text.tokenizer import (
        build_test_tokenizer, tokenize_with_image)

    for cell in CELLS:
        conf = harness.config(cell["config"])
        mix = harness.traffic(cell["traffic"])
        eng = InferenceEngine.__new__(InferenceEngine)
        eng.cfg = vlm_config(conf["llm_name"], stage=conf["stage"])
        from grounded_video_llm_tpu_torch.text.templates import get_template
        eng.template = get_template(conf["llm_name"])
        tok = build_test_tokenizer(conf["llm_name"])
        for q in mix["questions"]:
            ids = tokenize_with_image(eng.build_prompt(q, mix["mode"], 30.0),
                                      tok)
            assert ids == grounding_prompt_ids(conf, q)
            assert len(ids) <= mix["server"]["prompt_len"]


def test_check_sample_holds_the_longest():
    served = [check.Served(None, "q", [1] * n) for n in (3, 9, 2, 9, 5, 1)]
    for seed in range(5):
        idx = check.sample(served, 3, seed)
        assert 1 in idx and len(idx) == 3
    assert check.sample(served, 3, 7) == check.sample(served, 3, 7)


def test_control_reads_above_the_program_at_micro_size():
    """The fp8 control reads a wider gap than the served tokens on the
    same requests (the card's readings at full size set the limit)."""
    cell = CELLS[0]
    conf = micro_config(harness.config(cell["config"]))
    mix = small_mix(harness.traffic(cell["traffic"]))
    torch.set_num_threads(2)
    run = serve.ServeRun(conf, mix, SEED, "cpu", log=lambda *a: None)
    try:
        run.setup()
        run.window(2.0, False)
        run.free_program()
        r = run.check(control=True)
    finally:
        run.close()
    assert r["tokens"] > 0
    assert r["control_gap"] > r["gap"]


def test_no_jax_in_the_benchmark():
    code = ("import sys; import gvbench.run, gvbench.harness, gvbench.check, "
            "gvbench.reference.vlm, gvbench.reference.resize, "
            "gvbench.drivers.serve, gvbench.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(harness.ROOT), check=True).stdout
    tops = eval(out)
    assert not set(tops) & set(harness.FORBIDDEN)
    code = ("import sys; import gvbench.reference.vlm, "
            "gvbench.reference.resize, gvbench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True,
                         cwd=str(harness.ROOT), check=True).stdout
    tops = eval(out)
    assert "grounded_video_llm_tpu_torch" not in tops
    assert not set(tops) & set(harness.FORBIDDEN)


def test_bf16_cache_route_reads_like_the_pool_at_micro_size():
    """control.py's second route: the sampled requests served again on the
    engine's lockstep bf16-cache route, as long as the pool served them,
    and read by the same check."""
    from gvbench.control import bf16_cache_served

    cell = CELLS[0]
    conf = micro_config(harness.config(cell["config"]))
    mix = small_mix(harness.traffic(cell["traffic"]))
    torch.set_num_threads(2)
    run = serve.ServeRun(conf, mix, SEED, "cpu", log=lambda *a: None)
    try:
        run.setup()
        run.window(2.0, False)
        again = bf16_cache_served(run)
        run.free_program()
        pool, lockstep = run.check(), run.check(requests=again)
    finally:
        run.close()
    assert [len(s.tokens) for s in again] == \
        [len(s.tokens) for s in run.sampled()]
    assert lockstep["tokens"] == pool["tokens"] > 0
    assert lockstep["gap"] <= 1e-3
