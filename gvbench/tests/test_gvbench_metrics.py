"""The metric arithmetic against numbers worked out by hand."""

import pytest

from gvbench import harness
from gvbench.drivers import serve
from gvbench.trace import DeviceTrace

TINY = {
    "num_segs": 1, "num_frames": 2,
    "fusion": {"pool_side": 1},
    "clip": {"hidden_size": 4, "intermediate_size": 8, "num_layers": 3,
             "num_heads": 2, "image_size": 28, "patch_size": 14,
             "feature_layer": -2},
    "video": {"embed_dim": 4, "mlp_ratio": 2.0, "num_heads": 1,
              "num_frames": 2, "image_size": 14, "patch_size": 14,
              "num_blocks_used": 1},
    "llm": {"hidden_size": 4, "intermediate_size": 8, "num_layers": 1,
            "num_heads": 2, "num_kv_heads": 2, "head_dim": 2,
            "vocab_size": 10, "num_extra_tokens": 0},
}


def ctx(done=(), spans=(), trace=None, prefix_cache=False, t=(0.0, 2.0)):
    return harness.Context(TINY, {"server": {"prefix_cache": prefix_cache}},
                           t[0], t[1], list(spans), {}, list(done), trace)


def test_p90_is_nearest_rank_over_all_requests():
    assert serve.p90(list(range(1, 11))) == 9
    assert serve.p90([5.0]) == 5.0
    assert serve.p90(list(range(100, 0, -1))) == 90


def test_rate_and_tail_over_the_window():
    run = serve.ServeRun.__new__(serve.ServeRun)
    run.t_start, run.t_end = 10.0, 20.0
    run.records = ([{"t0": 10.0 + i, "t1": 11.0 + i + 0.1 * i, "tokens": [1]}
                    for i in range(9)]
                   + [{"t0": 19.5, "t1": 20.5, "tokens": [1]},
                      {"t0": 12.0, "t1": 13.0, "error": "x"}])
    e2e = run.end_to_end()
    assert e2e["requests_per_s"] == pytest.approx(0.9)
    # latencies 1.0 .. 1.8; nearest rank ceil(0.9 * 9) = 9th → 1.8
    assert e2e["latency_p90_s"] == pytest.approx(1.8)


def test_llm_flops_by_hand():
    m = harness.reader("mfu.serve")
    c = TINY["llm"]
    assert m.llm_linear(c) == 2 * (4 * 12 + 4 * 4 + 4 * 16 + 8 * 4)   # 320
    assert m.lm_head(c) == 80
    assert m.attn_pair(c) == 16
    assert m.prefill(c, 3) == 3 * 320 + 16 * 6 + 80                  # 1136
    assert m.decode(c, 3, 3) == 2 * (320 + 80) + 16 * (6 + 3)       # 944
    assert m.prefill_after(c, 5, 2) == 2 * 320 + 16 * (10 + 3) + 80
    assert m.decode(c, 3, 1) == 0


def test_encode_flops_by_hand():
    m = harness.reader("mfu.serve")
    # CLIP: 4 patches (S 5), 2 layers used: patches 2*588*4*4 = 18816;
    # a layer 5*2*(64 + 64) + 4*4*25 = 1680
    clip = 18816 + 2 * 1680
    # InternVideo2: 1 patch a frame, 2 frames (S 3), 1 block:
    # 2*588*4*2 = 9408; 3*2*(48 + 16 + 64) + 4*4*9 = 912
    iv2 = 9408 + 912
    # mm projector on 1*1*2 + 1 tokens: 3*2*(64 + 16); video projector on
    # 2 tokens: 2*2*(16 + 16)
    proj = 3 * 2 * 80 + 2 * 2 * 32
    assert m.video_tokens(TINY) == 1 * (1 * 2 + 2 + 1)
    assert m.encode(TINY) == clip + iv2 + proj


def test_mfu_over_the_window():
    m = harness.reader("mfu.serve")
    done = [{"pre": 1, "post": 1, "served": 3, "t0": 0, "t1": 1}]
    c = ctx(done, spans=[("encode", 0.0, 0.5), ("encode", 1.0, 2.5)])
    n = 1 + 5 + 1
    flops = m.encode(TINY) + m.prefill(TINY["llm"], n) + m.decode(
        TINY["llm"], n, 3)
    assert m.read(c) == pytest.approx(100 * flops / (2.0 * 989e12))
    assert m.read(ctx()) is None


def test_roofline_by_hand():
    m = harness.reader("attn_fwd_roofline")
    name = "void flash_fwd_kernel<2, false, 0>(Params)"
    assert m.instantiation(name) == (2, False)
    assert m.instantiation("_Z16flash_fwd_kernelILi96ELb1ELi0EEvv") == (96,
                                                                        True)
    assert m.instantiation("decode_attention_kernel") is None
    # CLIP at head dim 2: S 5, 2 heads, 1 segment: 4*2*2*25 = 400 FLOPs,
    # 2*2*(2*5*2 + 2*5*2) = 160 bytes: bound by bytes, 160 / 3.35e12 s;
    # one launch of 1000 ns; the other kernel is not the attention's
    least = max(400 / 989e12, 160 / 3.35e12)
    assert least == 160 / 3.35e12
    trace = DeviceTrace(0, 10_000, [(name, 1000, 2000),
                                    ("other_kernel", 2000, 9000)])
    assert m.least_times(ctx())[(2, False)] == pytest.approx(least)
    assert m.read(ctx(trace=trace)) == pytest.approx(100 * least / 1e-6)
    assert m.read(ctx(trace=DeviceTrace(0, 10, []))) is None


def test_trace_busy_idle_and_gaps():
    tr = DeviceTrace(0, 100, [("a", 10, 30), ("b", 20, 40), ("a", 60, 70),
                              ("c", 95, 120)],
                     [("resize", 40, 60), ("encode", 44, 49)])
    assert tr.busy_s == pytest.approx(45e-9)
    assert tr.gaps() == [(0, 10), (40, 60), (70, 95)]
    assert tr.top_gaps(2) == [["none", 25e-9], ["resize", 20e-9]]
    assert tr.top_ops(1) == [["a", 30e-9]]
    idle = harness.reader("idle_share.serve")
    assert idle.read(ctx(trace=tr)) == pytest.approx(55.0)
