"""The port's step-graph runner (serve/graphs.py) and the in-place loops
that run through it, on the CPU at micro_vlm_config (fp32), where every
step calls the body that the card captures:

  * greedy tokens of the DecodeState loop equal to the JAX package's, for
    the bf16 and the int8 cache (generate_tokens_from_features) and for the
    cascade (generate_tokens_from_prefix, shared_prefix=True), with one
    runner reused across two requests of the same shapes, so the second
    request's state is copied into the first's tensors;
  * decode_steps as the host loop counted them before: a row that stops
    early, and a batch that runs to max_new_tokens;
  * the guard: a body that rebinds a state tensor, and a state tensor
    rebound between steps, raise StateRebound naming the tensor;
  * every state tensor of the decode, speculative, pool chunk (decode and
    speculative) and beam steps keeps its data_ptr() across steps;
  * the runner's bound on the state it keeps;
  * the launch-count bookkeeping on stand-in counters: a capture's changes
    restored, added once per replay.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_llm_tpu.core.config import micro_vlm_config
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.serve import generate as jgen
from grounded_video_llm_tpu.text.templates import IMAGE_TOKEN_INDEX
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.serve import beam as tbeam
from grounded_video_llm_tpu_torch.serve import continuous as tcont
from grounded_video_llm_tpu_torch.serve import generate as tgen
from grounded_video_llm_tpu_torch.serve import graphs as tgraphs
from grounded_video_llm_tpu_torch.serve import speculative as tspec

EOS, PAD = 2, 0
MAX_NEW = 5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run beside the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the JAX tree's init, compiled once (its eager form takes ~3x as long)
_init = jax.jit(jvlm.init_params, static_argnums=1)


@pytest.fixture(scope="module")
def micro():
    cfg = micro_vlm_config("phi3.5")
    jp = _init(jax.random.key(0), cfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _ceil128(n):
    return -(-n // 128) * 128


def _inputs(cfg, B=3, seed=0, pre_len=3, q_len=4):
    """Left-padded prompts sharing a pre-image head: the full prompt and
    its split at the image slot, and one video's features."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(3, 50, size=(pre_len,)).astype(np.int32)
    S = pre_len + 1 + q_len
    ids = np.full((B, S), PAD, np.int32)
    mask = np.zeros((B, S), np.int32)
    post_ids = np.full((B, q_len), PAD, np.int32)
    post_mask = np.zeros((B, q_len), np.int32)
    for b in range(B):
        q = rng.integers(3, 50, size=(q_len - b % 2,)).astype(np.int32)
        row = np.concatenate([pre, [IMAGE_TOKEN_INDEX], q])
        ids[b, S - len(row):] = row
        mask[b, S - len(row):] = 1
        post_ids[b, q_len - len(q):] = q
        post_mask[b, q_len - len(q):] = 1
    feats = (rng.normal(size=(1, cfg.num_video_tokens, cfg.llm.hidden_size))
             * 0.05).astype(np.float32)
    return ids, mask, pre[None], post_ids, post_mask, feats


GREEDY = dict(max_new_tokens=MAX_NEW, temperature=0.0, do_sample=False,
              pad_token_id=PAD)


@pytest.mark.parametrize("quantize_cache", [False, True])
def test_decode_state_loop_matches_jax(micro, quantize_cache):
    cfg, jp, tp = micro
    graphs = tgraphs.StepGraphs()
    for seed in (0, 1):                 # the second copies into the first
        ids, mask, _, _, _, feats = _inputs(cfg, seed=seed)
        fb = np.broadcast_to(feats, (ids.shape[0], *feats.shape[1:]))
        kw = dict(GREEDY, eos_token_id=EOS, quantize_cache=quantize_cache)
        jt, jl = jgen.generate_tokens_from_features(
            jp, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(fb),
            jax.random.key(0), **kw)
        tt, tl = tgen.generate_tokens_from_features(
            tp, cfg, _t(ids).long(), _t(mask).long(), _t(fb), None,
            graphs=graphs, **kw)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert len(graphs.loops()) == 1 and graphs.stats["eager_steps"] > 0


def test_cascade_loop_matches_jax(micro):
    cfg, jp, tp = micro
    graphs = tgraphs.StepGraphs()
    for seed in (2, 3):
        _, _, pre_ids, post_ids, post_mask, feats = _inputs(cfg, seed=seed)
        Sp = pre_ids.shape[1] + cfg.num_video_tokens
        hint = _ceil128(Sp + post_ids.shape[1] + MAX_NEW)
        kw = dict(GREEDY, eos_token_id=EOS, quantize_cache=True,
                  shared_prefix=True)
        jk, jv, jm = jgen.build_prefix_kv(
            jp, cfg, jnp.asarray(pre_ids),
            jnp.ones_like(jnp.asarray(pre_ids)), jnp.asarray(feats), hint)
        jt, jl = jgen.generate_tokens_from_prefix(
            jp, cfg, jnp.asarray(post_ids), jnp.asarray(post_mask), jk, jv,
            jm, jax.random.key(0), **kw)
        prefix = tgen.build_prefix_kv(
            tp, cfg, _t(pre_ids).long(),
            torch.ones(pre_ids.shape, dtype=torch.long), _t(feats), hint)
        tt, tl = tgen.generate_tokens_from_prefix(
            tp, cfg, _t(post_ids).long(), _t(post_mask).long(), *prefix,
            None, graphs=graphs, **kw)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        # the prefix the loop read stays the caller's, unwritten
        assert prefix[2].dtype == torch.long
    assert len(graphs.loops()) == 1


def _first_eos(tokens: np.ndarray, eos: int) -> np.ndarray:
    hit = tokens == eos
    return np.where(hit.any(-1), hit.argmax(-1), 10 ** 9)


@pytest.mark.parametrize("case", ["one_row_stops_early", "runs_to_budget"])
def test_decode_steps_as_before(micro, case):
    """decode_steps: the steps until every row has emitted EOS, at most
    max_new_tokens - 1 (the first token comes from the prefill)."""
    cfg, _, tp = micro
    ids, mask, _, _, _, feats = _inputs(cfg, seed=4)
    if case == "one_row_stops_early":
        ids, mask = ids[:1], mask[:1]
    fb = _t(np.broadcast_to(feats, (ids.shape[0], *feats.shape[1:])))
    args = (tp, cfg, _t(ids).long(), _t(mask).long(), fb, None)
    free, _ = tgen.generate_tokens_from_features(*args, eos_token_id=-2,
                                                 **GREEDY)
    # row 0's third token ends it; the batch case keeps rows that never
    # emit it running to the budget
    eos = int(free[0, 2]) if case == "one_row_stops_early" else -2
    timings = {}
    out, _ = tgen.generate_tokens_from_features(
        *args, eos_token_id=eos, timings=timings, **GREEDY)
    want = min(MAX_NEW - 1, int(_first_eos(out.numpy(), eos).max()))
    assert timings["decode_steps"] == want
    assert want == (2 if case == "one_row_stops_early" else MAX_NEW - 1)


class _Toy(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def test_guard_raises_on_a_rebound_state_tensor():
    graphs = tgraphs.StepGraphs()

    def good(st):
        st.a.add_(1)
        return tgraphs.assign(st, st._replace(b=st.b * 2))

    def broken(st):                      # rebinds a instead of writing it
        return st._replace(a=st.a + 1)

    loop = graphs.loop(("toy",), _Toy(torch.zeros(3), torch.ones(3)), good)
    loop.step()
    loop.step()
    assert loop.state.a.tolist() == [2.0] * 3
    assert loop.state.b.tolist() == [4.0] * 3
    bad = graphs.loop(("toy", "broken"), _Toy(torch.zeros(3), torch.ones(3)),
                      broken)
    with pytest.raises(tgraphs.StateRebound, match="'a'"):
        bad.step()
    # a state tensor whose storage moved between steps
    loop.state.b.set_(torch.zeros(3))
    with pytest.raises(tgraphs.StateRebound, match="'b' before a step"):
        loop.step()


def test_state_tensors_keep_their_storage(micro, monkeypatch):
    """Every state tensor of the decode, speculative, pool chunk and beam
    steps is the same storage after every step."""
    cfg, _, tp = micro
    seen: dict = {}
    eager = tgraphs.StepLoop._eager

    def record(self, i):
        eager(self, i)
        seen.setdefault(self.key[0][0], []).append(
            [(n, t.data_ptr(), tuple(t.shape))
             for n, t in tgraphs.leaves(self.state)])

    monkeypatch.setattr(tgraphs.StepLoop, "_eager", record)
    ids, mask, _, _, _, feats = _inputs(cfg, seed=5)
    fb = _t(np.broadcast_to(feats, (ids.shape[0], *feats.shape[1:])))
    args = (tp, cfg, _t(ids).long(), _t(mask).long(), fb, None)
    kw = dict(GREEDY, eos_token_id=-2)
    tgen.generate_tokens_from_features(*args, quantize_cache=True, **kw)
    tspec.generate_tokens_spec_from_features(*args, draft_len=2, **kw)
    rng = np.random.default_rng(6)
    spatial = _t(rng.normal(size=(1, cfg.num_segs, 336, 336, 3))
                 .astype(np.float32))
    temporal = _t(rng.normal(size=(1, cfg.num_frames, 224, 224, 3))
                  .astype(np.float32))
    tbeam.beam_search_tokens(tp, cfg, _t(ids[:1]).long(), _t(mask[:1]).long(),
                             spatial, temporal, num_beams=2,
                             max_new_tokens=MAX_NEW, eos_token_id=-2,
                             pad_token_id=PAD)
    for spec in (0, 2):
        server = tcont.ContinuousServer(
            tp, cfg, pool_size=2, prompt_len=ids.shape[1],
            max_new_tokens=MAX_NEW + 2, chunk=2, eos_token_id=-2,
            pad_token_id=PAD, spec_draft_len=spec)
        server.serve([tcont.Request(ids[i], mask[i], None, None,
                                    features=torch.from_numpy(feats[0]))
                      for i in range(3)])
        kind = "chunk" + str(spec)
        seen[kind] = seen.pop("chunk")
    assert set(seen) == {"decode", "spec", "beam", "chunk0", "chunk2"}
    for kind, steps in seen.items():
        assert len(steps) >= 2, kind
        for s in steps[1:]:
            assert s == steps[0], kind


def test_runner_bounds_its_kept_state():
    """An engine's runner keeps at most max_state_bytes of state (least
    recently used out); a state above that alone serves its call and is not
    kept; a pool's runner (no bound) keeps MAX_ENTRIES keys."""
    def toy(n):                           # 2 * 4 n bytes
        return _Toy(torch.zeros(n), torch.zeros(n))

    graphs = tgraphs.StepGraphs(max_state_bytes=96)
    for key, n in (("a", 4), ("b", 4), ("c", 8)):
        graphs.loop((key,), toy(n), lambda st: st)
    assert [lp.key[0] for lp in graphs.loops()] == [("b",), ("c",)]
    big = graphs.loop(("big",), toy(16), lambda st: st)
    big.step()
    assert [lp.key[0] for lp in graphs.loops()] == [("b",), ("c",)]
    pool = tgraphs.StepGraphs(max_state_bytes=None)
    for i in range(tgraphs.StepGraphs.MAX_ENTRIES + 2):
        pool.loop((i,), toy(64), lambda st: st)
    assert len(pool.loops()) == tgraphs.StepGraphs.MAX_ENTRIES


def test_launch_book_adds_a_capture_once_per_replay():
    class Counter:
        def __init__(self):
            self.launches = 0

    k3, k4 = Counter(), Counter()
    book = tgraphs.LaunchBook([k3, k4])

    def capture():                       # what a captured step counts
        k3.launches += 5
        k4.launches += 2

    k3.launches = 7
    delta = book.measure(capture)
    assert delta == (5, 2) and (k3.launches, k4.launches) == (7, 0)

    # a captured entry: replays through a stand-in graph add the change
    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    graphs = tgraphs.StepGraphs(counters=[k3, k4])
    loop = graphs.loop(("toy",), _Toy(torch.zeros(1), torch.zeros(1)),
                       lambda st: st)
    loop.cuda = True                     # as a card's entry, captured
    loop.warm.add(0)
    loop.graphs[0], loop.deltas[0] = Graph(), delta
    for _ in range(3):
        loop.step()
    assert Graph.replays == 3 and graphs.stats["replays"] == 3
    assert (k3.launches, k4.launches) == (7 + 15, 6)
    with graphs.eager():                 # the switch: the body, no replay
        loop.step()
    assert Graph.replays == 3 and (k3.launches, k4.launches) == (22, 6)
