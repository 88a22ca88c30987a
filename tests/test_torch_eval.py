"""The port's evaluation runners against the JAX package on the CPU: the
metric arithmetic, answer parsers, annotation loaders and captioning
scorers (serve/eval.py, serve/captioning.py) equal to JAX's on the same
inputs; eval_grounding, eval_multiple_choice, eval_gqa and
eval_dense_captioning through both engines on the same bridged weights
(micro_vlm_config, fp32, greedy) with preprocess_video stubbed to the same
frames, the metric dicts and every item's text equal; _run_items' routing
(the mirrors of the JAX tests); the quant A/B's sequential memory protocol;
and cli/eval.py (the weights gate, a --debug_tiny grounding run on a cv2
mp4, the --static_scales refusal, --quantize_ab).

Tolerance: none. Every comparison is exact (the scorers are the same
float64 arithmetic in the same order; greedy tokens are equal).
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
from hypothesis import given, settings
from hypothesis import strategies as st

from grounded_video_llm_tpu.core.config import GenerateConfig as JGen
from grounded_video_llm_tpu.core.config import micro_vlm_config
from grounded_video_llm_tpu.models import vlm as jvlm
from grounded_video_llm_tpu.serve import captioning as jcap
from grounded_video_llm_tpu.serve import engine as jengine
from grounded_video_llm_tpu.serve import eval as jeval
from grounded_video_llm_tpu.text.tokenizer import build_test_tokenizer
from grounded_video_llm_tpu_torch.cli import eval as tcli
from grounded_video_llm_tpu_torch.core.config import GenerateConfig as TGen
from grounded_video_llm_tpu_torch.models.from_jax import params_from_jax
from grounded_video_llm_tpu_torch.serve import captioning as tcap
from grounded_video_llm_tpu_torch.serve import eval as teval
from grounded_video_llm_tpu_torch.serve.engine import (
    InferenceEngine as TEngine)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GREEDY = dict(max_new_tokens=4, do_sample=False, temperature=0.0)


def _root_eval():
    """The root eval.py, loaded by path (its name would shadow nothing in
    sys.modules)."""
    spec = importlib.util.spec_from_file_location(
        "root_eval_under_test", os.path.join(REPO, "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------

interval = st.tuples(st.floats(0, 200, allow_nan=False),
                     st.floats(0, 200, allow_nan=False))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(interval, interval)
def test_interval_overlaps_copy(pred, gt):
    assert teval.temporal_iou(pred, gt) == jeval.temporal_iou(pred, gt)
    assert teval.temporal_iop(pred, gt) == jeval.temporal_iop(pred, gt)


@pytest.mark.parametrize("metric", ["grounding", "gqa", "accuracy"])
@pytest.mark.parametrize("n", [0, 1, 17])
def test_metric_summaries_copy(metric, n):
    rng = np.random.default_rng(n)
    pairs = []
    for i in range(n):
        s, e = sorted(rng.uniform(0, 60, 2))
        gs, ge = sorted(rng.uniform(0, 60, 2))
        pairs.append((None if i % 5 == 3 else (s, e), (gs, ge),
                      bool(rng.integers(2))))
    out = []
    for mod in (teval, jeval):
        m = {"grounding": mod.GroundingMetrics, "gqa": mod.GQAMetrics,
             "accuracy": mod.AccuracyMetrics}[metric]()
        for pred, gt, ok in pairs:
            if metric == "grounding":
                m.add(pred, gt)
            elif metric == "gqa":
                m.add(ok, pred, gt)
            else:
                m.add(ok)
        out.append(m.summary())
    assert out[0] == out[1]


answer_text = st.text(alphabet="ABCDEab <>0123456789.seconds to()\n",
                      max_size=40)


@pytest.mark.parametrize("family", ["interval", "mc_answer", "mc_prompt"])
@settings(max_examples=150, deadline=None, derandomize=True)
@given(text=answer_text, duration=st.floats(1, 300, allow_nan=False))
def test_parsers_copy(family, text, duration):
    options = ["a dog", "the cat", "a red car", text.strip()[:6] or "x"]
    if family == "interval":
        assert (teval.parse_first_interval(text, duration)
                == jeval.parse_first_interval(text, duration))
    elif family == "mc_answer":
        assert (teval.parse_mc_answer(text, options)
                == jeval.parse_mc_answer(text, options))
    else:
        assert (teval.format_mc_prompt(text, options)
                == jeval.format_mc_prompt(text, options))


CHARADES = ("AO8RW 0.0 6.9##a person puts a book away.\n"
            "XYZ12 2.5 10.0##someone opens a door \n\n"
            "bad line without separator\n"
            "SHORT 1.0##too few fields\n")
ANET = {"v_abc": {"duration": 30.0, "timestamps": [[0, 5.5], [4, 12]],
                  "sentences": [" A man walks in.", "He sits down. "]},
        "xyz": {"duration": 12.0, "timestamps": [[1, 2]],
                "sentences": ["Something."]}}
ITEMS = [{"video": "a.mp4", "query": "q one", "start": 1.0, "end": 2.5},
         {"video": "b.mp4", "question": "q two", "answer": "B",
          "options": ["x", "y"], "start": 0, "end": 1}]


@pytest.mark.parametrize("loader", ["charades_sta", "activitynet",
                                    "annotations", "cli_json", "cli_jsonl",
                                    "cli_charades_sta"])
def test_loaders_copy(loader, tmp_path):
    """serve/eval.py's three loaders against JAX's, and the CLI's
    load_annotations in all three formats against the root eval.py's."""
    charades = tmp_path / "charades.txt"
    charades.write_text(CHARADES)
    anet = tmp_path / "anet.json"
    anet.write_text(json.dumps(ANET))
    native = tmp_path / "items.json"
    native.write_text(json.dumps(ITEMS))
    lines = tmp_path / "items.jsonl"
    lines.write_text("".join(json.dumps(it) + "\n\n" for it in ITEMS))
    if loader == "charades_sta":
        got = teval.load_charades_sta(str(charades), ".avi")
        assert got == jeval.load_charades_sta(str(charades), ".avi")
        assert len(got) == 2
    elif loader == "activitynet":
        got = teval.load_activitynet_grounding(str(anet))
        assert got == jeval.load_activitynet_grounding(str(anet))
        assert len(got) == 3
    elif loader == "annotations":
        assert (teval.load_annotations(str(native))
                == jeval.load_annotations(str(native)) == ITEMS)
    else:
        fmt = loader[len("cli_"):]
        path = {"json": native, "jsonl": lines, "charades_sta": charades}[fmt]
        root = _root_eval()
        if fmt == "charades_sta":
            # the root loader reads only well-formed lines; "SHORT" has two
            # fields and makes both raise alike
            path.write_text(CHARADES.replace("SHORT 1.0##too few fields\n",
                                             ""))
            bad = tmp_path / "bad.txt"
            bad.write_text("SHORT 1.0##too few fields\n")
            for mod in (tcli, root):
                with pytest.raises(ValueError):
                    mod.load_annotations(str(bad), fmt)
        got = tcli.load_annotations(str(path), fmt)
        assert got == root.load_annotations(str(path), fmt)
        assert len(got) == 2


caption_words = st.lists(st.sampled_from(
    "a the man men running runs ran dog dogs opens opened door doors "
    "quickly quick slowly jumps jumping .".split()), max_size=12).map(
        " ".join)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(caption_words, caption_words)
def test_meteor_copy(hyp, ref):
    assert tcap.meteor_score(hyp, ref) == jcap.meteor_score(hyp, ref)


def _captions(seed, n):
    rng = np.random.default_rng(seed)
    words = "a man opens the door then runs quickly to his dog".split()
    out = []
    for _ in range(n):
        s, e = sorted(rng.uniform(0, 40, 2))
        out.append(((float(s), float(e)),
                    " ".join(rng.choice(words, rng.integers(1, 8)))))
    return out


@pytest.mark.parametrize("scorer", ["soda_c", "dense_caption_meteor",
                                    "summary", "monotone_dp", "parse"])
@pytest.mark.parametrize("seed", [0, 1])
def test_captioning_scorers_copy(scorer, seed):
    preds = [_captions(seed * 10 + i, i % 4) for i in range(5)]
    gts = [_captions(seed * 10 + i + 100, 1 + i % 3) for i in range(5)]
    for mod_a, mod_b in ((tcap, jcap),):
        if scorer == "summary":
            assert (mod_a.dense_captioning_summary(preds, gts)
                    == mod_b.dense_captioning_summary(preds, gts))
        elif scorer == "monotone_dp":
            score = np.random.default_rng(seed).random((4, 3)).tolist()
            assert mod_a._monotone_dp(score) == mod_b._monotone_dp(score)
            assert mod_a._monotone_dp([]) == mod_b._monotone_dp([]) == 0.0
        elif scorer == "parse":
            text = ("intro <12> <45> a man opens the door. <50> to <88> "
                    "he runs, <3><4> <9> <10>   ; <100> <120> the end")
            for duration in (30.0, 96.5):
                assert (mod_a.parse_dense_captions(text, duration)
                        == mod_b.parse_dense_captions(text, duration))
        else:
            for p, g in zip(preds, gts):
                assert (getattr(mod_a, scorer)(p, g)
                        == getattr(mod_b, scorer)(p, g))


# ---------------------------------------------------------------------------
# the runners through both engines
# ---------------------------------------------------------------------------


def _record(eng, texts):
    """Wrap the engine's three batch routes so each call's item texts (and
    its route) are recorded."""
    for name in ("run_stream", "run_stream_cached", "run_stream_prefix"):
        fn = getattr(eng, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            texts.append((_name, [r.text for r in out]))
            return out
        setattr(eng, name, wrapped)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both engines on the same bridged micro weights (greedy, 4 tokens,
    feature cache 8, prefix_cache on), their preprocess_video stubbed to the
    same frames of three videos behind placeholder files (durations 12, 30
    and 47.5 s); the texts of every batch route call, per engine."""
    cfg = micro_vlm_config("phi3.5")
    # the JAX tree's init, compiled (its eager form takes ~3x as long)
    jp = jax.jit(jvlm.init_params, static_argnums=1)(jax.random.key(0), cfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    tok = build_test_tokenizer("phi3.5")
    root = tmp_path_factory.mktemp("eval_videos")
    teng = TEngine(tp, cfg, tok, TGen(**GREEDY), prefix_cache=True)
    jeng = jengine.InferenceEngine(jp, cfg, tok, JGen(**GREEDY),
                                   prefix_cache=True)
    frames = {}
    for i, duration in enumerate((12.0, 30.0, 47.5)):
        path = str(root / f"vid{i}.mp4")
        with open(path, "wb") as f:
            f.write(b"placeholder" * (i + 1))
        raw = np.random.default_rng(i).integers(
            0, 256, (cfg.num_frames, 48, 64, 3), dtype=np.uint8)
        frames[path] = (*teng.preprocess_frames(raw), duration)
    texts = {"port": [], "jax": []}
    for eng, name in ((teng, "port"), (jeng, "jax")):
        eng.preprocess_video = frames.__getitem__
        _record(eng, texts[name])
    return teng, jeng, str(root), texts


GROUNDING = [{"video": f"vid{v}.mp4", "query": q, "start": s, "end": e}
             for v, q, s, e in ((0, "a man opens the door", 1.0, 4.5),
                                (0, "he sits down", 6.0, 11.0),
                                (1, "the dog runs", 0.0, 12.5),
                                (2, "someone cooks", 20.0, 40.0),
                                (1, "lights turn off", 3.0, 9.0))]
MC = [{"video": f"vid{v}.mp4", "question": q, "options": opts, "answer": a}
      for v, q, opts, a in (
          (0, "What is he holding?", ["a cup", "a book", "a phone"], "B"),
          (1, "Where is the dog?", ["inside", "outside"], 0),
          (1, "What color is the car?", ["red", "blue", "green"], "c"))]
GQA = [dict(MC[0], start=1.0, end=3.0),
       {"video": "vid1.mp4", "question": "Why does he run?",
        "answer": "to catch the bus", "start": 2.0, "end": 8.0},
       dict(MC[1], answer="outside", start=0.0, end=5.0),
       dict(MC[2], start=4.0, end=9.0)]
CAPTIONS = {"vid0": {"duration": 12.0, "timestamps": [[0, 4], [5, 11]],
                     "sentences": ["A man opens the door.", "He sits."]},
            "vid2.mp4": {"timestamps": [[3, 30]],
                         "sentences": ["Someone cooks dinner."]}}


@pytest.mark.parametrize("bench,route", [
    ("grounding", "run_stream_prefix"),
    ("grounding_cached", "run_stream_cached"),
    ("mc", "run_stream_cached"),
    ("gqa", "run_stream_cached"),
    ("grounding_unique", "run_stream"),
    ("captioning", "run_stream")])
def test_runners_match_jax(engines, bench, route):
    """Each runner through both engines: equal metric dicts and equal item
    texts, through the route _run_items picks (prefix with prefix_cache and
    repeated videos, cached without it, plain for unique videos)."""
    teng, jeng, root, texts = engines
    out = []
    for eng, name in ((teng, "port"), (jeng, "jax")):
        del texts[name][:]
        eng.prefix_cache = bench == "grounding"
        kw = dict(video_root=root, batch_size=2)
        mod_eval = teval if name == "port" else jeval
        mod_cap = tcap if name == "port" else jcap
        if bench.startswith("grounding"):
            items = (GROUNDING[2:4] if bench == "grounding_unique"
                     else GROUNDING)
            metrics = mod_eval.eval_grounding(eng, items, **kw)
        elif bench == "mc":
            metrics = mod_eval.eval_multiple_choice(eng, MC, **kw)
        elif bench == "gqa":
            metrics = mod_eval.eval_gqa(eng, GQA, **kw)
        else:
            metrics = mod_cap.eval_dense_captioning(eng, CAPTIONS, **kw)
        out.append((metrics, list(texts[name])))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]
    assert [r for r, _ in out[0][1]] == [route]


def test_empty_and_max_items(engines):
    teng, jeng, root, _ = engines
    for mod, eng in ((teval, teng), (jeval, jeng)):
        assert (mod.eval_grounding(eng, [], video_root=root)
                == jeval.GroundingMetrics().summary())
        assert mod.eval_gqa(eng, [], video_root=root) == {
            "GQA": 0.0, "mIoP": 0.0, "mIoU": 0.0}
        assert mod.eval_multiple_choice(eng, [], video_root=root) == {
            "accuracy": 0.0}
    assert (tcap.eval_dense_captioning(teng, CAPTIONS, video_root=root,
                                       max_items=0)
            == jcap.eval_dense_captioning(jeng, CAPTIONS, video_root=root,
                                          max_items=0))


class _StubEngine:
    feature_cache_size = 8
    prefix_cache = True

    def __init__(self):
        self.called = []

    def run_stream(self, paths, prompts, mode, batch_size):
        self.called.append("plain")
        return ["r"] * len(paths)

    def run_stream_cached(self, paths, prompts, mode, batch_size):
        self.called.append("cached")
        return ["r"] * len(paths)

    def run_stream_prefix(self, paths, prompts, mode, batch_size):
        self.called.append("prefix")
        return ["r"] * len(paths)


@pytest.mark.parametrize("cache_size,prefix,items,want", [
    (8, False, "dup", "cached"), (8, False, "uniq", "plain"),
    (0, False, "dup", "plain"), (8, True, "dup", "prefix"),
    (8, True, "uniq", "plain"), (0, True, "dup", "plain")])
def test_run_items_routing(cache_size, prefix, items, want):
    """The mirrors of tests/test_feature_cache.py::
    test_eval_routes_duplicates_through_cache and tests/test_prefix_cache.py
    ::test_eval_routes_prefix_when_enabled, on both packages' _run_items."""
    its = {"dup": [{"video": "a.mp4"}, {"video": "a.mp4"},
                   {"video": "b.mp4"}],
           "uniq": [{"video": "a.mp4"}, {"video": "b.mp4"}]}[items]
    for mod in (teval, jeval):
        eng = _StubEngine()
        eng.feature_cache_size, eng.prefix_cache = cache_size, prefix
        mod._run_items(eng, its, ["p"] * len(its), "grounding", "", 2)
        assert eng.called == [want]


def test_engine_prefix_cache_option(engines):
    teng = engines[0]
    args = (teng.params, teng.cfg, teng.tokenizer)
    assert TEngine(*args).prefix_cache is False
    assert TEngine(*args, prefix_cache=True).prefix_cache is True


def test_quant_ab_memory_protocol():
    """run_quant_ab runs the bf16 leg, calls free_bf16, and only then
    builds the quantized tree from a callable, as the JAX bar does."""
    from grounded_video_llm_tpu_torch.serve import quant_ab

    events = []
    model = {}

    def pipeline(params, *a):
        events.append(("logits", params["name"]))
        return torch.zeros(1, 3, 5), torch.ones(1, 3)

    def generate(params, *a, quantize_cache, **kw):
        events.append(("decode", params["name"], quantize_cache))
        return torch.zeros(1, 2, dtype=torch.long), torch.full((1,), 2)

    def build():
        events.append(("build", "quant"))
        return {"name": "quant", "llm": {"embed": torch.zeros(4, 2)}}

    orig = quant_ab.pipeline_logits, quant_ab.generate_tokens
    quant_ab.pipeline_logits, quant_ab.generate_tokens = pipeline, generate
    try:
        model["bf16"] = {"name": "bf16", "llm": {"embed": torch.zeros(4, 2)}}
        report = quant_ab.run_quant_ab(
            model.pop("bf16"), build, None, np.zeros((1, 3)),
            np.ones((1, 3)), np.zeros(1), np.zeros(1),
            free_bf16=lambda: events.append(("free", "bf16")))
    finally:
        quant_ab.pipeline_logits, quant_ab.generate_tokens = orig
    assert events == [("logits", "bf16"), ("decode", "bf16", False),
                      ("free", "bf16"), ("build", "quant"),
                      ("logits", "quant"), ("decode", "quant", True)]
    assert report["pass"] and report["mean_kl_nats"] == 0.0


# ---------------------------------------------------------------------------
# cli/eval.py
# ---------------------------------------------------------------------------


def test_cli_gate_exits_2_without_weights(tmp_path):
    anno = tmp_path / "a.json"
    anno.write_text("[]")
    r = subprocess.run(
        [sys.executable, "-m", "grounded_video_llm_tpu_torch.cli.eval",
         "--anno_path", str(anno), "--ckpt_path", "/nonexistent.pth"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 2, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["status"] == "skipped"
    assert out["required"]["ckpt_path"] == "/nonexistent.pth"


@pytest.mark.parametrize("flags,refused", [
    (["--static_scales"], True),
    (["--static_scales", "--quantize", "int8"], True),
    (["--static_scales", "--quantize_ab", "--quantize", "int8"], True),
    (["--static_scales", "--quantize", "int8_full"], False),
    (["--static_scales", "--quantize_ab"], False),
    (["--quantize", "int8"], False)])
def test_cli_static_scales_needs_int8_full(flags, refused, capsys):
    argv = ["--anno_path", "a.json", *flags]
    if refused:
        with pytest.raises(SystemExit) as e:
            tcli.parse_args(argv)
        assert e.value.code == 2
        assert "int8_full" in capsys.readouterr().err
    else:
        args = tcli.parse_args(argv)
        assert args.device == "cuda"


@pytest.fixture(scope="module")
def cv2_videos(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("cli_videos")
    rng = np.random.default_rng(0)
    for v, n in ((0, 30), (1, 20)):
        w = cv2.VideoWriter(str(root / f"c{v}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
        for _ in range(n):
            w.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
        w.release()
    return root


def test_cli_debug_tiny_grounding(cv2_videos, tmp_path, capsys):
    """--debug_tiny --allow_random_weights --device cpu on cv2 mp4s,
    charades_sta annotations with a repeated video and --prefix_cache: the
    printed JSON equals --out's and has JAX's metric keys."""
    anno = tmp_path / "charades.txt"
    anno.write_text("c0 0.5 2.0##a man runs\nc0 1.0 3.0##he sits down\n"
                    "c1 0.0 1.5##the door opens\n")
    out = tmp_path / "metrics.json"
    code = tcli.main(["--debug_tiny", "--device", "cpu",
                      "--allow_random_weights", "--anno_format",
                      "charades_sta", "--anno_path", str(anno),
                      "--video_root", str(cv2_videos), "--max_new_tokens",
                      "3", "--prefix_cache", "--out", str(out)])
    assert code == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(out.read_text())
    assert printed["benchmark"] == "grounding"
    assert printed["quantize"] == "bf16" and printed["n_items"] == 3
    assert set(printed["metrics"]) == set(jeval.GroundingMetrics().summary())


def test_cli_quantize_ab(cv2_videos, tmp_path, capsys):
    """--quantize_ab on the micro model: the report of the port's
    serve/quant_ab (metric keys as the JAX bar's), exit 0 or 1 by its
    verdict."""
    anno = tmp_path / "items.json"
    anno.write_text(json.dumps([{"video": "c0.mp4", "query": "a man runs"},
                                {"video": "c1.mp4", "query": "a door"}]))
    code = tcli.main(["--debug_tiny", "--device", "cpu",
                      "--allow_random_weights", "--anno_path", str(anno),
                      "--video_root", str(cv2_videos), "--quantize_ab",
                      "--ab_items", "2", "--ab_max_new_tokens", "3"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = printed.pop("report")
    assert printed == {"mode": "quantize_ab", "llm": "phi3.5",
                       "quantize": "int8_full", "static_scales": False,
                       "n_items": 2}
    assert code == (0 if report["pass"] else 1)
    assert set(report) == {"mean_kl_nats", "top1_agreement",
                           "greedy_exact_rate", "greedy_prefix_agreement",
                           "thresholds", "pass"}
