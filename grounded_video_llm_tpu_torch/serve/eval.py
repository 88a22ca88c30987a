# The port's own copy of grounded_video_llm_tpu/serve/eval.py, which imports no
# framework; tests/test_torch_eval.py holds the two to each other.
"""Batched multi-benchmark eval harness.

Covers the reference's headline evals (BASELINE.md): temporal sentence
grounding (Charades-STA / ActivityNet-Grounding R1@{0.3,0.5,0.7} + mIoU),
grounded VideoQA (NExT-GQA GQA/mIoP/mIoU), and multiple-choice video QA
(MVBench / Video-MME accuracy). The reference has no in-repo eval code (it
reports numbers in README.md:31-34); this harness defines the standard metric
arithmetic and a batched runner over the InferenceEngine.

Annotation formats (one JSON list per benchmark):
  grounding: {video, query, start, end, duration?}
  qa-mc:     {video, question, options: [...], answer: int|letter}
  gqa:       {video, question, answer, start, end}
"""

from __future__ import annotations

import json
import re
import string
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..text import codec


# ---------------------------------------------------------------------------
# Metric arithmetic (pure, unit-testable)
# ---------------------------------------------------------------------------


def temporal_iou(pred: Tuple[float, float], gt: Tuple[float, float]) -> float:
    ps, pe = min(pred), max(pred)
    gs, ge = min(gt), max(gt)
    inter = max(0.0, min(pe, ge) - max(ps, gs))
    union = max(pe, ge) - min(ps, gs)
    return inter / union if union > 0 else 0.0


def temporal_iop(pred: Tuple[float, float], gt: Tuple[float, float]) -> float:
    """Intersection over *prediction* (NExT-GQA's mIoP)."""
    ps, pe = min(pred), max(pred)
    gs, ge = min(gt), max(gt)
    inter = max(0.0, min(pe, ge) - max(ps, gs))
    dur = pe - ps
    return inter / dur if dur > 0 else 0.0


@dataclass
class GroundingMetrics:
    """R1@{thresholds} + mIoU accumulator (Charades-STA / ANet convention)."""

    thresholds: Sequence[float] = (0.3, 0.5, 0.7)
    ious: List[float] = field(default_factory=list)

    def add(self, pred: Optional[Tuple[float, float]],
            gt: Tuple[float, float]) -> float:
        iou = temporal_iou(pred, gt) if pred is not None else 0.0
        self.ious.append(iou)
        return iou

    def summary(self) -> Dict[str, float]:
        arr = np.asarray(self.ious) if self.ious else np.zeros(1)
        out = {f"R1@{t}": float((arr >= t).mean()) * 100
               for t in self.thresholds}
        out["mIoU"] = float(arr.mean()) * 100
        return out


@dataclass
class GQAMetrics:
    """NExT-GQA: answer accuracy + mIoP + mIoU, plus Acc@GQA (correct answer
    AND IoP >= 0.5)."""

    correct: List[bool] = field(default_factory=list)
    iops: List[float] = field(default_factory=list)
    ious: List[float] = field(default_factory=list)

    def add(self, answer_correct: bool, pred: Optional[Tuple[float, float]],
            gt: Tuple[float, float]) -> None:
        self.correct.append(bool(answer_correct))
        self.iops.append(temporal_iop(pred, gt) if pred else 0.0)
        self.ious.append(temporal_iou(pred, gt) if pred else 0.0)

    def summary(self) -> Dict[str, float]:
        c = np.asarray(self.correct, dtype=bool)
        iop = np.asarray(self.iops)
        iou = np.asarray(self.ious)
        if len(c) == 0:
            return {"GQA": 0.0, "mIoP": 0.0, "mIoU": 0.0}
        return {
            "GQA": float((c & (iop >= 0.5)).mean()) * 100,
            "mIoP": float(iop.mean()) * 100,
            "mIoU": float(iou.mean()) * 100,
            "Acc": float(c.mean()) * 100,
        }


@dataclass
class AccuracyMetrics:
    correct: List[bool] = field(default_factory=list)

    def add(self, is_correct: bool) -> None:
        self.correct.append(bool(is_correct))

    def summary(self) -> Dict[str, float]:
        if not self.correct:
            return {"accuracy": 0.0}
        return {"accuracy": float(np.mean(self.correct)) * 100}


# ---------------------------------------------------------------------------
# Answer parsing
# ---------------------------------------------------------------------------


def parse_first_interval(text: str, duration: float,
                         num_temporal_tokens: int = 300
                         ) -> Optional[Tuple[float, float]]:
    ivs = codec.extract_intervals(text, duration, num_temporal_tokens)
    if ivs:
        return ivs[0]
    # fallback: "X to Y seconds" phrasing after parse_time_interval
    m = re.findall(r"(\d+(?:\.\d+)?)\s*(?:seconds|s)", text)
    if len(m) >= 2:
        return float(m[0]), float(m[1])
    return None


def parse_mc_answer(text: str, options: Sequence[str]) -> Optional[int]:
    """Map generated text to an option index: leading letter (A-E) or best
    option-string containment."""
    t = text.strip()
    if t and t[0].upper() in string.ascii_uppercase[:len(options)]:
        boundary = len(t) == 1 or not t[1].isalnum()
        if boundary:
            return string.ascii_uppercase.index(t[0].upper())
    tl = t.lower()
    best, best_len = None, 0
    for i, opt in enumerate(options):
        ol = opt.strip().lower()
        if ol and ol in tl and len(ol) > best_len:
            best, best_len = i, len(ol)
    return best


def format_mc_prompt(question: str, options: Sequence[str]) -> str:
    lines = [question.strip(), "Options:"]
    for i, opt in enumerate(options):
        lines.append(f"({string.ascii_uppercase[i]}) {opt}")
    lines.append("Answer with the option's letter from the given choices "
                 "directly and only give the best option.")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Benchmark runners
# ---------------------------------------------------------------------------


def _take(annotations: Iterable[Dict], max_items: Optional[int]) -> List[Dict]:
    items = list(annotations)
    return items[:max_items] if max_items is not None else items


def _run_items(engine, items: List[Dict], prompts: List[str], mode: str,
               video_root: str, batch_size: int):
    """Batched, pipelined execution over eval items via engine.run_stream —
    host video decode of batch i+1 overlaps device compute of batch i
    (BASELINE config 5, 'batched multi-benchmark eval'). Workloads with
    repeated videos (Charades-STA asks ≈2.8 queries per video) route through
    the feature cache: each unique video encodes ONCE, queries batch over
    the cached features."""
    import os

    paths = [os.path.join(video_root, it["video"]) for it in items]
    if (getattr(engine, "feature_cache_size", 0) > 0
            and len(set(paths)) < len(paths)):
        if getattr(engine, "prefix_cache", False):
            # opt-in: also dedup the shared prompt-head prefill per video
            # (prefix-KV caching; engine.run_stream_prefix)
            return engine.run_stream_prefix(paths, prompts, mode=mode,
                                            batch_size=batch_size)
        return engine.run_stream_cached(paths, prompts, mode=mode,
                                        batch_size=batch_size)
    return engine.run_stream(paths, prompts, mode=mode, batch_size=batch_size)


def eval_grounding(engine, annotations: Iterable[Dict],
                   video_root: str = "", prompt_template: str =
                   "When does \"{query}\" happen in the video?",
                   max_items: Optional[int] = None,
                   batch_size: int = 6) -> Dict[str, float]:
    """Charades-STA / ActivityNet-Grounding style R1@IoU eval (batched)."""
    items = _take(annotations, max_items)
    metrics = GroundingMetrics()
    if not items:
        return metrics.summary()
    prompts = [prompt_template.format(query=it["query"]) for it in items]
    results = _run_items(engine, items, prompts, "grounding", video_root,
                         batch_size)
    for item, res in zip(items, results):
        pred = parse_first_interval(res.text, res.duration)
        metrics.add(pred, (float(item["start"]), float(item["end"])))
    return metrics.summary()


def eval_multiple_choice(engine, annotations: Iterable[Dict],
                         video_root: str = "",
                         max_items: Optional[int] = None,
                         batch_size: int = 6) -> Dict[str, float]:
    """MVBench / Video-MME style accuracy eval (batched)."""
    items = _take(annotations, max_items)
    metrics = AccuracyMetrics()
    if not items:
        return metrics.summary()
    prompts = [format_mc_prompt(it["question"], it["options"]) for it in items]
    results = _run_items(engine, items, prompts, "qa", video_root, batch_size)
    for item, res in zip(items, results):
        pred = parse_mc_answer(res.text, item["options"])
        gt = item["answer"]
        if isinstance(gt, str):
            gt = string.ascii_uppercase.index(gt.strip().upper()[0])
        metrics.add(pred == gt)
    return metrics.summary()


def eval_gqa(engine, annotations: Iterable[Dict], video_root: str = "",
             max_items: Optional[int] = None,
             batch_size: int = 6) -> Dict[str, float]:
    """NExT-GQA grounded VideoQA: answer accuracy + mIoP/mIoU + Acc@GQA
    (correct answer AND IoP >= 0.5). Items carry {video, question, answer,
    start, end} and optionally {options} (NExT-GQA is multiple-choice); runs
    in grounding mode so the model emits <n> temporal tokens as evidence."""
    items = _take(annotations, max_items)
    metrics = GQAMetrics()
    if not items:
        return metrics.summary()

    def prompt_of(it):
        if it.get("options"):
            return format_mc_prompt(it["question"], it["options"])
        return it["question"]

    prompts = [prompt_of(it) for it in items]
    results = _run_items(engine, items, prompts, "grounding", video_root,
                         batch_size)
    for item, res in zip(items, results):
        gt_ans = item["answer"]
        if item.get("options"):
            pred_idx = parse_mc_answer(res.text, item["options"])
            if isinstance(gt_ans, str) and len(gt_ans.strip()) == 1:
                gt_idx = string.ascii_uppercase.index(
                    gt_ans.strip().upper())
            elif isinstance(gt_ans, str):
                opts = [o.strip().lower() for o in item["options"]]
                gt_idx = opts.index(gt_ans.strip().lower()) \
                    if gt_ans.strip().lower() in opts else -1
            else:
                gt_idx = int(gt_ans)
            correct = pred_idx == gt_idx
        else:
            correct = str(gt_ans).strip().lower() in res.text.strip().lower()
        pred_iv = parse_first_interval(res.text, res.duration)
        metrics.add(correct, pred_iv, (float(item["start"]),
                                       float(item["end"])))
    return metrics.summary()


def load_annotations(path: str) -> List[Dict]:
    with open(path) as f:
        return json.load(f)


def load_charades_sta(path: str, video_ext: str = ".mp4") -> List[Dict]:
    """Parse the official Charades-STA annotation format:
    'VIDEOID START END##query sentence' per line → grounding items."""
    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or "##" not in line:
                continue
            head, query = line.split("##", 1)
            parts = head.split()
            if len(parts) < 3:
                continue
            vid, start, end = parts[0], float(parts[1]), float(parts[2])
            items.append({"video": vid + video_ext, "query": query.strip(),
                          "start": start, "end": end})
    return items


def load_activitynet_grounding(path: str, video_prefix: str = "v_",
                               video_ext: str = ".mp4") -> List[Dict]:
    """Parse ActivityNet-Captions-style grounding json:
    {vid: {"duration": d, "timestamps": [[s,e],...], "sentences": [...]}}."""
    with open(path) as f:
        data = json.load(f)
    items = []
    for vid, entry in data.items():
        stamps = entry.get("timestamps", [])
        sents = entry.get("sentences", [])
        for (s, e), q in zip(stamps, sents):
            name = vid if vid.startswith(video_prefix) else video_prefix + vid
            items.append({"video": name + video_ext, "query": q.strip(),
                          "start": float(s), "end": float(e),
                          "duration": float(entry.get("duration", 0.0))})
    return items
