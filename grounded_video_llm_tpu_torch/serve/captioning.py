# The port's own copy of grounded_video_llm_tpu/serve/captioning.py, which imports no
# framework; tests/test_torch_eval.py holds the two to each other.
"""Dense video captioning scorers: METEOR + SODA_c (ActivityNet-Captions).

The reference reports SODA_c / METEOR on ActivityNet-Captions as headline
metrics (reference README.md:31-34) but ships no eval code; the official
scorers are a Java METEOR jar + the SODA repo, neither available here. This
module implements both from their published definitions in pure Python:

  * METEOR — staged-match variant of METEOR 1.0 (Banerjee & Lavie 2005):
    unigram alignment in two stages, exact surface forms then equal Porter
    stems among the still-unmatched words (text/porter.py implements the
    published 1980 algorithm; each word used at most once, earliest-position
    matching), F_mean = 10PR/(R+9P), fragmentation penalty
    0.5*(chunks/matches)^3, score = F_mean*(1-penalty). Remaining deviation
    from the Java tool: no WordNet synonym stage (the WordNet database has
    no offline equivalent here), so absolute values can run slightly lower
    than the official scorer on synonym-heavy text.

  * Dense-caption METEOR — the ActivityNet Challenge protocol: at each tIoU
    threshold in {0.3,0.5,0.7,0.9} score every prediction against the
    best-matching ground-truth segment with tIoU >= t (0 when none matches),
    average over predictions, then average over thresholds.

  * SODA_c — Fujita et al., "SODA: Story Oriented Dense video cAption
    evaluation framework" (ECCV 2020): dynamic-programming optimal MONOTONIC
    alignment between the predicted and ground-truth caption sequences,
    maximizing summed METEOR over pairs with temporal overlap (tIoU > 0);
    precision = sum/n_pred, recall = sum/n_gt, SODA_c = harmonic mean.
    The monotonicity constraint is what penalizes story-order violations and
    redundant captions, unlike per-segment matching.

Also provides parse_dense_captions: splits generated text of the form
"<12> <45> sentence. <50> <88> sentence..." into (interval, caption) pairs
via the temporal-token codec (reference inference.py:125-134 semantics).
"""

from __future__ import annotations

import re
import string
from typing import Dict, List, Optional, Sequence, Tuple

from .eval import temporal_iou

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def _tokens(text: str) -> List[str]:
    return text.lower().translate(_PUNCT_TABLE).split()


def meteor_score(hypothesis: str, reference: str) -> float:
    """Staged-match METEOR between two sentences (module docstring)."""
    from ..text.porter import porter_stem

    hyp = _tokens(hypothesis)
    ref = _tokens(reference)
    if not hyp or not ref:
        return 0.0

    # staged earliest-position unigram alignment (METEOR 1.0): stage 1 on
    # exact surface forms, stage 2 on equal Porter stems among the words
    # both sides left unmatched; each word used at most once
    used = [False] * len(ref)
    taken = [False] * len(hyp)
    align: List[Tuple[int, int]] = []
    for hyp_key, ref_key in ((hyp, ref),
                             ([porter_stem(w) for w in hyp],
                              [porter_stem(r) for r in ref])):
        for i, w in enumerate(hyp_key):
            if taken[i]:
                continue
            for j, r in enumerate(ref_key):
                if not used[j] and r == w:
                    used[j] = True
                    taken[i] = True
                    align.append((i, j))
                    break
    align.sort()
    m = len(align)
    if m == 0:
        return 0.0
    p = m / len(hyp)
    r = m / len(ref)
    f_mean = 10.0 * p * r / (r + 9.0 * p)
    # chunks: maximal runs contiguous in BOTH hyp and ref order
    chunks = 1
    for (i0, j0), (i1, j1) in zip(align, align[1:]):
        if i1 != i0 + 1 or j1 != j0 + 1:
            chunks += 1
    penalty = 0.5 * (chunks / m) ** 3
    return f_mean * (1.0 - penalty)


# ---------------------------------------------------------------------------
# Dense-caption structures
# ---------------------------------------------------------------------------

Caption = Tuple[Tuple[float, float], str]  # ((start_s, end_s), sentence)

_PAIR_RE = re.compile(r"<(\d+)>\s*(?:to\s*)?<(\d+)>")


def parse_dense_captions(text: str, duration: float,
                         num_temporal_tokens: int = 300) -> List[Caption]:
    """'<a> <b> sent one. <c> <d> sent two' → [((ta,tb),'sent one.'), ...].
    Temporal tokens decode as duration * n / num_temporal_tokens (reference
    inference.py:125-134). Text before the first pair is dropped."""
    out: List[Caption] = []
    matches = list(_PAIR_RE.finditer(text))
    for k, mt in enumerate(matches):
        a, b = int(mt.group(1)), int(mt.group(2))
        s = duration * a / num_temporal_tokens
        e = duration * b / num_temporal_tokens
        seg_end = matches[k + 1].start() if k + 1 < len(matches) else len(text)
        sent = text[mt.end():seg_end].strip(" ,;:\n")
        if sent:
            out.append(((s, e), sent))
    return out


DEFAULT_TIOU_THRESHOLDS = (0.3, 0.5, 0.7, 0.9)


def dense_caption_meteor(preds: Sequence[Caption], gts: Sequence[Caption],
                         thresholds: Sequence[float] = DEFAULT_TIOU_THRESHOLDS
                         ) -> float:
    """ActivityNet Challenge dense-captioning METEOR for ONE video, averaged
    over tIoU thresholds (module docstring)."""
    if not preds or not gts:
        return 0.0
    per_threshold = []
    for t in thresholds:
        scores = []
        for (piv, ptext) in preds:
            best = 0.0
            for (giv, gtext) in gts:
                if temporal_iou(piv, giv) >= t:
                    best = max(best, meteor_score(ptext, gtext))
            scores.append(best)
        per_threshold.append(sum(scores) / len(scores))
    return sum(per_threshold) / len(per_threshold)


def _monotone_dp(score: List[List[float]]) -> float:
    """Max-sum monotonic alignment (pairs strictly increasing in both
    indices) — the SODA 'chased' DP."""
    n, m = len(score), len(score[0]) if score else 0
    if n == 0 or m == 0:
        return 0.0
    dp = [[0.0] * m for _ in range(n)]
    for i in range(n):
        for j in range(m):
            take = score[i][j] + (dp[i - 1][j - 1] if i > 0 and j > 0 else 0.0)
            best = take
            if i > 0:
                best = max(best, dp[i - 1][j])
            if j > 0:
                best = max(best, dp[i][j - 1])
            dp[i][j] = best
    return dp[n - 1][m - 1]


def soda_c(preds: Sequence[Caption], gts: Sequence[Caption]) -> float:
    """SODA_c F-measure for ONE video (module docstring)."""
    if not preds or not gts:
        return 0.0
    score = [[meteor_score(pt, gt) if temporal_iou(piv, giv) > 0.0 else 0.0
              for (giv, gt) in gts]
             for (piv, pt) in preds]
    total = _monotone_dp(score)
    precision = total / len(preds)
    recall = total / len(gts)
    if precision + recall == 0.0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def dense_captioning_summary(all_preds: Sequence[Sequence[Caption]],
                             all_gts: Sequence[Sequence[Caption]]
                             ) -> Dict[str, float]:
    """Corpus scores (mean over videos), scaled x100 like the reference's
    README table (SODA_c 6.0 / METEOR 6.8)."""
    assert len(all_preds) == len(all_gts)
    if not all_preds:
        return {"SODA_c": 0.0, "METEOR": 0.0}
    sodas = [soda_c(p, g) for p, g in zip(all_preds, all_gts)]
    meteors = [dense_caption_meteor(p, g) for p, g in zip(all_preds, all_gts)]
    n = len(all_preds)
    return {"SODA_c": 100.0 * sum(sodas) / n,
            "METEOR": 100.0 * sum(meteors) / n}


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

DENSE_CAPTION_PROMPT = ("Provide a detailed description of the video, and "
                        "mark the start and end timestamps of each event.")


def eval_dense_captioning(engine, annotations: Dict[str, Dict],
                          video_root: str = "",
                          max_items: Optional[int] = None,
                          batch_size: int = 6,
                          prompt: str = DENSE_CAPTION_PROMPT
                          ) -> Dict[str, float]:
    """ActivityNet-Captions dense captioning (batched).

    annotations: {video_id: {"duration": d, "timestamps": [[s,e],...],
    "sentences": [...]}} — the official val_1/val_2 json format (same schema
    the grounding loader consumes, serve/eval.py:load_activitynet_grounding).
    Video files resolve as {video_root}/{video_id}.mp4 (v_ prefix preserved
    as given)."""
    import os

    vids = list(annotations)
    if max_items is not None:
        vids = vids[:max_items]
    if not vids:
        return {"SODA_c": 0.0, "METEOR": 0.0}
    paths = [os.path.join(video_root, v if v.endswith(".mp4") else v + ".mp4")
             for v in vids]
    results = engine.run_stream(paths, [prompt] * len(vids),
                                mode="grounding", batch_size=batch_size)
    all_preds, all_gts = [], []
    for vid, res in zip(vids, results):
        entry = annotations[vid]
        duration = float(entry.get("duration") or res.duration)
        all_preds.append(parse_dense_captions(
            res.text, duration, engine.cfg.num_temporal_tokens))
        all_gts.append([((float(s), float(e)), sent) for (s, e), sent in
                        zip(entry["timestamps"], entry["sentences"])])
    return dense_captioning_summary(all_preds, all_gts)
