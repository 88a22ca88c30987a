"""Int8 serving accuracy bar: a bf16-vs-quantized A/B through the whole
pipeline (port of grounded_video_llm_tpu/serve/quant_ab.py).

- per-position logit KL(bf16 || quant) over the real pipeline (pixels →
  encoders → projector → splice → LLM logits), valid positions only;
- per-position greedy top-1 agreement over those logits;
- greedy decode token agreement through the serving path
  (serve/generate.generate_tokens, do_sample=False): exact-match and
  prefix-agreement rates.

The DEFAULT_* thresholds are the JAX package's committed bar. With random
weights the metrics are readings only; the verdict means something once
real checkpoints load.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.config import VLMConfig
from ..models import llm as llm_mod
from ..models import vlm
from ..text.tokenizer import pad_batch_generate
from .generate import generate_tokens

DEFAULT_MAX_KL = 0.05          # mean nats/position, bf16 || quant
DEFAULT_MIN_TOP1 = 0.98        # per-position greedy agreement on prompt logits
DEFAULT_MIN_GREEDY = 0.90      # mean greedy-decode prefix agreement


def pipeline_logits(params, cfg: VLMConfig, input_ids, attn_mask,
                    spatial_pixels, temporal_pixels):
    """Full-pipeline per-position logits [B, S_full, V] (fp32) and the
    spliced validity mask [B, S_full]: the serving encode and splice, then
    the dense forward for all-position logits."""
    with torch.inference_mode():
        feats = vlm.encode_video(params, cfg, spatial_pixels, temporal_pixels)
        embeds, _, mask = vlm.splice_multimodal(
            input_ids, None, attn_mask, feats, params["llm"]["embed"])
        logits = llm_mod.forward_logits(params["llm"], cfg.llm, embeds, mask)
    return logits.float(), mask


def compare_logits(logits_a: np.ndarray, logits_b: np.ndarray,
                   mask: np.ndarray) -> Dict[str, float]:
    """KL(a || b) in nats and top-1 agreement over valid positions (host,
    fp64 log-softmax)."""
    valid = np.asarray(mask).astype(bool)
    a = np.asarray(logits_a)[valid].astype(np.float64)
    b = np.asarray(logits_b)[valid].astype(np.float64)
    a = a - a.max(-1, keepdims=True)
    b = b - b.max(-1, keepdims=True)
    logp_a = a - np.log(np.exp(a).sum(-1, keepdims=True))
    logp_b = b - np.log(np.exp(b).sum(-1, keepdims=True))
    kl = float((np.exp(logp_a) * (logp_a - logp_b)).sum(-1).mean())
    top1 = float((logp_a.argmax(-1) == logp_b.argmax(-1)).mean())
    return {"mean_kl_nats": kl, "top1_agreement": top1}


def compare_greedy(tokens_a: np.ndarray, lengths_a: np.ndarray,
                   tokens_b: np.ndarray, lengths_b: np.ndarray
                   ) -> Dict[str, float]:
    """Greedy-decode agreement: exact-sequence match rate and mean prefix
    agreement (matched tokens before the first divergence / bf16 length)."""
    B = tokens_a.shape[0]
    exact = 0
    prefix_fracs = []
    for i in range(B):
        la, lb = int(lengths_a[i]), int(lengths_b[i])
        a, b = tokens_a[i, :la], tokens_b[i, :lb]
        if la == lb and np.array_equal(a, b):
            exact += 1
        n = min(la, lb)
        same = a[:n] == b[:n]
        div = int(np.argmin(same)) if not same.all() else n
        prefix_fracs.append(div / max(la, 1))
    return {"greedy_exact_rate": exact / max(B, 1),
            "greedy_prefix_agreement": float(np.mean(prefix_fracs))}


def prepare_ab_inputs(engine, items, video_root: str = "",
                      mode: str = "grounding"):
    """Annotation items ({"video", "query" or "question"}) → the same
    pipeline inputs for both legs, through the engine's own helpers (prompt
    template, dual-stream preprocess, left-pad batching): (ids, mask,
    spatial, temporal) as numpy arrays."""
    prompts, temporal, spatial = [], [], []
    for it in items:
        path = (os.path.join(video_root, it["video"]) if video_root
                else it["video"])
        t, s, duration = engine.preprocess_video(path)
        q = it.get("query") or it.get("question") or ""
        prompts.append(engine.build_prompt(q, mode, duration))
        temporal.append(t)
        spatial.append(s)
    seqs = [engine.tokenize_prompt(p) for p in prompts]
    ids, mask = pad_batch_generate(seqs, engine.tokenizer.pad_token_id,
                                   engine.cfg.max_txt_len)
    return (np.asarray(ids), np.asarray(mask), np.stack(spatial),
            np.stack(temporal))


def run_quant_ab(params_bf16, params_quant, cfg: VLMConfig,
                 input_ids, attn_mask, spatial_pixels, temporal_pixels,
                 *, max_new_tokens: int = 32, eos_token_id: int = -1,
                 pad_token_id: int = 0,
                 max_kl: float = DEFAULT_MAX_KL,
                 min_top1: float = DEFAULT_MIN_TOP1,
                 min_greedy: float = DEFAULT_MIN_GREEDY,
                 free_bf16: Optional[Callable[[], None]] = None
                 ) -> Dict[str, object]:
    """The A/B: the same pipeline inputs (numpy arrays or tensors) through
    both trees, on the device of the bf16 tree's embedding; returns the
    metric dict with a 'pass' verdict against the thresholds. The quantized
    leg decodes over the int8 KV cache. The default
    eos of -1 stops no row, as in the JAX bar.

    Memory protocol, as in the JAX package: the bf16 leg runs first and its
    outputs move to the host; ``free_bf16`` (called then) drops the bf16
    tree, and a zero-argument callable as params_quant builds the quantized
    tree only after that, for models whose two trees do not fit the card
    together."""
    embed = params_bf16["llm"]["embed"]
    device = getattr(embed, "q", embed).device

    def dev(a):
        return (a if torch.is_tensor(a)
                else torch.from_numpy(np.array(a))).to(device)

    ids, am = dev(input_ids).long(), dev(attn_mask).long()
    sp, tp = dev(spatial_pixels), dev(temporal_pixels)
    gen_kw = dict(max_new_tokens=max_new_tokens, do_sample=False,
                  temperature=0.0, eos_token_id=eos_token_id,
                  pad_token_id=pad_token_id)

    def leg(params, quantize_cache):
        logits, mask = pipeline_logits(params, cfg, ids, am, sp, tp)
        toks, lens = generate_tokens(params, cfg, ids, am, sp, tp, None,
                                     quantize_cache=quantize_cache, **gen_kw)
        return (logits.cpu().numpy(), mask.cpu().numpy(),
                toks.cpu().numpy(), lens.cpu().numpy())

    logits_a, mask, toks_a, len_a = leg(params_bf16, False)
    params_bf16 = embed = None      # the last references before free_bf16
    if free_bf16 is not None:
        free_bf16()
    if callable(params_quant):
        params_quant = params_quant()
    logits_b, _, toks_b, len_b = leg(params_quant, True)

    metrics: Dict[str, object] = {}
    metrics.update(compare_logits(logits_a, logits_b, mask))
    metrics.update(compare_greedy(toks_a, len_a, toks_b, len_b))
    metrics["thresholds"] = {"max_kl": max_kl, "min_top1": min_top1,
                             "min_greedy": min_greedy}
    metrics["pass"] = bool(
        metrics["mean_kl_nats"] <= max_kl
        and metrics["top1_agreement"] >= min_top1
        and metrics["greedy_prefix_agreement"] >= min_greedy)
    return metrics
