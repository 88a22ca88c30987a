"""High-level inference engine (port of the lockstep single-video path of
grounded_video_llm_tpu/serve/engine.py).

Pipeline: video file → 96-frame 'middle' sampling → host uint8 resize/crop →
prompt build (qa / grounding / referring) → encode, splice, prefill, decode
on the device → temporal-token parsing.

    engine = InferenceEngine(params, cfg, tokenizer, device="cuda",
                             quantize="int8_full")
    result = engine.run(video_path, prompt, mode="grounding")

``quantize``: None (bf16 serving), "int8" (int8 LLM weights, weight-only
everywhere) or "int8_full" (W8A8 prefill GEMMs and int8-cache decode
projections, plus W8A8 encoders). An LLM tree with LoRA adapters serves
them as the overlay of ``llm._dense`` in bf16 and merged into the base
kernels (``train/lora.merge_lora``) before int8 quantization.
``static_scales=True`` (with "int8_full"
only; otherwise it raises, where the JAX engine ignores it) calibrates static
activation scales for the InternVideo2 trunk's fc2 and proj legs
(serve/calibrate.py) once, lazily, on all the clips of the first request's
temporal pixels, before its encode. ``GenerateConfig.quantize_cache`` selects
the int8 KV cache. ``GenerateConfig.spec_draft_len > 0`` runs speculative
decoding (serve/speculative.py: n-gram drafts, one verify pass per step,
always on the int8 KV cache).

``run_frames`` takes already decoded frames (uint8 [F, H, W, 3]) and runs
everything after the decoder. After each request ``last_timings`` holds its
phase times in seconds (preprocess, encode, prefill, decode), the prompt
length in tokens and the number of tokens generated, with
``decode_steps`` or, under speculative decoding, ``verify_passes``, and
on the request that calibrated static scales ``calibrate``;
``last_tokens`` holds the request's token ids and lengths (host tensors).

Batched serving: ``run_batch`` and ``run_stream`` (host decode and resize
of the next batch on threads while the device works); the feature cache
(``feature_cache_size`` videos, an LRU of host features keyed on path,
mtime and size): ``encode_video_cached``, ``generate_from_features``,
``run_stream_cached`` (each unique video encoded once, queries batched
over its features); and ``run_stream_prefix``, which also prefills each
video's shared [pre-image text | video tokens] head once
(serve/generate.build_prefix_kv) and runs each batch of its queries as a
question-chunk prefill and decode, through the cascade cache
(llm.decode_step_shared) with ``quantize_cache`` and through
speculative.generate_tokens_spec_from_prefix with ``spec_draft_len``. These
calls sum their phases over the call in ``last_timings`` (encode with
``encodes``, prefix with ``prefixes``, prefill, decode with
``decode_steps`` or ``verify_passes``, and preprocess: host decode time
not hidden under device work) and hold every row's tokens, in input
order, in ``last_tokens``.

``prefix_cache=True`` routes an evaluation's repeated videos through
``run_stream_prefix`` rather than ``run_stream_cached``
(serve/eval._run_items reads it).

Continuous batching (serve/continuous.py, serve/server.py):
``make_continuous_request`` builds a pool Request through the feature
cache, or, with the pool's max_len as ``prefix_rope_hint``, a prefix-backed
one whose prefix K/V come from a device LRU of ``prefix_kv_cache_size``
entries (``prefix_kv_cached``).

Decode loops (decode, verify passes, beams) run through the engine's
``graphs`` (serve/graphs.StepGraphs): on the card each loop body is a CUDA
graph, captured at a key's second step and replayed afterwards, kept for
later requests of the same shapes (up to the runner's bound on the state it
keeps); ``with engine.graphs.eager():`` runs the same loops eagerly, the
comparison switch.

``GenerateConfig.num_beams > 1`` runs beam search (serve/beam.py) in
``generate`` and the routes built on it (run, run_frames, run_batch,
run_stream), on a cache in the activations' dtype whatever
``quantize_cache`` says; the feature-cached and prefix routes refuse it, as
the JAX engine's do.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..core.config import GenerateConfig, VLMConfig
from ..ops.int8_matmul import Int8Embedding
from ..models import vlm
from ..obs.profiler import record
from ..ops.preprocess import dual_stream_resize_host
from ..text import codec
from ..text.templates import (DEFAULT_IMAGE_TOKEN, GROUNDING_TOKEN,
                              IMAGE_TOKEN_INDEX, get_template)
from ..text.tokenizer import pad_batch_generate, tokenize_with_image
from ..train.lora import merge_lora
from ..video.reader import read_frames
from .beam import beam_search_tokens
from .calibrate import calibrate_and_apply
from .generate import (_ceil128, _PhaseClock, build_prefix_kv, decode_texts,
                       generate_tokens, generate_tokens_from_features,
                       generate_tokens_from_prefix)
from .graphs import StepGraphs
from .quantize import (is_quantized, quantize_clip_for_serving,
                       quantize_llm_for_serving,
                       quantize_video_encoder_for_serving)
from .speculative import (generate_tokens_spec,
                          generate_tokens_spec_from_features,
                          generate_tokens_spec_from_prefix)


@dataclasses.dataclass
class InferenceResult:
    text: str
    parsed: str
    duration: float
    intervals: List[tuple]


class InferenceEngine:
    def __init__(self, params, cfg: VLMConfig, tokenizer,
                 gen_cfg: Optional[GenerateConfig] = None, seed: int = 42,
                 device=None, quantize: Optional[str] = None,
                 static_scales: bool = False, feature_cache_size: int = 8,
                 prefix_cache: bool = False, prefix_kv_cache_size: int = 2):
        if quantize not in (None, "int8", "int8_full"):
            raise ValueError(f"quantize={quantize!r}: expected None, 'int8' "
                             "or 'int8_full'")
        if static_scales and quantize != "int8_full":
            raise ValueError(
                "static_scales=True calibrates the W8A8 encoders' activation "
                f"scales and needs quantize='int8_full', got {quantize!r}")
        if quantize:
            params = dict(params)
            if not is_quantized(params["llm"]["lm_head"]):
                # a LoRA overlay is folded into the base kernels first, as
                # the JAX engine does; bf16 serving keeps the overlay
                params["llm"] = quantize_llm_for_serving(
                    merge_lora(params["llm"]), w8a8=quantize == "int8_full")
            if (quantize == "int8_full" and not is_quantized(
                    params["clip"]["layers"]["q"]["kernel"])):
                params["video_encoder"] = quantize_video_encoder_for_serving(
                    params["video_encoder"])
                params["clip"] = quantize_clip_for_serving(params["clip"])
        self.params = params
        self._static_scales_pending = static_scales
        self.calibrations = 0
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.gen_cfg = gen_cfg or GenerateConfig()
        self.template = get_template(cfg.llm_name)
        embed = params["llm"]["embed"]
        self.device = torch.device(
            device if device is not None
            else (embed.q if isinstance(embed, Int8Embedding)
                  else embed).device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.graphs = StepGraphs()
        self.last_timings: dict = {}
        self.last_tokens = None
        # host-feature LRU (encode_video_cached): (path, mtime, size) →
        # (features [NV, H] on the host, duration); 0 disables it
        self.feature_cache_size = feature_cache_size
        self._feature_cache: OrderedDict = OrderedDict()
        # evaluation's repeated videos through run_stream_prefix
        # (serve/eval._run_items)
        self.prefix_cache = prefix_cache
        # prefix-KV LRU of continuous batching (prefix_kv_cached): device
        # bf16 K/V, ~1.4 GB an entry at Phi-3.5's width
        self.prefix_kv_cache_size = prefix_kv_cache_size
        self._prefix_cache: OrderedDict = OrderedDict()

    # -- input construction -------------------------------------------------

    def build_prompt(self, prompt: str, mode: str, duration: float) -> str:
        assert mode in ("qa", "grounding", "referring")
        if mode == "grounding":
            q = DEFAULT_IMAGE_TOKEN + " " + GROUNDING_TOKEN + "\n" + prompt
        elif mode == "referring":
            q = DEFAULT_IMAGE_TOKEN + "\n" + codec.encode_referring_query(
                prompt, duration, self.cfg.num_temporal_tokens)
        else:
            q = DEFAULT_IMAGE_TOKEN + "\n" + prompt
        conv = [{"from": "human", "value": q}, {"from": "gpt", "value": ""}]
        return self.template.encode_for_generation(conv)

    def tokenize_prompt(self, text_prompt: str) -> List[int]:
        """Token ids of a built prompt, its <image> slot as
        IMAGE_TOKEN_INDEX."""
        return tokenize_with_image(text_prompt, self.tokenizer)

    def preprocess_frames(self, frames: np.ndarray):
        """uint8 [F, H, W, 3] → (temporal [F,224,224,3], spatial
        [segs,336,336,3]) uint8; normalization runs on the device."""
        return dual_stream_resize_host(
            frames, self.cfg.num_segs, self.cfg.temporal_image_size,
            self.cfg.spatial_image_size)

    def preprocess_video(self, video_path: str):
        vf = read_frames(video_path, self.cfg.num_frames, sample="middle")
        temporal, spatial = self.preprocess_frames(vf.frames)
        return temporal, spatial, vf.duration

    def _maybe_calibrate(self, temporal: np.ndarray) -> None:
        """First-request static-scale calibration (``static_scales=True``):
        record the trunk's activation maxima on these pixels and swap in
        the encoder tree with static x_scales."""
        if not self._static_scales_pending:
            return
        self._static_scales_pending = False
        batch = temporal if temporal.ndim == 5 else temporal[None]
        self.params = calibrate_and_apply(self.params, self.cfg, [batch])
        self.calibrations += 1

    # -- generation ---------------------------------------------------------

    def generate(self, prompts: List[str], temporal: np.ndarray,
                 spatial: np.ndarray,
                 gen_cfg: Optional[GenerateConfig] = None) -> List[str]:
        """temporal [B,F,224,224,3], spatial [B,segs,336,336,3] (or unbatched
        [F,...] / [segs,...] shared by every prompt)."""
        g = gen_cfg or self.gen_cfg
        B = len(prompts)
        if temporal.ndim == 4:
            temporal = np.broadcast_to(temporal[None], (B, *temporal.shape))
        if spatial.ndim == 4:
            spatial = np.broadcast_to(spatial[None], (B, *spatial.shape))
        input_ids, attn_mask = self._batch_ids(prompts)
        self.last_timings = timings = {}
        if self._static_scales_pending:
            t0 = time.perf_counter()
            self._maybe_calibrate(temporal)    # ends on a device→host copy
            timings["calibrate"] = time.perf_counter() - t0
        args = (self.params, self.cfg, self._dev(input_ids).long(),
                self._dev(attn_mask).long(), self._dev(spatial),
                self._dev(temporal), self.generator)
        kw = self._gen_kwargs(g, timings)
        if g.num_beams > 1:
            tokens, lengths = beam_search_tokens(
                *args[:-1], max_new_tokens=g.max_new_tokens,
                num_beams=g.num_beams, eos_token_id=kw["eos_token_id"],
                pad_token_id=kw["pad_token_id"], timings=timings,
                graphs=self.graphs)
        elif g.spec_draft_len > 0:
            # greedy emits the model's own argmax whatever the drafts;
            # sampling uses the delta-draft rejection rule
            tokens, lengths = generate_tokens_spec(
                *args, draft_len=g.spec_draft_len, **kw)
        else:
            tokens, lengths = generate_tokens(
                *args, quantize_cache=g.quantize_cache, **kw)
        self._note_tokens(timings, tokens, lengths, input_ids.shape[1])
        self.last_tokens = (tokens.cpu(), lengths.cpu())
        return self._texts(tokens, lengths)

    # -- helpers shared by the generation routes ----------------------------

    def _dev(self, a) -> torch.Tensor:
        """A host array or tensor on the engine's device (np.array copies:
        broadcast views are read-only)."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.from_numpy(np.array(a)).to(self.device)

    def _batch_ids(self, prompts: List[str]):
        seqs = [self.tokenize_prompt(p) for p in prompts]
        return pad_batch_generate(seqs, self.tokenizer.pad_token_id,
                                  self.cfg.max_txt_len)

    def _gen_kwargs(self, g: GenerateConfig, timings: dict) -> dict:
        return dict(max_new_tokens=g.max_new_tokens,
                    temperature=g.temperature, top_p=g.top_p,
                    do_sample=g.do_sample,
                    eos_token_id=self.tokenizer.eos_token_id,
                    pad_token_id=self.tokenizer.pad_token_id,
                    timings=timings, graphs=self.graphs)

    @staticmethod
    def _note_tokens(timings: dict, tokens, lengths, prompt_len: int):
        """The longest prompt and generation of a call, over its batches."""
        timings["new_tokens"] = max(timings.get("new_tokens", 0),
                                    int(lengths.max()))
        timings["prompt_len"] = max(timings.get("prompt_len", 0),
                                    int(prompt_len))

    def _texts(self, tokens, lengths) -> List[str]:
        return decode_texts(self.tokenizer, tokens, lengths,
                            self.tokenizer.eos_token_id)

    # -- batched serving ----------------------------------------------------

    def generate_prepped(self, prepped, prompts: List[str], mode: str = "qa",
                         gen_cfg: Optional[GenerateConfig] = None,
                         pad_to: Optional[int] = None
                         ) -> List[InferenceResult]:
        """One batch from preprocessed videos: prepped is a list of
        (temporal, spatial, duration) from preprocess_video. pad_to pads
        the batch to that size by repeating the last video and prompt (one
        batch shape for a stream); padded rows are dropped."""
        n = len(prepped)
        if n == 0 or n != len(prompts):
            raise ValueError(f"generate_prepped takes one prompt per video, "
                             f"got {n} videos and {len(prompts)} prompts")
        if pad_to is not None and pad_to > n:
            prepped = list(prepped) + [prepped[-1]] * (pad_to - n)
            prompts = list(prompts) + [prompts[-1]] * (pad_to - n)
        durations = [p[2] for p in prepped]
        texts = self.generate(
            [self.build_prompt(p, mode, d) for p, d in zip(prompts, durations)],
            np.stack([p[0] for p in prepped]),
            np.stack([p[1] for p in prepped]), gen_cfg)
        tokens, lengths = self.last_tokens
        self.last_tokens = (tokens[:n], lengths[:n])
        return [self._result(t, d) for t, d in zip(texts[:n], durations[:n])]

    def run_batch(self, video_paths: List[str], prompts: List[str],
                  mode: str = "qa", gen_cfg: Optional[GenerateConfig] = None,
                  decode_workers: int = 4) -> List[InferenceResult]:
        """The videos decoded and resized on host threads, then one batched
        request."""
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=decode_workers) as pool:
            prep = list(pool.map(self.preprocess_video, video_paths))
        preprocess_s = time.perf_counter() - t0
        out = self.generate_prepped(prep, prompts, mode, gen_cfg)
        self.last_timings["preprocess"] = preprocess_s
        return out

    def run_stream(self, video_paths: List[str], prompts: List[str],
                   mode: str = "qa", batch_size: int = 6,
                   gen_cfg: Optional[GenerateConfig] = None,
                   decode_workers: int = 4,
                   pad_last: bool = True) -> List[InferenceResult]:
        """Requests in batches of batch_size, in order: the host decode and
        resize of batch i + 1 run on threads while the device works on
        batch i. The last partial batch pads to batch_size by repeating its
        last row (pad_last)."""
        _check_pairs(video_paths, prompts)
        chunks = [(video_paths[i:i + batch_size], prompts[i:i + batch_size])
                  for i in range(0, len(video_paths), batch_size)]
        results: List[InferenceResult] = []
        timings: dict = {}
        rows = []
        with ThreadPoolExecutor(max_workers=decode_workers) as pool:
            def submit(vids):
                return [pool.submit(self.preprocess_video, v) for v in vids]

            pending = submit(chunks[0][0]) if chunks else []
            for ci, (vids, prmpts) in enumerate(chunks):
                prep = [_wait(f, timings) for f in pending]
                if ci + 1 < len(chunks):
                    pending = submit(chunks[ci + 1][0])  # under the device
                pad_to = (batch_size if pad_last and len(prep) < batch_size
                          else None)
                results.extend(self.generate_prepped(prep, prmpts, mode,
                                                     gen_cfg, pad_to=pad_to))
                _merge_timings(timings, self.last_timings)
                rows.extend(zip(*self.last_tokens))
        self._finish(timings, rows)
        return results

    # -- feature cache: each unique video encoded once ----------------------

    @staticmethod
    def _video_key(path: str):
        st = os.stat(path)
        return (path, st.st_mtime_ns, st.st_size)

    def _is_cached(self, path: str) -> bool:
        try:
            return self._video_key(path) in self._feature_cache
        except OSError:
            return False

    def encode_features(self, temporal: np.ndarray,
                        spatial: np.ndarray) -> torch.Tensor:
        """One video's encode on the device (a pending static-scale
        calibration first) → its features [NV, H] on the host."""
        self._maybe_calibrate(temporal)
        with torch.inference_mode():
            feats = vlm.encode_video(self.params, self.cfg,
                                     self._dev(spatial[None]),
                                     self._dev(temporal[None]))
        return feats[0].cpu()

    def encode_video_cached(self, video_path: str, prepped=None,
                            timings: Optional[dict] = None,
                            span_log=None, request_id=None):
        """(features [NV, H] on the host, duration) of a video through the
        LRU, keyed on path, mtime and size (an overwritten file encodes
        anew). prepped: (temporal, spatial, duration) already decoded, for
        callers that prefetched the host decode. timings gets
        feature_lookups and feature_hits, encode and encodes, and
        preprocess and preprocesses for a decode done here; span_log
        (obs/profiler.SpanLog) the spans engine.preprocess and
        engine.encode."""
        key = self._video_key(video_path)
        hit = self._feature_cache.get(key)
        _add(timings, "feature_lookups", 1)
        if hit is not None:
            _add(timings, "feature_hits", 1)
            self._feature_cache.move_to_end(key)
            return hit
        if prepped is None:
            t0 = time.perf_counter_ns()
            prepped = self.preprocess_video(video_path)
            record(timings, "preprocess", t0, count="preprocesses",
                   log=span_log, name="engine.preprocess",
                   request_id=request_id)
        temporal, spatial, duration = prepped
        t0 = time.perf_counter_ns()
        # ends on the device→host copy of the features
        entry = (self.encode_features(temporal, spatial), duration)
        record(timings, "encode", t0, count="encodes", log=span_log,
               name="engine.encode", request_id=request_id)
        if self.feature_cache_size > 0:
            self._feature_cache[key] = entry
            while len(self._feature_cache) > self.feature_cache_size:
                self._feature_cache.popitem(last=False)
        return entry

    def _from_features(self, prompts: List[str], features,
                       g: GenerateConfig, timings: dict):
        """One batch from video features [B, NV, H] (or [NV, H] for every
        prompt), moved to the device once → (tokens, lengths)."""
        if g.num_beams > 1:
            raise NotImplementedError(
                "feature-cached generation does not support beam search; "
                "use generate()")
        feats = torch.as_tensor(features)
        if feats.dim() == 2:
            feats = feats[None].expand(len(prompts), *feats.shape)
        input_ids, attn_mask = self._batch_ids(prompts)
        args = (self.params, self.cfg, self._dev(input_ids).long(),
                self._dev(attn_mask).long(), feats.to(self.device),
                self.generator)
        kw = self._gen_kwargs(g, timings)
        if g.spec_draft_len > 0:
            tokens, lengths = generate_tokens_spec_from_features(
                *args, draft_len=g.spec_draft_len, **kw)
        else:
            tokens, lengths = generate_tokens_from_features(
                *args, quantize_cache=g.quantize_cache, **kw)
        self._note_tokens(timings, tokens, lengths, input_ids.shape[1])
        return tokens, lengths

    def generate_from_features(self, prompts: List[str], features,
                               gen_cfg: Optional[GenerateConfig] = None
                               ) -> List[str]:
        """generate() from video features [B, NV, H] (or [NV, H] for every
        prompt) from encode_features or encode_video_cached; lockstep or
        speculative."""
        self.last_timings = timings = {}
        tokens, lengths = self._from_features(prompts, features,
                                              gen_cfg or self.gen_cfg,
                                              timings)
        self.last_tokens = (tokens.cpu(), lengths.cpu())
        return self._texts(tokens, lengths)

    def _collect(self, idxs, tokens, lengths, durations, results, rows):
        """A batch's first len(idxs) rows into results and rows at their
        input positions."""
        k = len(idxs)
        texts = self._texts(tokens[:k], lengths[:k])
        tokens, lengths = tokens.cpu(), lengths.cpu()
        for j, (i, text, d) in enumerate(zip(idxs, texts, durations)):
            results[i] = self._result(text, d)
            rows[i] = (tokens[j], lengths[j])

    def _finish(self, timings: dict, rows) -> None:
        self.last_timings = timings
        if rows:
            self.last_tokens = (torch.stack([r[0] for r in rows]),
                                torch.stack([r[1] for r in rows]))

    def run_stream_cached(self, video_paths: List[str], prompts: List[str],
                          mode: str = "qa", batch_size: int = 6,
                          gen_cfg: Optional[GenerateConfig] = None,
                          decode_workers: int = 4,
                          sort_by_video: bool = True,
                          pad_last: bool = True) -> List[InferenceResult]:
        """Feature-cached streaming: each unique video is encoded once and
        the queries batch over the cached features. Queries are stably
        sorted by video path (sort_by_video), so one video's queries share
        batches; results come back in input order. The host decode of the
        next batch's uncached videos runs on threads under the current
        batch's device work. The last partial batch pads to batch_size by
        repeating its last row (pad_last)."""
        g = gen_cfg or self.gen_cfg
        n = _check_pairs(video_paths, prompts)
        order = (sorted(range(n), key=lambda i: video_paths[i])
                 if sort_by_video else list(range(n)))
        chunks = [order[i:i + batch_size] for i in range(0, n, batch_size)]
        results: List[Optional[InferenceResult]] = [None] * n
        rows: list = [None] * n
        timings: dict = {}
        with ThreadPoolExecutor(max_workers=decode_workers) as pool:
            def prefetch(chunk) -> dict:
                futs = {}
                for i in chunk:
                    p = video_paths[i]
                    if p not in futs and not self._is_cached(p):
                        futs[p] = pool.submit(self.preprocess_video, p)
                return futs

            pending = prefetch(chunks[0]) if chunks else {}
            for ci, chunk in enumerate(chunks):
                prep = pending
                if ci + 1 < len(chunks):
                    pending = prefetch(chunks[ci + 1])   # under the device
                feats, durations = [], []
                for i in chunk:
                    fut = prep.pop(video_paths[i], None)
                    f, d = self.encode_video_cached(
                        video_paths[i],
                        prepped=None if fut is None else _wait(fut, timings),
                        timings=timings)
                    feats.append(f)
                    durations.append(d)
                text_prompts = [self.build_prompt(prompts[i], mode, d)
                                for i, d in zip(chunk, durations)]
                fb = torch.stack(feats)
                k = len(chunk)
                if pad_last and k < batch_size:
                    fb = torch.cat([fb, fb[-1:].expand(batch_size - k,
                                                       *fb.shape[1:])])
                    text_prompts += [text_prompts[-1]] * (batch_size - k)
                tokens, lengths = self._from_features(text_prompts, fb, g,
                                                      timings)
                self._collect(chunk, tokens, lengths, durations, results,
                              rows)
        self._finish(timings, rows)
        return results

    # -- prefix-KV serving ----------------------------------------------------

    def _pad_bucket_batch(self, seqs, prompt_len: int):
        """Left-pad token lists to exactly prompt_len → ids, mask [k,
        prompt_len] (pad_batch_generate pads to the longest); longer lists
        keep their tail."""
        input_ids, attn_mask = pad_batch_generate(
            seqs, self.tokenizer.pad_token_id, prompt_len)
        short = prompt_len - input_ids.shape[1]
        if short > 0:
            k = input_ids.shape[0]
            input_ids = np.concatenate(
                [np.full((k, short), self.tokenizer.pad_token_id, np.int32),
                 input_ids], axis=1)
            attn_mask = np.concatenate(
                [np.zeros((k, short), np.int32), attn_mask], axis=1)
        return input_ids, attn_mask

    def _pad_bucket(self, seq, prompt_len: int):
        """One token list left-padded to exactly prompt_len → ids, mask
        [prompt_len]."""
        input_ids, attn_mask = self._pad_bucket_batch([seq], prompt_len)
        return input_ids[0], attn_mask[0]

    def prefix_kv_cached(self, video_path: str, pre_ids, features,
                         rope_hint: int, timings: Optional[dict] = None,
                         span_log=None, request_id=None):
        """The bf16 prefix K/V (build_prefix_kv: k, v, mask on the device)
        of a video's [pre-image text | video tokens] head through an LRU of
        prefix_kv_cache_size entries, keyed on the video file's stat, the
        pre-image ids and the hint. Eviction does not free a prefix that a
        queued Request still holds. timings gets prefix_lookups and
        prefix_hits, prefix and prefixes (the builds); span_log the span
        engine.prefix."""
        try:
            vid_key = self._video_key(video_path)
        except OSError:
            vid_key = (video_path,)
        key = (vid_key, tuple(pre_ids), rope_hint)
        hit = self._prefix_cache.get(key)
        _add(timings, "prefix_lookups", 1)
        if hit is not None:
            _add(timings, "prefix_hits", 1)
            self._prefix_cache.move_to_end(key)
            return hit
        t0 = time.perf_counter_ns()
        pre = torch.tensor([list(pre_ids)], device=self.device)
        entry = build_prefix_kv(self.params, self.cfg, pre,
                                torch.ones_like(pre),
                                self._dev(torch.as_tensor(features)[None]),
                                rope_hint)
        record(timings, "prefix", t0, count="prefixes", log=span_log,
               name="engine.prefix", request_id=request_id)
        self._prefix_cache[key] = entry
        while len(self._prefix_cache) > max(1, self.prefix_kv_cache_size):
            self._prefix_cache.popitem(last=False)
        return entry

    def make_continuous_request(self, video_path: str, prompt: str,
                                mode: str = "qa", prompt_len: int = 64,
                                max_new_tokens: Optional[int] = None,
                                on_token=None,
                                prefix_rope_hint: Optional[int] = None,
                                timings: Optional[dict] = None,
                                span_log=None,
                                request_id: Optional[int] = None,
                                prepped=None):
        """→ (a feature-backed continuous-batching Request, the video's
        duration): the features come through the feature cache, so a
        repeated video skips the encoders at admission; the prompt is
        left-padded to the prompt_len bucket, and a prompt whose <image>
        slot the bucket would cut raises.

        prepped: the video's (temporal, spatial, duration), decoded and
        resized by the caller (ServingFrontend.submit does so outside its
        lock), for the encode on a feature-cache miss; dropped on a hit.
        Without it a miss decodes and resizes here, inside the caller's
        critical section. Everything this call runs needs the caller's
        serialisation: the LRUs, the encode, the tokenizer, the prefix
        build.

        prefix_rope_hint (the pool's max_len): a prefix-backed Request
        instead, the video's [system | video tokens] head from
        prefix_kv_cached and only the post-image question chunk in the
        bucket; same-video requests share the prefix tensors.

        timings gets the caches' counters (encode_video_cached,
        prefix_kv_cached) and tokenize seconds; span_log their spans and
        engine.tokenize, marked with request_id, which the Request
        carries."""
        from .continuous import Request

        trace = dict(span_log=span_log, request_id=request_id)
        features, duration = self.encode_video_cached(
            video_path, prepped=prepped, timings=timings, **trace)
        t0 = time.perf_counter_ns()
        seq = self.tokenize_prompt(self.build_prompt(prompt, mode, duration))
        record(timings, "tokenize", t0, log=span_log, name="engine.tokenize",
               request_id=request_id)
        if prefix_rope_hint is not None:
            img = seq.index(IMAGE_TOKEN_INDEX)
            prefix = self.prefix_kv_cached(video_path, seq[:img], features,
                                           prefix_rope_hint, timings, **trace)
            input_ids, attn_mask = self._pad_bucket(seq[img + 1:], prompt_len)
            return Request(input_ids=input_ids, attn_mask=attn_mask,
                           spatial_pixels=None, temporal_pixels=None,
                           max_new_tokens=max_new_tokens, on_token=on_token,
                           prefix=prefix, request_id=request_id), duration
        input_ids, attn_mask = self._pad_bucket(seq, prompt_len)
        if not np.any(input_ids == IMAGE_TOKEN_INDEX):
            # the tail-keeping cut dropped the image slot: the splice would
            # put the video at slot 0
            raise ValueError(
                f"prompt ({len(seq)} tokens) overflows the prompt_len="
                f"{prompt_len} bucket past the <image> token; raise the "
                "server's prompt_len (or enable prefix_cache, which keeps "
                "the pre-image head out of the bucket)")
        return Request(input_ids=input_ids, attn_mask=attn_mask,
                       spatial_pixels=None, temporal_pixels=None,
                       max_new_tokens=max_new_tokens, on_token=on_token,
                       features=features, request_id=request_id), duration

    def run_stream_prefix(self, video_paths: List[str], prompts: List[str],
                          mode: str = "qa", batch_size: int = 6,
                          gen_cfg: Optional[GenerateConfig] = None,
                          question_len: int = 64,
                          decode_workers: int = 4) -> List[InferenceResult]:
        """Prefix-KV streaming: per unique video, the encode (feature cache)
        and the prefill of the shared [pre-image text | video tokens] head
        run once (build_prefix_kv); its queries then run in batches of
        batch_size (the last padded by repeating) as a question-chunk
        prefill, the chunk left-padded to question_len (a longer one keeps
        its tail), and a decode: the cascade (decode_step_shared) with
        quantize_cache, generate_tokens_spec_from_prefix with
        spec_draft_len. Where the pre-image text differs within a video's
        queries, they run through generate_from_features instead. The bf16
        prefix lives on the device only for its video's batches. One
        LongRoPE hint, draft margin included, builds the prefix and runs the
        continuation. Results come back in input order."""
        g = gen_cfg or self.gen_cfg
        if g.num_beams > 1:
            raise NotImplementedError(
                "prefix-cached streaming does not support beam search")
        n = _check_pairs(video_paths, prompts)
        groups: "OrderedDict[str, List[int]]" = OrderedDict()
        for i, p in enumerate(video_paths):
            groups.setdefault(p, []).append(i)
        order = list(groups)
        results: List[Optional[InferenceResult]] = [None] * n
        rows: list = [None] * n
        timings: dict = {}
        margin = g.spec_draft_len + 1 if g.spec_draft_len > 0 else 0
        with ThreadPoolExecutor(max_workers=decode_workers) as pool:
            def prefetch(path):
                return (None if self._is_cached(path)
                        else pool.submit(self.preprocess_video, path))

            futs = {order[0]: prefetch(order[0])} if order else {}
            for gi, path in enumerate(order):
                if gi + 1 < len(order):
                    futs[order[gi + 1]] = prefetch(order[gi + 1])
                fut = futs.pop(path, None)
                features, duration = self.encode_video_cached(
                    path, prepped=None if fut is None else _wait(fut, timings),
                    timings=timings)
                idxs = groups[path]
                text_prompts = [self.build_prompt(prompts[i], mode, duration)
                                for i in idxs]
                seqs = [self.tokenize_prompt(p) for p in text_prompts]
                img_at = [s.index(IMAGE_TOKEN_INDEX) for s in seqs]
                pre = seqs[0][:img_at[0]]
                shared = all(s[:a] == pre for s, a in zip(seqs, img_at))
                if shared:
                    Sp = len(pre) + self.cfg.num_video_tokens
                    rope_hint = _ceil128(Sp + question_len
                                         + g.max_new_tokens + margin)
                    clock = _PhaseClock(timings, self.device)
                    pre_ids = torch.tensor([pre], device=self.device)
                    prefix = build_prefix_kv(
                        self.params, self.cfg, pre_ids,
                        torch.ones_like(pre_ids), self._dev(features[None]),
                        rope_hint)
                    clock.mark("prefix")
                    clock.count("prefixes", 1)
                for c0 in range(0, len(idxs), batch_size):
                    chunk = idxs[c0:c0 + batch_size]
                    pad = batch_size - len(chunk)
                    if not shared:
                        ps = text_prompts[c0:c0 + batch_size]
                        tokens, lengths = self._from_features(
                            ps + [ps[-1]] * pad, features, g, timings)
                    else:
                        posts = [s[a + 1:] for s, a in
                                 zip(seqs[c0:c0 + batch_size],
                                     img_at[c0:c0 + batch_size])]
                        ids, mask = self._pad_bucket_batch(
                            posts + [posts[-1]] * pad, question_len)
                        args = (self.params, self.cfg, self._dev(ids).long(),
                                self._dev(mask).long(), *prefix,
                                self.generator)
                        kw = self._gen_kwargs(g, timings)
                        if g.spec_draft_len > 0:
                            tokens, lengths = generate_tokens_spec_from_prefix(
                                *args, draft_len=g.spec_draft_len,
                                rope_hint=rope_hint, **kw)
                        else:
                            tokens, lengths = generate_tokens_from_prefix(
                                *args, quantize_cache=g.quantize_cache,
                                shared_prefix=g.quantize_cache,
                                rope_hint=rope_hint, **kw)
                        self._note_tokens(timings, tokens, lengths,
                                          question_len)
                    self._collect(chunk, tokens, lengths,
                                  [duration] * len(chunk), results, rows)
                prefix = None          # freed before the next video's
        self._finish(timings, rows)
        return results

    def _result(self, text: str, duration: float) -> InferenceResult:
        parsed = codec.parse_time_interval(
            text, duration, self.cfg.num_temporal_tokens, self.cfg.llm_name)
        intervals = codec.extract_intervals(
            text, duration, self.cfg.num_temporal_tokens)
        return InferenceResult(text, parsed, duration, intervals)

    def run_frames(self, frames: np.ndarray, duration: float, prompt: str,
                   mode: str = "qa",
                   gen_cfg: Optional[GenerateConfig] = None
                   ) -> InferenceResult:
        """One request from decoded frames uint8 [F, H, W, 3]."""
        t0 = time.perf_counter()
        temporal, spatial = self.preprocess_frames(frames)
        preprocess_s = time.perf_counter() - t0
        text_prompt = self.build_prompt(prompt, mode, duration)
        texts = self.generate([text_prompt], temporal, spatial, gen_cfg)
        self.last_timings["preprocess"] = preprocess_s
        return self._result(texts[0], duration)

    def run(self, video_path: str, prompt: str, mode: str = "qa",
            gen_cfg: Optional[GenerateConfig] = None) -> InferenceResult:
        vf = read_frames(video_path, self.cfg.num_frames, sample="middle")
        return self.run_frames(vf.frames, vf.duration, prompt, mode, gen_cfg)


def _check_pairs(video_paths: List[str], prompts: List[str]) -> int:
    if len(video_paths) != len(prompts):
        raise ValueError(f"one prompt per video: got {len(video_paths)} "
                         f"videos and {len(prompts)} prompts")
    return len(video_paths)


def _add(timings: Optional[dict], key: str, value) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0) + value


def _wait(fut, timings: dict):
    """A prefetched host decode's result; the time spent waiting for it is
    host time not hidden under device work."""
    t0 = time.perf_counter()
    out = fut.result()
    _add(timings, "preprocess", time.perf_counter() - t0)
    return out


def _merge_timings(total: dict, timings: dict) -> None:
    """A batch's timings into a call's: phases and counts add up, the
    prompt and generation lengths keep their maximum."""
    for key, value in timings.items():
        if key in ("prompt_len", "new_tokens"):
            total[key] = max(total.get(key, 0), value)
        else:
            _add(total, key, value)
