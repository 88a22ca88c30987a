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

Not ported yet: beam search, the feature and prefix caches and batched
streaming.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.config import GenerateConfig, VLMConfig
from ..ops.int8_matmul import Int8Embedding
from ..ops.preprocess import dual_stream_resize_host
from ..text import codec
from ..text.templates import (DEFAULT_IMAGE_TOKEN, GROUNDING_TOKEN,
                              get_template)
from ..text.tokenizer import pad_batch_generate, tokenize_with_image
from ..train.lora import merge_lora
from ..video.reader import read_frames
from .generate import decode_texts, generate_tokens
from .quantize import (is_quantized, quantize_clip_for_serving,
                       quantize_llm_for_serving,
                       quantize_video_encoder_for_serving)
from .calibrate import calibrate_and_apply
from .speculative import generate_tokens_spec


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
                 static_scales: bool = False):
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
        self.last_timings: dict = {}
        self.last_tokens = None

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
        if g.num_beams > 1:
            raise NotImplementedError(
                "num_beams > 1: beam search is not ported yet")
        B = len(prompts)
        if temporal.ndim == 4:
            temporal = np.broadcast_to(temporal[None], (B, *temporal.shape))
        if spatial.ndim == 4:
            spatial = np.broadcast_to(spatial[None], (B, *spatial.shape))
        seqs = [self.tokenize_prompt(p) for p in prompts]
        input_ids, attn_mask = pad_batch_generate(
            seqs, self.tokenizer.pad_token_id, self.cfg.max_txt_len)

        def dev(a):  # np.array copies: broadcast views are read-only
            return torch.from_numpy(np.array(a)).to(self.device)

        self.last_timings = timings = {}
        if self._static_scales_pending:
            t0 = time.perf_counter()
            self._maybe_calibrate(temporal)    # ends on a device→host copy
            timings["calibrate"] = time.perf_counter() - t0
        args = (self.params, self.cfg, dev(input_ids).long(),
                dev(attn_mask).long(), dev(spatial), dev(temporal),
                self.generator)
        kw = dict(max_new_tokens=g.max_new_tokens, temperature=g.temperature,
                  top_p=g.top_p, do_sample=g.do_sample,
                  eos_token_id=self.tokenizer.eos_token_id,
                  pad_token_id=self.tokenizer.pad_token_id, timings=timings)
        if g.spec_draft_len > 0:
            # greedy emits the model's own argmax whatever the drafts;
            # sampling uses the delta-draft rejection rule
            tokens, lengths = generate_tokens_spec(
                *args, draft_len=g.spec_draft_len, **kw)
        else:
            tokens, lengths = generate_tokens(
                *args, quantize_cache=g.quantize_cache, **kw)
        timings["new_tokens"] = int(lengths.max())
        self.last_tokens = (tokens.cpu(), lengths.cpu())
        timings["prompt_len"] = int(input_ids.shape[1])
        return decode_texts(self.tokenizer, tokens, lengths,
                            self.tokenizer.eos_token_id)

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
