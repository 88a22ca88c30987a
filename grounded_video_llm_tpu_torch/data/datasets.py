"""Dataset mixes: MixPretrain / MixGrounded / MixSFT (port of
grounded_video_llm_tpu/data/datasets.py; no framework code, the port's own
reader, codec, templates and host preprocessing).

Functional parity with reference datasets/mix_{pretrain,grounded,sft}.py:
  * annotation schema: {question_id, video_file, video_id, conversation,
    dataset_name} (reference mix_sft.py:50-57)
  * prompts rendered once at init via the chat template; grounded/sft prepend
    <timestamp_grounding> to questions whose answers carry timestamps
    (mix_sft.py:73-84); pretrain does not
  * __getitem__ decodes num_frames ('rand' for training), builds both pixel
    streams, and quantizes <float> answer timestamps against the *actual*
    decoded duration (mix_grounded.py:147)
  * decode-failure chain: primary → alternate backend → stock fallback video
    with a canned caption conversation (mix_sft.py:94-119)

Samples are plain dicts of numpy arrays; tokenization/padding happens in
collate (device-shape concerns stay out of the dataset).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ..ops.preprocess import dual_stream_preprocess_host
from ..text import codec
from ..text.templates import DEFAULT_IMAGE_TOKEN, get_template
from ..video.reader import read_frames_with_fallback

FALLBACK_CONVERSATION = [
    {"from": "human", "value": DEFAULT_IMAGE_TOKEN + "\n"
     + "Provide an overview of what happens."},
    {"from": "gpt", "value": "A man silently narrates his experience driving an audi."},
]


class MixDataset:
    """Map-style dataset over a JSON annotation list."""

    #: stage behavior switches
    mark_grounding = False      # prepend <timestamp_grounding> (grounded/sft)
    quantize_answers = False    # <float> → <n> at getitem time

    def __init__(
        self,
        anno_path: str,
        video_path: str = "",
        num_frames: int = 96,
        num_segs: int = 12,
        num_temporal_tokens: int = 300,
        sample: str = "rand",
        llm: str = "phi3.5",
        fallback_video: str = "./experiments/video0.mp4",
        seed: int = 0,
    ):
        self.video_path = video_path
        self.num_frames = num_frames
        self.num_segs = num_segs
        self.num_temporal_tokens = num_temporal_tokens
        self.sample = sample
        self.fallback_video = fallback_video
        self.template = get_template(llm)
        self._rng = np.random.default_rng(seed)

        with open(anno_path) as f:
            data = json.load(f)

        self.video_ids: List[str] = []
        self.question_ids: List[str] = []
        self.video_files: List[str] = []
        self.text_inputs: List[str] = []
        self.dataset_names: List[str] = []
        for item in data:
            self.question_ids.append(str(item["question_id"]))
            self.video_files.append(str(item["video_file"]))
            self.video_ids.append(str(item["video_id"]))
            convs = item["conversation"]
            if self.mark_grounding:
                convs = codec.mark_grounding_conversations(convs)
            self.text_inputs.append(self.template.encode(convs))
            self.dataset_names.append(item.get("dataset_name", ""))

    def __len__(self) -> int:
        return len(self.video_ids)

    def set_epoch_rng(self, rng: np.random.Generator):
        """Install a worker/epoch-specific rng for 'rand' frame sampling
        (the analogue of reference train.py:59-67 worker seeding)."""
        self._rng = rng

    def __getitem__(self, index: int) -> Dict:
        video_id = self.video_ids[index]
        question_id = self.question_ids[index]
        text_input = self.text_inputs[index]
        video_file = os.path.join(self.video_path, self.video_files[index])
        dataset_name = self.dataset_names[index]

        vf, used_fallback = read_frames_with_fallback(
            video_file, self.num_frames, self.sample, self.fallback_video,
            rng=self._rng)
        if used_fallback:
            text_input = self.template.encode(FALLBACK_CONVERSATION)

        temporal, spatial = dual_stream_preprocess_host(
            vf.frames, self.num_segs)

        if self.quantize_answers and not used_fallback:
            text_input = codec.convert_time_position(
                text_input, vf.duration, self.num_temporal_tokens)

        return {
            "video_ids": video_id,
            "question_ids": question_id,
            "text_inputs": text_input,
            "temporal_pixel_values": temporal,   # [F, 224, 224, 3] f32
            "spatial_pixel_values": spatial,     # [segs, 336, 336, 3] f32
            "dataset_names": dataset_name,
            "durations": float(vf.duration),
        }


class MixPretrain(MixDataset):
    """Stage-1 captions: no grounding marks, no timestamp quantization
    (reference datasets/mix_pretrain.py)."""
    mark_grounding = False
    quantize_answers = False


class MixGrounded(MixDataset):
    """Stage-2 temporal grounding (reference datasets/mix_grounded.py)."""
    mark_grounding = True
    quantize_answers = True


class MixSFT(MixDataset):
    """Stage-3 instruction mix (reference datasets/mix_sft.py)."""
    mark_grounding = True
    quantize_answers = True


DATASETS = {"mix_pretrain": MixPretrain, "mix_grounded": MixGrounded,
            "mix_sft": MixSFT}
