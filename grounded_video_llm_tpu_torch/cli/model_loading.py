"""Model assembly for the entry points (port of
grounded_video_llm_tpu/cli/model_loading.py): the VLM tree from the
reference's weight dumps where they are given (reference
llava_next_video.py:117-162 load order), seeded random init for the rest.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core.config import VLMConfig
from ..models import convert
from ..models.from_jax import params_from_jax
from ..text.tokenizer import load_tokenizer


class StateDict(Mapping):
    """A torch state dict read as {name: float32 numpy}: each tensor stays
    in the file's dtype and is turned into float32 when it is read, so a
    converter that reads it a layer at a time holds one layer in float32
    (the values are those of a whole float32 copy)."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self._tensors = tensors

    def __getitem__(self, name: str) -> np.ndarray:
        return self._tensors[name].to(torch.float32).numpy()

    def __iter__(self):
        return iter(self._tensors)

    def __len__(self) -> int:
        return len(self._tensors)

    def update(self, other: "StateDict") -> None:
        self._tensors.update(other._tensors)


def load_sd(path: str) -> StateDict:
    """A reference weight file (a state dict, or one wrapped as
    {"model": ...} as the InternVideo2 release is), read on the host."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return StateDict({k: v for k, v in sd.items()
                      if isinstance(v, torch.Tensor)})


def read_weights(cfg: VLMConfig, weight_root: Optional[str] = None,
                 video_encoder_path: Optional[str] = None,
                 stage_ckpt: Optional[str] = None) -> Dict:
    """The pieces the given files hold, as a partial tree in the JAX
    package's layout (numpy leaves; models/convert). weight_root mirrors
    the reference's *-seperated dirs: vision_model.pth,
    multi_modal_projector.pth, image_newline(s).pth and
    language_model_seperated/*.{bin,pth,pt}; video_encoder_path is the
    InternVideo2 .pt; stage_ckpt a split-by-module stage checkpoint, whose
    projectors, embed_tokens and lm_head replace the others'."""
    tree: Dict = {}
    if weight_root and os.path.isdir(weight_root):
        vt = os.path.join(weight_root, "vision_model.pth")
        if os.path.exists(vt):
            tree["clip"] = convert.convert_clip(load_sd(vt), cfg.clip)
        mm = os.path.join(weight_root, "multi_modal_projector.pth")
        if os.path.exists(mm):
            tree["mm_projector"] = convert.convert_projector(load_sd(mm),
                                                             cfg.llm_name)
        for nl_name in ("image_newlines.pth", "image_newline.pth"):
            nl = os.path.join(weight_root, nl_name)
            if os.path.exists(nl):
                tree["extras"] = convert.convert_extras(load_sd(nl),
                                                        cfg.llm_name)
                break
        lm_dir = os.path.join(weight_root, "language_model_seperated")
        if os.path.isdir(lm_dir):
            sd = StateDict({})
            for f in sorted(os.listdir(lm_dir)):
                if f.endswith((".bin", ".pth", ".pt")):
                    sd.update(load_sd(os.path.join(lm_dir, f)))
            if len(sd):
                tree["llm"] = convert.convert_llm(sd, cfg.llm)

    if video_encoder_path and os.path.exists(video_encoder_path):
        tree["video_encoder"] = convert.convert_internvideo2(
            load_sd(video_encoder_path), cfg.video)

    if stage_ckpt and os.path.exists(stage_ckpt):
        modules = ckpt.import_reference_pth(stage_ckpt)
        if "multi_modal_projector" in modules:
            tree["mm_projector"] = convert.convert_projector(
                modules["multi_modal_projector"], cfg.llm_name)
        if "video_projecter" in modules:
            tree["video_projector"] = convert.convert_video_projector(
                modules["video_projecter"])
        lm = modules.get("language_model", {})
        if "model.embed_tokens.weight" in lm:
            tree.setdefault("llm", {})["embed"] = lm[
                "model.embed_tokens.weight"]
        if "lm_head.weight" in lm:
            tree.setdefault("llm", {})["lm_head"] = np.ascontiguousarray(
                lm["lm_head.weight"].T)
    return tree


def build_params(cfg: VLMConfig, device, dtype=torch.bfloat16,
                 seed: int = 42, weight_root: Optional[str] = None,
                 video_encoder_path: Optional[str] = None,
                 stage_ckpt: Optional[str] = None) -> dict:
    """The VLM tree on ``device``: every piece the files hold (read_weights)
    as float32 rounded to ``dtype``, every other piece seeded random at the
    config's width, made directly on the device. A piece read from a file
    is never drawn at random first. The tree's vocabulary is the files'
    where they bring an embedding (models/from_jax._vocab_config)."""
    tree = read_weights(cfg, weight_root, video_encoder_path, stage_ckpt)
    return params_from_jax(tree, cfg, device, dtype, seed=seed)


def build_tokenizer(cfg: VLMConfig, tokenizer_path: Optional[str] = None,
                    expand: bool = True):
    return load_tokenizer(cfg.llm_name, tokenizer_path,
                          cfg.num_temporal_tokens, expand_vocab=expand)
