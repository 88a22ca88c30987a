"""Model assembly for the entry points (port of
grounded_video_llm_tpu/cli/model_loading.py).

``build_params`` makes a seeded random VLM at the config's full width,
directly on the target device, with the JAX package's shapes and init
schemes. Loading the reference checkpoints (models/convert.py in the JAX
package) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import VLMConfig
from ..models import vlm
from ..text.tokenizer import load_tokenizer


def build_params(cfg: VLMConfig, device, dtype=torch.bfloat16,
                 seed: int = 42) -> dict:
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return vlm.init_params(cfg, generator=generator, device=device,
                           dtype=dtype)


def build_tokenizer(cfg: VLMConfig, tokenizer_path: Optional[str] = None,
                    expand: bool = True):
    return load_tokenizer(cfg.llm_name, tokenizer_path,
                          cfg.num_temporal_tokens, expand_vocab=expand)
