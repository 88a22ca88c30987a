"""Projector MLPs bridging vision features into the LLM embedding space (port
of grounded_video_llm_tpu/models/projectors.py).

  video_projector — Linear(1408→H_llm) → GELU → Linear(H_llm→H_llm)
  mm_projector    — phi3.5: Linear(4096→3072) → GELU → Linear(3072→3072)
                    llama3: Linear(1024→4096) → GELU → Linear(4096→4096)

Kernels are [D_in, D_out], as in the JAX package; a kernel sharded by
parallel/partitioning is gathered where it is used.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.partitioning import gather
from .param_utils import lecun_normal


def init_mlp_params(d_in: int, d_mid: int, d_out: int, *, generator, device,
                    dtype=torch.float32):
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "fc1": {"kernel": lecun_normal((d_in, d_mid), **kw),
                "bias": torch.zeros(d_mid, device=device, dtype=dtype)},
        "fc2": {"kernel": lecun_normal((d_mid, d_out), **kw),
                "bias": torch.zeros(d_out, device=device, dtype=dtype)},
    }


def mlp_project(params, x: torch.Tensor) -> torch.Tensor:
    h = x @ gather(params["fc1"]["kernel"]) + params["fc1"]["bias"]
    h = F.gelu(h, approximate="none")
    return h @ gather(params["fc2"]["kernel"]) + params["fc2"]["bias"]


def init_video_projector(llm_hidden: int, video_dim: int = 1408, **kw):
    return init_mlp_params(video_dim, llm_hidden, llm_hidden, **kw)


def init_mm_projector(llm_name: str, llm_hidden: int, clip_hidden: int = 1024,
                      **kw):
    if llm_name == "phi3.5":
        # input is 2x2-merged CLIP features: 4 * clip_hidden
        return init_mlp_params(4 * clip_hidden, llm_hidden, llm_hidden, **kw)
    return init_mlp_params(clip_hidden, llm_hidden, llm_hidden, **kw)
