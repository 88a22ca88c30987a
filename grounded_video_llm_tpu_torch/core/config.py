"""Typed configuration, shared with the JAX package.

The dataclasses in grounded_video_llm_tpu/core/config.py import no framework,
so the port uses them as they are; this module re-exports the names the port
and its entry points need.
"""

from grounded_video_llm_tpu.core.config import (  # noqa: F401
    CLIPVisionConfig, GenerateConfig, InternVideo2Config, LLMConfig,
    VLMConfig, micro_vlm_config, replace, vlm_config)
