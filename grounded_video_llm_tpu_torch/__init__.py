"""PyTorch / CUDA port of grounded_video_llm_tpu for one NVIDIA H100.

The JAX package beside this one is the reference every module here is tested
against. This package imports ``torch`` and never ``jax``; it reuses the JAX
package's framework-free modules (configs, templates, tokenizer, codec, frame
sampling, the PIL-exact resize) by import rather than by copy.

Layout mirrors the JAX package: ``ops/`` (normalization, rope, attention, the
flash-attention forward and its CUDA kernel), ``models/`` (encoders, LLM,
composite VLM, the JAX weight bridge), ``serve/`` (generation and the
inference engine) and ``cli/`` (parameter and tokenizer construction).
CUDA sources live in ``csrc/`` and are built with ``nvcc`` at first use.
"""
