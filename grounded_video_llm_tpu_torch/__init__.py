"""PyTorch / CUDA port of grounded_video_llm_tpu for one NVIDIA H100.

The JAX package beside this one is the reference every module here is tested
against. This package imports ``torch`` and never ``jax``, and no module of
the JAX package either: it keeps its own copies of the framework-free ones
(configs, templates, tokenizer, codec, frame sampling and reading, the native
decoder binding, the PIL-exact resize).

Layout mirrors the JAX package: ``ops/`` (normalization, rope, attention, the
kernel wrappers with their plain versions: flash attention, int8 matmuls, int8
decode attention, cache writes; ``cuda_build`` builds them), ``models/``
(encoders, LLM with bf16 and int8 caches, composite VLM, the JAX weight
bridge), ``serve/`` (generation, int8 quantization, the inference engine),
``cli/`` (parameter and tokenizer construction, the stage profiler),
``text/`` and ``video/`` (the copies). CUDA sources live in ``csrc/`` and are
built with ``nvcc`` at first use.
"""
