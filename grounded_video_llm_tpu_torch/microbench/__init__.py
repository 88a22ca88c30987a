"""The port's microbenchmarks, counterparts of the JAX package's TPU scripts
(scripts/microbench_{int8_gemm,decode,encoder_attn,static_scales}.py). Each
module runs on the card as

    python -m grounded_video_llm_tpu_torch.microbench.<name> [args]

and prints one line per variant, every number tagged with the card's name
and power limit; ``main(argv)`` returns the numbers. Without a CUDA device
they raise: a microbenchmark never falls back to the CPU.
"""
