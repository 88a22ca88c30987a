"""int8 serving quantization (port of grounded_video_llm_tpu/serve/quantize.py).

``quantize_llm_for_serving`` turns each decoder projection (qkv / o /
gate_up / down) and the lm_head into an ``Int8Weight`` (int8 values,
per-output-channel fp32 scales) and the embedding table into an
``Int8Embedding`` (per-row scales). ``w8a8=True`` marks the decoder
projections for the engine's "int8_full" mode: prefill-sized GEMMs run W8A8
and the int8-cache decode kernel quantizes its rows too. The encoders'
W8A8 quantization covers every dense kernel of both trunks (they always run
W8A8 through ops/int8_matmul.matmul_any, so they carry no marker, as in the
JAX tree); attention, norms, LayerScale, patch embeddings and positions stay
as they were.

A tree that still carries LoRA adapters is refused, as the JAX function
asserts: the caller merges them first (``train/lora.merge_lora``; the
engine does). Initialising or uploading the LLM directly in
int8 form (the JAX package's route around a 16 GB chip) is not ported
either: a bf16 Phi-3.5 or llama-3-8B fits an 80 GB card before quantizing.
"""

from __future__ import annotations

from ..ops.int8_matmul import (Int8Embedding, Int8Weight, quantize_rows,
                               quantize_weights_int8)

QUANT_KERNELS = ("qkv_kernel", "o_kernel", "gate_up_kernel", "down_kernel")


def quantize_embed_int8(embed) -> Int8Embedding:
    """[V, D] → Int8Embedding(int8 [V, D], fp32 [V]), per-row absmax."""
    q, s = quantize_rows(embed)
    return Int8Embedding(q, s[:, 0])


def _int8(w, w8a8: bool = False) -> Int8Weight:
    q, s = quantize_weights_int8(w)
    return Int8Weight(q, s, w8a8)


def quantize_llm_for_serving(llm_params: dict, w8a8: bool = False) -> dict:
    """Weight-only int8 LLM; w8a8 marks the decoder projections for
    W8A8 (the engine's "int8_full")."""
    layers = dict(llm_params["layers"])
    if "lora" in layers:
        raise ValueError("quantize_llm_for_serving: the tree still has LoRA "
                         "adapters; fold them in with train.lora.merge_lora "
                         "first")
    for name in QUANT_KERNELS:
        layers[name] = _int8(layers[name], w8a8)
    out = dict(llm_params)
    out["layers"] = layers
    out["lm_head"] = _int8(llm_params["lm_head"])
    out["embed"] = quantize_embed_int8(llm_params["embed"])
    return out


def is_quantized(kernel) -> bool:
    return isinstance(kernel, (Int8Weight, Int8Embedding))


def _quantize_dense(d: dict) -> dict:
    out = dict(d)
    out["kernel"] = _int8(d["kernel"])
    return out


def quantize_video_encoder_for_serving(params: dict) -> dict:
    """W8A8 InternVideo2 trunk: qkv (a bare kernel), proj, fc1, fc2."""
    blocks = dict(params["blocks"])
    blocks["qkv_kernel"] = _int8(blocks["qkv_kernel"])
    for name in ("proj", "fc1", "fc2"):
        blocks[name] = _quantize_dense(blocks[name])
    out = dict(params)
    out["blocks"] = blocks
    return out


def quantize_clip_for_serving(params: dict) -> dict:
    """W8A8 CLIP ViT: q, k, v, o, fc1, fc2."""
    layers = dict(params["layers"])
    for name in ("q", "k", "v", "o", "fc1", "fc2"):
        layers[name] = _quantize_dense(layers[name])
    out = dict(params)
    out["layers"] = layers
    return out
