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
engine does).

The LLM can also be built directly in serving int8, so that its bf16 stack
never exists whole on the device (cli/model_loading.build_params'
``quantize=``): ``init_llm_params_quantized`` draws the seeded random LLM
one layer slice at a time and quantizes each slice as it is drawn, and
``upload_llm_quantized`` quantizes a host tree (the reference's weight
files) a chunk of layers at a time. Both are bit-equal to
``quantize_llm_for_serving`` of the tree the bf16 route builds: the same
draws, rounded to the same dtype, quantized per slice as that function
quantizes them. (The JAX package's direct init folds its rng per layer, so
its values differ from its init-then-quantize; only its structure agrees.)
Peak device memory is the int8 tree plus one transient: a chunk of layers,
or a 2-d embed or lm_head leaf, which is drawn whole in fp32 as
models/param_utils.normal draws it and quantized _CHUNK rows or columns at
a time.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import LLMConfig
from ..models.convert import Stacked, leaf_shape
from ..models.param_utils import child_generator, normal_slices
from ..ops.int8_matmul import (Int8Embedding, Int8Weight, empty_int8_weight,
                               quantize_rows, quantize_weights_int8)

QUANT_KERNELS = ("qkv_kernel", "o_kernel", "gate_up_kernel", "down_kernel")
LLM_ENTRIES = ("embed", "layers", "final_norm_w", "lm_head")
_INIT_STD = 0.02    # models/llm.init_params' normal
# embedding rows or lm_head columns rounded and quantized at once (the
# quantization is per row or per column, so the chunking changes no bit)
_CHUNK = 16384


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


def _int8_stack(chunks, shape, device, dtype, w8a8: bool) -> Int8Weight:
    """A stacked [L, D, O] weight from fp32 chunks [n, D, O] in layer
    order, each moved to the device, rounded to dtype there and quantized
    layer by layer into one int8 buffer."""
    q = empty_int8_weight(shape, device)
    scale = torch.empty(shape[0], shape[-1], dtype=torch.float32,
                        device=device)
    i = 0
    for chunk in chunks:
        w = chunk.to(device).to(dtype)
        for j in range(w.shape[0]):
            scale[i] = quantize_weights_int8(w[j], out=q[i])[1]
            i += 1
    if i != shape[0]:
        raise ValueError(f"expected {shape[0]} layers, got {i}")
    return Int8Weight(q, scale, w8a8)


def _int8_embed(rows, shape, device, dtype) -> Int8Embedding:
    """The [V, D] embedding from rows(r0, r1) → fp32 [r1 - r0, D]."""
    V, D = shape
    q = torch.empty(V, D, dtype=torch.int8, device=device)
    scale = torch.empty(V, dtype=torch.float32, device=device)
    for r0 in range(0, V, _CHUNK):
        r1 = min(V, r0 + _CHUNK)
        qr, s = quantize_rows(rows(r0, r1).to(device).to(dtype))
        q[r0:r1] = qr
        scale[r0:r1] = s[:, 0]
    return Int8Embedding(q, scale)


def _int8_head(cols, shape, device, dtype) -> Int8Weight:
    """The [D, V] lm_head from cols(c0, c1) → fp32 [D, c1 - c0]."""
    D, V = shape
    q = empty_int8_weight(shape, device)
    scale = torch.empty(V, dtype=torch.float32, device=device)
    for c0 in range(0, V, _CHUNK):
        c1 = min(V, c0 + _CHUNK)
        scale[c0:c1] = quantize_weights_int8(
            cols(c0, c1).to(device).to(dtype), out=q[:, c0:c1])[1]
    return Int8Weight(q, scale)


def init_llm_params_quantized(cfg: LLMConfig, *, generator, device,
                              dtype=torch.bfloat16, w8a8: bool = False,
                              skip=frozenset()) -> dict:
    """The seeded random LLM directly in serving-int8 form: bit-equal to
    ``quantize_llm_for_serving(models.llm.init_params(cfg, generator=g,
    device=device, dtype=dtype), w8a8)`` for a generator g in the same
    state. It draws from the same child generators in the same order, each
    fp32 slice rounded to dtype and quantized before the next is drawn.
    skip: top-level entries (("embed",), ...) left on the meta device, as
    models/llm.init_params leaves them."""
    D, L = cfg.hidden_size, cfg.num_layers
    V = cfg.padded_vocab_size
    qkv_out = cfg.q_dim + 2 * cfg.kv_dim

    def entry(name, make):
        g = child_generator(generator, device)
        if (name,) in skip:
            return make(None, "meta")
        return make(g, device)

    def draw(shape, g, dev):
        return normal_slices(shape, _INIT_STD, generator=g, device=dev)

    def stack(shape, g, dev):
        return _int8_stack((w[None] for w in draw(shape, g, dev)), shape,
                           dev, dtype, w8a8)

    def embed(g, dev):
        w = next(draw((V, D), g, dev))
        return _int8_embed(lambda a, b: w[a:b], (V, D), dev, dtype)

    def head(g, dev):
        w = next(draw((D, V), g, dev))
        return _int8_head(lambda a, b: w[:, a:b], (D, V), dev, dtype)

    def ones(*shape, dev):
        return torch.ones(*shape, device=dev, dtype=dtype)

    return {
        "embed": entry("embed", embed),
        "layers": entry("layers", lambda g, dev: {
            "input_norm_w": ones(L, D, dev=dev),
            "qkv_kernel": stack((L, D, qkv_out), g, dev),
            "o_kernel": stack((L, cfg.q_dim, D), g, dev),
            "post_norm_w": ones(L, D, dev=dev),
            "gate_up_kernel": stack((L, D, 2 * cfg.intermediate_size), g,
                                    dev),
            "down_kernel": stack((L, cfg.intermediate_size, D), g, dev),
        }),
        "final_norm_w": entry("final_norm_w",
                              lambda g, dev: ones(D, dev=dev)),
        "lm_head": entry("lm_head", head),
    }


def init_vlm_params_serving(cfg, *, generator, device, w8a8: bool = False,
                            quantize_encoders: bool = False) -> dict:
    """The whole seeded serving tree in bf16: models/vlm.init_params with
    the LLM drawn by init_llm_params_quantized (no bf16 LLM stack), every
    other piece with the values of a plain init_params; the encoders
    quantized for W8A8 where quantize_encoders."""
    from ..models import vlm

    params = vlm.init_params(
        cfg, generator=generator, device=device, dtype=torch.bfloat16,
        llm_init=functools.partial(init_llm_params_quantized, w8a8=w8a8))
    if quantize_encoders:
        params["video_encoder"] = quantize_video_encoder_for_serving(
            params["video_encoder"])
        params["clip"] = quantize_clip_for_serving(params["clip"])
    return params


def _host_f32(leaf, a: int, b: int) -> torch.Tensor:
    """Leading rows a:b of a host leaf (numpy or models/convert.Stacked, any
    float dtype) as an fp32 host tensor."""
    if isinstance(leaf, Stacked):
        part = np.stack([leaf.slice(i) for i in range(a, b)])
    else:
        part = np.asarray(leaf)[a:b]
    return torch.from_numpy(np.ascontiguousarray(part, dtype=np.float32))


def upload_llm_quantized(host_llm: dict, w8a8: bool = False,
                         chunk_layers: int = 4, device=None,
                         dtype=torch.bfloat16) -> dict:
    """A host LLM tree (numpy or Stacked leaves, any float dtype) → the
    serving-int8 tree on ``device``: each projection stack goes
    chunk_layers layers at a time fp32 → device → dtype → its int8 buffer,
    the embed and lm_head _CHUNK rows or columns at a time, so the dtype
    stack never exists whole on the device. Bit-equal to
    quantize_llm_for_serving of the whole tree uploaded in dtype, for every
    chunk_layers. host_llm may hold only some of the top-level entries (a
    stage checkpoint's embed and lm_head); the result holds the same."""
    if chunk_layers < 1:
        raise ValueError(f"chunk_layers={chunk_layers}: expected >= 1")
    unknown = sorted(set(host_llm) - set(LLM_ENTRIES))
    if unknown:
        raise ValueError(f"upload_llm_quantized: unexpected entries "
                         f"{unknown}")

    def dense(leaf):
        return torch.from_numpy(np.array(leaf, dtype=np.float32)).to(
            device).to(dtype)

    def stack(leaf):
        shape = leaf_shape(leaf)
        chunks = (_host_f32(leaf, a, min(a + chunk_layers, shape[0]))
                  for a in range(0, shape[0], chunk_layers))
        return _int8_stack(chunks, shape, device, dtype, w8a8)

    out = {}
    for name, leaf in host_llm.items():
        if name == "embed":
            out[name] = _int8_embed(lambda a, b, x=leaf: _host_f32(x, a, b),
                                    leaf_shape(leaf), device, dtype)
        elif name == "lm_head":
            arr = np.asarray(leaf)
            out[name] = _int8_head(
                lambda a, b: torch.from_numpy(np.ascontiguousarray(
                    arr[:, a:b], dtype=np.float32)),
                arr.shape, device, dtype)
        elif name == "final_norm_w":
            out[name] = dense(leaf)
        else:
            if "lora" in leaf:
                raise ValueError("upload_llm_quantized: the tree still has "
                                 "LoRA adapters; merge them first")
            out[name] = {k: stack(v) if k in QUANT_KERNELS else dense(v)
                         for k, v in leaf.items()}
    return out
