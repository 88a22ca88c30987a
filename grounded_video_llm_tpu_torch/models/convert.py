"""Reference state dicts → parameter trees (port of
grounded_video_llm_tpu/models/convert.py).

Maps the reference's (HF-style) state-dict names onto the JAX package's
stacked-layer layout, which this package shares: the converters return
numpy trees exactly as the JAX converters do, and models/from_jax's bridge
places them on the device (cli/model_loading.build_params). Inputs are flat
{name: array} mappings (core/checkpoint.import_reference_pth, or
cli/model_loading.load_sd, which turns each tensor into float32 numpy when
it is read); torch Linear weights are [out, in] and transpose to [in, out]
kernels; conv weights go OIHW → HWIO.

A stacked [L, ...] leaf is a ``Stacked``: its L slices are made when read,
so the bridge copies it to the device a layer at a time and a stacked
weight never exists whole in float32 on the host (a Llama-3-8B dump is
about 32 GB in float32). ``np.asarray`` of one gives the JAX converter's
array.

Weight sources (reference llava_next_video.py:117-151):
  vision_tower           vision_model.pth (HF CLIPVisionModel)
  video_encoder          InternVideo2-stage2_1b-224p-f4.pt (4-frame pos
                         embeds, temporally interpolated to 8 at load)
  language_model         Phi-3.5 / Llama-3 HF causal-LM dumps
  multi_modal_projector  Phi3_5_Projecter / LlavaMultiModalProjector .pth
  video_projecter        trained stage checkpoints
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np

from ..core.config import CLIPVisionConfig, InternVideo2Config, LLMConfig
from .internvideo2 import interpolate_temporal_pos_embed


class Stacked:
    """A stacked [n, ...] leaf given as n functions, each making one slice
    (a numpy array) when called."""

    def __init__(self, slices: Sequence[Callable[[], np.ndarray]]):
        self._slices = list(slices)
        first = self._slices[0]()
        self.shape = (len(self._slices),) + tuple(first.shape)
        self.dtype = first.dtype

    def __len__(self) -> int:
        return len(self._slices)

    def slice(self, i: int) -> np.ndarray:
        return self._slices[i]()

    def __array__(self, dtype=None, copy=None):
        out = np.stack([f() for f in self._slices])
        return out if dtype is None else out.astype(dtype)


def leaf_shape(leaf) -> tuple:
    """The shape of a host leaf: a numpy array or a Stacked."""
    return tuple(leaf.shape) if isinstance(leaf, Stacked) else tuple(
        np.shape(leaf))


def _t(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _stack(sd, fmt: str, n: int, transform=lambda x: x) -> Stacked:
    return Stacked([lambda i=i: transform(sd[fmt.format(i=i)])
                    for i in range(n)])


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def convert_clip(sd, cfg: CLIPVisionConfig) -> Dict:
    p = "vision_model."
    L = cfg.num_layers

    def dense(name):
        return {
            "kernel": _stack(sd, p + "encoder.layers.{i}." + name + ".weight",
                             L, _t),
            "bias": _stack(sd, p + "encoder.layers.{i}." + name + ".bias", L),
        }

    def ln(name):
        return {
            "scale": _stack(sd, p + "encoder.layers.{i}." + name + ".weight",
                            L),
            "bias": _stack(sd, p + "encoder.layers.{i}." + name + ".bias", L),
        }

    return {
        "embeddings": {
            "class_embedding": sd[p + "embeddings.class_embedding"].reshape(-1),
            # OIHW → HWIO
            "patch_kernel": sd[p + "embeddings.patch_embedding.weight"]
                .transpose(2, 3, 1, 0),
            "position_embedding": sd[p + "embeddings.position_embedding.weight"],
        },
        "pre_ln": {"scale": sd[p + "pre_layrnorm.weight"],
                   "bias": sd[p + "pre_layrnorm.bias"]},
        "layers": {
            "ln1": ln("layer_norm1"), "ln2": ln("layer_norm2"),
            "q": dense("self_attn.q_proj"), "k": dense("self_attn.k_proj"),
            "v": dense("self_attn.v_proj"), "o": dense("self_attn.out_proj"),
            "fc1": dense("mlp.fc1"), "fc2": dense("mlp.fc2"),
        },
        "post_ln": {"scale": sd[p + "post_layernorm.weight"],
                    "bias": sd[p + "post_layernorm.bias"]},
    }


# ---------------------------------------------------------------------------
# InternVideo2
# ---------------------------------------------------------------------------


def convert_internvideo2(sd, cfg: InternVideo2Config) -> Dict:
    """The checkpoint's pos_embed is interpolated from the temporal length
    read from its rows (1 + T * patches_per_frame) to cfg.num_frames: 4
    frames for the stage2-f4 release, as the JAX converter's fixed default;
    a table written at the model's own length (models/export) reads back
    unchanged, where the JAX converter needs ckpt_num_frames=cfg.num_frames
    for it."""
    L = cfg.depth

    pos_embed = sd["pos_embed"]
    pos = pos_embed.reshape(pos_embed.shape[-2], pos_embed.shape[-1])
    t_ckpt = (pos.shape[0] - 1) // cfg.patches_per_frame
    t_new = cfg.num_frames // cfg.tubelet_size
    if t_ckpt != t_new:
        pos = interpolate_temporal_pos_embed(pos, t_ckpt, t_new,
                                             cfg.patches_per_frame)

    def dense(name):
        return {
            "kernel": _stack(sd, "blocks.{i}." + name + ".weight", L, _t),
            "bias": _stack(sd, "blocks.{i}." + name + ".bias", L),
        }

    return {
        # Conv3d OIDHW (D = tubelet = 1) → HWIO
        "patch_kernel": sd["patch_embed.proj.weight"][:, :, 0]
            .transpose(2, 3, 1, 0),
        "patch_bias": sd["patch_embed.proj.bias"],
        "cls_token": sd["cls_token"].reshape(-1),
        "pos_embed": pos,
        "blocks": {
            "norm1_w": _stack(sd, "blocks.{i}.norm1.weight", L),
            "qkv_kernel": _stack(sd, "blocks.{i}.attn.qkv.weight", L, _t),
            "q_norm_w": _stack(sd, "blocks.{i}.attn.q_norm.weight", L),
            "k_norm_w": _stack(sd, "blocks.{i}.attn.k_norm.weight", L),
            "proj": dense("attn.proj"),
            "ls1": _stack(sd, "blocks.{i}.ls1.gamma", L),
            "norm2_w": _stack(sd, "blocks.{i}.norm2.weight", L),
            "fc1": dense("mlp.fc1"),
            "fc2": dense("mlp.fc2"),
            "ls2": _stack(sd, "blocks.{i}.ls2.gamma", L),
        },
    }


def convert_clip_projector_head(sd) -> Dict:
    """InternVideo2's CLIP-teacher attention-pooling head (reference
    internvideo2.py:878-880: AttentionPoolingBlock with separate q/k/v bias
    params on bias-less Linears). Keys are rooted at 'clip_projector.'."""
    p = "clip_projector."

    def ln(name):
        return {"scale": sd[p + name + ".weight"],
                "bias": sd[p + name + ".bias"]}

    return {
        "norm_q": ln("norm1_q"), "norm_k": ln("norm1_k"),
        "norm_v": ln("norm1_v"),
        "q": {"kernel": _t(sd[p + "cross_attn.q.weight"]),
              "bias": sd[p + "cross_attn.q_bias"]},
        "k": {"kernel": _t(sd[p + "cross_attn.k.weight"]),
              "bias": sd[p + "cross_attn.k_bias"]},
        "v": {"kernel": _t(sd[p + "cross_attn.v.weight"]),
              "bias": sd[p + "cross_attn.v_bias"]},
        "proj": {"kernel": _t(sd[p + "cross_attn.proj.weight"]),
                 "bias": sd[p + "cross_attn.proj.bias"]},
    }


# ---------------------------------------------------------------------------
# LLMs
# ---------------------------------------------------------------------------


def llm_config_from_hf(hf: Dict, base: LLMConfig) -> LLMConfig:
    """Override an LLMConfig's architecture fields from a checkpoint's HF
    config.json dict — in particular the LongRoPE rope_scaling factor
    tables (reference modeling_phi3.py:375-377 reads config.rope_scaling),
    so loaded weights use the tables they were trained with rather than the
    defaults in core/config.py."""
    kw = {}
    simple = {
        "vocab_size": "vocab_size",
        "hidden_size": "hidden_size",
        "intermediate_size": "intermediate_size",
        "num_hidden_layers": "num_layers",
        "num_attention_heads": "num_heads",
        "num_key_value_heads": "num_kv_heads",
        "rms_norm_eps": "rms_eps",
        "rope_theta": "rope_theta",
        "max_position_embeddings": "max_position_embeddings",
        "original_max_position_embeddings": "original_max_position_embeddings",
        "tie_word_embeddings": "tie_word_embeddings",
    }
    for hf_key, field in simple.items():
        if hf_key in hf:
            kw[field] = hf[hf_key]
    scaling = hf.get("rope_scaling") or {}
    if "short_factor" in scaling:
        kw["rope_scaling_short"] = tuple(float(f)
                                         for f in scaling["short_factor"])
    if "long_factor" in scaling:
        kw["rope_scaling_long"] = tuple(float(f)
                                        for f in scaling["long_factor"])
    if "num_attention_heads" in hf and "hidden_size" in hf:
        kw["head_dim"] = hf.get("head_dim",
                                hf["hidden_size"] // hf["num_attention_heads"])
    return dataclasses.replace(base, **kw)


def convert_llm(sd, cfg: LLMConfig) -> Dict:
    """Phi-3 (fused qkv/gate_up as stored) or Llama (q/k/v + gate/up fused
    at conversion into the same layout, in that order)."""
    L = cfg.num_layers
    p = "model."

    if cfg.family == "phi3":
        qkv = _stack(sd, p + "layers.{i}.self_attn.qkv_proj.weight", L, _t)
        gate_up = _stack(sd, p + "layers.{i}.mlp.gate_up_proj.weight", L, _t)
    else:
        def fuse_qkv(i):
            q = _t(sd[p + f"layers.{i}.self_attn.q_proj.weight"])
            k = _t(sd[p + f"layers.{i}.self_attn.k_proj.weight"])
            v = _t(sd[p + f"layers.{i}.self_attn.v_proj.weight"])
            return np.concatenate([q, k, v], axis=1)

        def fuse_gate_up(i):
            g = _t(sd[p + f"layers.{i}.mlp.gate_proj.weight"])
            u = _t(sd[p + f"layers.{i}.mlp.up_proj.weight"])
            return np.concatenate([g, u], axis=1)

        qkv = Stacked([lambda i=i: fuse_qkv(i) for i in range(L)])
        gate_up = Stacked([lambda i=i: fuse_gate_up(i) for i in range(L)])

    return {
        "embed": sd[p + "embed_tokens.weight"],
        "layers": {
            "input_norm_w": _stack(sd, p + "layers.{i}.input_layernorm.weight",
                                   L),
            "qkv_kernel": qkv,
            "o_kernel": _stack(sd, p + "layers.{i}.self_attn.o_proj.weight",
                               L, _t),
            "post_norm_w": _stack(
                sd, p + "layers.{i}.post_attention_layernorm.weight", L),
            "gate_up_kernel": gate_up,
            "down_kernel": _stack(sd, p + "layers.{i}.mlp.down_proj.weight",
                                  L, _t),
        },
        "final_norm_w": sd[p + "norm.weight"],
        "lm_head": _t(sd["lm_head.weight"]),
    }


# ---------------------------------------------------------------------------
# Projectors + extras
# ---------------------------------------------------------------------------


def convert_projector(sd, llm_name: str) -> Dict:
    """Phi3_5_Projecter (linear_0/linear_1, reference
    llava_next_video.py:41-54) or LlavaMultiModalProjector
    (linear_1/linear_2)."""
    if "linear_0.weight" in sd:
        a, b = "linear_0", "linear_1"
    else:
        a, b = "linear_1", "linear_2"
    return {
        "fc1": {"kernel": _t(sd[a + ".weight"]), "bias": sd[a + ".bias"]},
        "fc2": {"kernel": _t(sd[b + ".weight"]), "bias": sd[b + ".bias"]},
    }


def convert_video_projector(sd) -> Dict:
    """Video_Projecter up_proj/down_proj (reference
    llava_next_video.py:26-39)."""
    return {
        "fc1": {"kernel": _t(sd["up_proj.weight"]),
                "bias": sd["up_proj.bias"]},
        "fc2": {"kernel": _t(sd["down_proj.weight"]),
                "bias": sd["down_proj.bias"]},
    }


def convert_extras(sd, llm_name: str) -> Dict:
    if llm_name == "phi3.5":
        return {"glb_GN": sd["glb_GN"].reshape(-1),
                "sub_GN": sd["sub_GN"].reshape(-1)}
    return {"image_newline": sd["image_newline"].reshape(-1)}
