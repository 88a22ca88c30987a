"""Parameter tree → reference-format state dicts (port of
grounded_video_llm_tpu/models/export.py; the inverse of models/convert.py).

Produces the reference's split-by-module, trainable-only checkpoint layout
({"model": {module: state_dict}}, reference training/fsdp.py:116-127) and
the full weight dumps each module ships as (HF CLIPVisionModel,
InternVideo2, HF causal LM, projectors), from this package's tree on any
device. Every value is written as float32, as the JAX exporter writes it,
so both packages write the same names, shapes and values and read each
other's files.

The trainable-only export of an LLM writes lm_head and embed_tokens only:
the LoRA adapters are not written, merged or not — the JAX exporter merges
them and then drops the merged projections (ROADMAP, "Known faults in the
reference"). This package writes what the JAX package writes, so the two
read each other's files alike.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..core.checkpoint import export_reference_pth
from ..core.config import VLMConfig
from ..train import lora as lora_mod


def _a(x) -> np.ndarray:
    """float32 numpy copy on the host."""
    return x.detach().to("cpu", torch.float32, copy=True).numpy()


def _t(x) -> np.ndarray:
    return np.ascontiguousarray(_a(x).T)


def export_mm_projector(params: Dict, llm_name: str) -> Dict[str, np.ndarray]:
    a, b = ("linear_0", "linear_1") if llm_name == "phi3.5" else (
        "linear_1", "linear_2")
    return {
        a + ".weight": _t(params["fc1"]["kernel"]),
        a + ".bias": _a(params["fc1"]["bias"]),
        b + ".weight": _t(params["fc2"]["kernel"]),
        b + ".bias": _a(params["fc2"]["bias"]),
    }


def export_video_projector(params: Dict) -> Dict[str, np.ndarray]:
    return {
        "up_proj.weight": _t(params["fc1"]["kernel"]),
        "up_proj.bias": _a(params["fc1"]["bias"]),
        "down_proj.weight": _t(params["fc2"]["kernel"]),
        "down_proj.bias": _a(params["fc2"]["bias"]),
    }


def export_llm_trainable(llm_params: Dict) -> Dict[str, np.ndarray]:
    """The trainable LLM pieces the JAX exporter writes: lm_head and
    embed_tokens (LoRA does not touch either, so they are written without
    merging the adapters)."""
    return {
        "lm_head.weight": _t(llm_params["lm_head"]),
        "model.embed_tokens.weight": _a(llm_params["embed"]),
    }


# ---------------------------------------------------------------------------
# Full-module exports: exact inverses of convert.convert_{clip,
# internvideo2,llm} and convert_extras, with the HF/reference state-dict
# names each weight dump ships with (reference llava_next_video.py:117-151),
# so a checkpoint written from a tree goes through build_params' load →
# convert → place chain and comes back bit for bit.
# ---------------------------------------------------------------------------


def export_clip_full(clip: Dict, cfg) -> Dict[str, np.ndarray]:
    """Inverse of convert.convert_clip (HF CLIPVisionModel state dict,
    'pre_layrnorm' typo included)."""
    p = "vision_model."
    L = cfg.num_layers
    emb = clip["embeddings"]
    sd = {
        p + "embeddings.class_embedding": _a(emb["class_embedding"]),
        # HWIO → OIHW
        p + "embeddings.patch_embedding.weight":
            np.ascontiguousarray(_a(emb["patch_kernel"]).transpose(3, 2, 0, 1)),
        p + "embeddings.position_embedding.weight":
            _a(emb["position_embedding"]),
        p + "pre_layrnorm.weight": _a(clip["pre_ln"]["scale"]),
        p + "pre_layrnorm.bias": _a(clip["pre_ln"]["bias"]),
        p + "post_layernorm.weight": _a(clip["post_ln"]["scale"]),
        p + "post_layernorm.bias": _a(clip["post_ln"]["bias"]),
    }
    lyr = clip["layers"]
    names = {"self_attn.q_proj": "q", "self_attn.k_proj": "k",
             "self_attn.v_proj": "v", "self_attn.out_proj": "o",
             "mlp.fc1": "fc1", "mlp.fc2": "fc2"}
    lns = {"layer_norm1": "ln1", "layer_norm2": "ln2"}
    for i in range(L):
        q = p + f"encoder.layers.{i}."
        for hf, ours in names.items():
            sd[q + hf + ".weight"] = _t(lyr[ours]["kernel"][i])
            sd[q + hf + ".bias"] = _a(lyr[ours]["bias"][i])
        for hf, ours in lns.items():
            sd[q + hf + ".weight"] = _a(lyr[ours]["scale"][i])
            sd[q + hf + ".bias"] = _a(lyr[ours]["bias"][i])
    return sd


def export_internvideo2_full(enc: Dict, cfg) -> Dict[str, np.ndarray]:
    """Inverse of convert.convert_internvideo2. pos_embed is written at the
    tree's own temporal length, which convert reads from its rows, so it
    comes back unchanged (the f4 release ships 4-frame tables that convert
    interpolates; the JAX converter needs ckpt_num_frames=cfg.num_frames
    for such a table)."""
    sd = {
        # HWIO → Conv3d OIDHW with D = tubelet = 1
        "patch_embed.proj.weight":
            np.ascontiguousarray(
                _a(enc["patch_kernel"]).transpose(3, 2, 0, 1)[:, :, None]),
        "patch_embed.proj.bias": _a(enc["patch_bias"]),
        "cls_token": _a(enc["cls_token"]).reshape(1, 1, -1),
        "pos_embed": _a(enc["pos_embed"])[None],
        "clip_pos_embed": _a(enc["pos_embed"])[None],
    }
    b = enc["blocks"]
    L = b["norm1_w"].shape[0]
    for i in range(L):
        p = f"blocks.{i}."
        sd[p + "norm1.weight"] = _a(b["norm1_w"][i])
        sd[p + "attn.qkv.weight"] = _t(b["qkv_kernel"][i])
        sd[p + "attn.q_norm.weight"] = _a(b["q_norm_w"][i])
        sd[p + "attn.k_norm.weight"] = _a(b["k_norm_w"][i])
        sd[p + "attn.proj.weight"] = _t(b["proj"]["kernel"][i])
        sd[p + "attn.proj.bias"] = _a(b["proj"]["bias"][i])
        sd[p + "ls1.gamma"] = _a(b["ls1"][i])
        sd[p + "norm2.weight"] = _a(b["norm2_w"][i])
        sd[p + "mlp.fc1.weight"] = _t(b["fc1"]["kernel"][i])
        sd[p + "mlp.fc1.bias"] = _a(b["fc1"]["bias"][i])
        sd[p + "mlp.fc2.weight"] = _t(b["fc2"]["kernel"][i])
        sd[p + "mlp.fc2.bias"] = _a(b["fc2"]["bias"][i])
        sd[p + "ls2.gamma"] = _a(b["ls2"][i])
    return sd


def export_llm_full(llm: Dict, cfg) -> Dict[str, np.ndarray]:
    """Inverse of convert.convert_llm, LoRA merged into the projections
    first: phi3 keeps the fused qkv/gate_up dumps HF ships; llama re-splits
    the fused kernels into q/k/v and gate/up."""
    merged = lora_mod.merge_lora(llm)
    lyr = merged["layers"]
    L = lyr["input_norm_w"].shape[0]
    sd = {
        "model.embed_tokens.weight": _a(merged["embed"]),
        "model.norm.weight": _a(merged["final_norm_w"]),
        "lm_head.weight": _t(merged["lm_head"]),
    }
    for i in range(L):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = _a(lyr["input_norm_w"][i])
        sd[p + "post_attention_layernorm.weight"] = _a(lyr["post_norm_w"][i])
        sd[p + "self_attn.o_proj.weight"] = _t(lyr["o_kernel"][i])
        sd[p + "mlp.down_proj.weight"] = _t(lyr["down_kernel"][i])
        qkv = _a(lyr["qkv_kernel"][i])
        gu = _a(lyr["gate_up_kernel"][i])
        if cfg.family == "phi3":
            sd[p + "self_attn.qkv_proj.weight"] = np.ascontiguousarray(qkv.T)
            sd[p + "mlp.gate_up_proj.weight"] = np.ascontiguousarray(gu.T)
        else:
            q_dim = cfg.num_heads * cfg.head_dim
            kv_dim = cfg.num_kv_heads * cfg.head_dim
            for name, part in (("self_attn.q_proj", qkv[:, :q_dim]),
                               ("self_attn.k_proj",
                                qkv[:, q_dim:q_dim + kv_dim]),
                               ("self_attn.v_proj", qkv[:, q_dim + kv_dim:])):
                sd[p + name + ".weight"] = np.ascontiguousarray(part.T)
            half = gu.shape[1] // 2
            sd[p + "mlp.gate_proj.weight"] = np.ascontiguousarray(
                gu[:, :half].T)
            sd[p + "mlp.up_proj.weight"] = np.ascontiguousarray(
                gu[:, half:].T)
    return sd


def export_extras_full(extras: Dict, llm_name: str) -> Dict[str, np.ndarray]:
    """Inverse of convert.convert_extras (reference shapes: glb_GN
    [1,1,4C], sub_GN [1,1,1,4C], image_newline [H])."""
    if llm_name == "phi3.5":
        return {"glb_GN": _a(extras["glb_GN"]).reshape(1, 1, -1),
                "sub_GN": _a(extras["sub_GN"]).reshape(1, 1, 1, -1)}
    return {"image_newline": _a(extras["image_newline"])}


def export_vlm_to_reference(params: Dict, cfg: VLMConfig, path: str,
                            trainable_only: bool = True) -> None:
    """The stage checkpoint: both projectors, and the LLM's trainable
    pieces when they can differ from the base model (always, with
    trainable_only=False)."""
    modules = {
        "multi_modal_projector": export_mm_projector(params["mm_projector"],
                                                     cfg.llm_name),
        "video_projecter": export_video_projector(params["video_projector"]),
    }
    if not trainable_only or "lora" in params["llm"]["layers"] or (
            params["llm"]["embed"].shape[0] > cfg.llm.vocab_size):
        modules["language_model"] = export_llm_trainable(params["llm"])
    export_reference_pth(path, modules)


def write_weight_dumps(params: Dict, cfg: VLMConfig,
                       workdir: str) -> Dict[str, str]:
    """Every reference-format file of a tree, in the layout
    cli/model_loading.build_params reads (scripts/eval_dress_rehearsal.py's
    weights-day layout):

      workdir/weights/vision_model.pth                HF CLIPVisionModel
      workdir/weights/multi_modal_projector.pth       projector
      workdir/weights/image_newlines.pth              glb_GN/sub_GN (or
                                                      image_newline)
      workdir/weights/language_model_seperated/*.bin  HF causal LM
      workdir/video_encoder.pt                        InternVideo2 {"model"}
      workdir/stage_grounded.pth                      stage checkpoint, not
                                                      trainable-only

    → {"weight_root", "video_encoder", "stage_ckpt": path}."""
    wroot = os.path.join(workdir, "weights")
    lm_dir = os.path.join(wroot, "language_model_seperated")
    os.makedirs(lm_dir, exist_ok=True)

    def save(path, sd, wrap=False):
        tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
        torch.save({"model": tensors} if wrap else tensors, path)

    save(os.path.join(wroot, "vision_model.pth"),
         export_clip_full(params["clip"], cfg.clip))
    save(os.path.join(wroot, "multi_modal_projector.pth"),
         export_mm_projector(params["mm_projector"], cfg.llm_name))
    save(os.path.join(wroot, "image_newlines.pth"),
         export_extras_full(params["extras"], cfg.llm_name))
    save(os.path.join(lm_dir, "pytorch_model-00001-of-00001.bin"),
         export_llm_full(params["llm"], cfg.llm))
    iv2_path = os.path.join(workdir, "video_encoder.pt")
    save(iv2_path, export_internvideo2_full(params["video_encoder"],
                                            cfg.video), wrap=True)
    stage_path = os.path.join(workdir, "stage_grounded.pth")
    export_vlm_to_reference(params, cfg, stage_path, trainable_only=False)
    return {"weight_root": wroot, "video_encoder": iv2_path,
            "stage_ckpt": stage_path}
