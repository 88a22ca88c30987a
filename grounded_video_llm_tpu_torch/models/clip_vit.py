"""CLIP ViT-L/14-336 spatial encoder (port of
grounded_video_llm_tpu/models/clip_vit.py).

Patch conv → CLS + learned positions → pre-layernorm → pre-LN transformer
layers with a quick-GELU MLP. The VLM only consumes the penultimate layer's
hidden states with CLS dropped, so ``features`` runs layers 0..N-2 and never
the last layer or the post-layernorm.

Parameters are the JAX tree as a dict of tensors, stacked per layer:
  embeddings: class_embedding [D], patch_kernel [P,P,3,D] (HWIO),
              position_embedding [1+N,D]
  pre_ln: {scale, bias}
  layers: {ln1, q, k, v, o, ln2, fc1, fc2}, each [L, ...]; after
          serve/quantize.quantize_clip_for_serving every "kernel" is a W8A8
          Int8Weight (ops/int8_matmul.matmul_any)
  post_ln: {scale, bias}   (kept for checkpoint fidelity; unused)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.config import CLIPVisionConfig
from ..ops.attention import mha
from ..ops.int8_matmul import matmul_any
from ..ops.normalization import layer_norm
from ..parallel import tensor as tp
from ..parallel.tensor import tensor_group
from .param_utils import layer_slice, normal


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def init_params(cfg: CLIPVisionConfig, *, generator: torch.Generator,
                device, dtype=torch.float32):
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    P = cfg.patch_size
    n_pos = cfg.num_patches + 1
    kw = dict(generator=generator, device=device, dtype=dtype)

    def init(shape):
        return normal(shape, 0.02, **kw)

    def dense(d_in, d_out):
        return {"kernel": init((L, d_in, d_out)),
                "bias": torch.zeros(L, d_out, device=device, dtype=dtype)}

    def ln(*lead):
        return {"scale": torch.ones(*lead, D, device=device, dtype=dtype),
                "bias": torch.zeros(*lead, D, device=device, dtype=dtype)}

    return {
        "embeddings": {
            "class_embedding": init((D,)),
            "patch_kernel": init((P, P, 3, D)),
            "position_embedding": init((n_pos, D)),
        },
        "pre_ln": ln(),
        "layers": {
            "ln1": ln(L), "ln2": ln(L),
            "q": dense(D, D), "k": dense(D, D), "v": dense(D, D),
            "o": dense(D, D),
            "fc1": dense(D, I), "fc2": dense(I, D),
        },
        "post_ln": ln(),
    }


def _layer(x, lp, cfg: CLIPVisionConfig, tg=None):
    """One layer. tg: the layer is split over this tensor group: q, k, v
    and fc1 give this rank's heads and columns (their biases sliced to
    match), o and fc2 are row-split, their biases added once after the
    reduce."""
    B, S, D = x.shape
    H = cfg.num_heads if tg is None else cfg.num_heads // tg.size

    def cols(h, name):
        if tg is None:
            return matmul_any(h, lp[name]["kernel"]) + lp[name]["bias"]
        return h @ lp[name]["kernel"] + tp.column_slice(lp[name]["bias"], tg)

    def rows(h, name):
        y = (matmul_any(h, lp[name]["kernel"]) if tg is None
             else tp.row_product(h, lp[name]["kernel"], tg))
        return y + lp[name]["bias"]

    residual = x
    h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"],
                   cfg.layer_norm_eps)
    if tg is not None:
        h = tp.copy(h, tg)
    q, k, v = (cols(h, n).reshape(B, S, H, cfg.head_dim) for n in "qkv")
    attn = mha(q, k, v, causal=False).reshape(B, S, H * cfg.head_dim)
    x = residual + rows(attn, "o")
    residual = x
    h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"],
                   cfg.layer_norm_eps)
    if tg is not None:
        h = tp.copy(h, tg)
    return residual + rows(quick_gelu(cols(h, "fc1")), "fc2")


def embed(params, cfg: CLIPVisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, S, S, 3] channel-last → [B, 1+N, D]."""
    emb = params["embeddings"]
    kernel = emb["patch_kernel"]                        # [P, P, 3, D] HWIO
    x = pixels.to(kernel.dtype).permute(0, 3, 1, 2)     # NCHW
    patches = F.conv2d(x, kernel.permute(3, 2, 0, 1),   # OIHW
                       stride=cfg.patch_size)           # [B, D, 24, 24]
    B = patches.shape[0]
    patches = patches.flatten(2).transpose(1, 2)        # [B, 576, D]
    cls = emb["class_embedding"].to(kernel.dtype).expand(B, 1,
                                                         cfg.hidden_size)
    x = torch.cat([cls, patches], dim=1)
    return x + emb["position_embedding"].to(kernel.dtype)


def features(params, cfg: CLIPVisionConfig,
             pixels: torch.Tensor) -> torch.Tensor:
    """Penultimate-layer features, CLS dropped: [B, num_patches, D]."""
    x = embed(params, cfg, pixels)
    x = layer_norm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"],
                   cfg.layer_norm_eps)
    n_used = cfg.num_layers + cfg.feature_layer + 1     # -2 → N-1 layers
    tg = tensor_group(params["layers"]["q"]["kernel"])
    for i in range(n_used):
        x = _layer(x, layer_slice(params["layers"], i), cfg, tg)
    return x[:, 1:, :]
