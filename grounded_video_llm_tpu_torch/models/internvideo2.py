"""InternVideo2-1B temporal encoder trunk (port of the bf16 path of
grounded_video_llm_tpu/models/internvideo2.py).

Per-frame 14x14 patch conv (tubelet 1), CLS + 3D sin-cos positions, then
depth-1 (39 of 40) pre-RMSNorm blocks with QK-RMSNorm over the flattened
heads, fp32-forced LayerScale, an exact-GELU MLP and non-causal attention in
bounded-softmax mode (QK-RMSNorm bounds the scores).

Parameters are the JAX tree as a dict of tensors, stacked per block:
  patch_kernel [P,P,3,D] (HWIO), patch_bias [D], cls_token [D],
  pos_embed [1+T*L, D]
  blocks: {norm1_w, qkv_kernel [Lyr,D,3D], q_norm_w, k_norm_w, proj, ls1,
           norm2_w, fc1, fc2, ls2}; after
          serve/quantize.quantize_video_encoder_for_serving qkv_kernel and
          the proj/fc1/fc2 kernels are W8A8 Int8Weights

``GVLLM_FUSED_IV2=1`` (read where the JAX package reads it, so one setting
opts in both packages) sends a W8A8 block through the fused GEMMs of
ops/fused_block (K10): norm + quantization + qkv + QK-RMSNorm, proj and
fc2 with fp32 LayerScale and the residual, fc1 with the exact GELU. With
the switch off nothing changes. Weights with calibrated static activation
scales (``Int8Weight.x_scale``, serve/calibrate.py) run W8A8 with those
scales through ``matmul_any``; the fused block has no static scales, so the
switch raises on them (the JAX fused route drops them silently).

``features_absmax`` is the calibration pass: the same blocks, each asked
for the per-channel absmax of its four GEMM inputs.

``init_clip_projector`` / ``clip_projector`` are the CLIP-teacher
attention-pooling head, off the VLM path (models/convert reads its tree).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import InternVideo2Config
from ..ops.attention import mha
from ..ops.fused_block import (fused_norm_quant_gemm,
                               fused_quant_gemm_ls_residual, qk_norm_tile)
from ..ops.int8_matmul import Int8Weight, matmul_any
from ..ops.normalization import layer_norm, layer_scale, rms_norm
from .param_utils import layer_slice, truncated_normal


# ---------------------------------------------------------------------------
# 3D sin-cos position embeddings (numpy, host)
# ---------------------------------------------------------------------------


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(embed_dim: int, grid_size: int, t_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """[T*H*W, D] (optionally with a leading zero CLS row). Temporal gets
    D/4 dims, spatial 3D/4 (h and w each 3D/8), concatenated
    [temporal | spatial]."""
    assert embed_dim % 4 == 0
    dim_spatial = embed_dim // 4 * 3
    dim_temporal = embed_dim // 4

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)   # w first
    emb_h = _sincos_1d(dim_spatial // 2, grid[0])
    emb_w = _sincos_1d(dim_spatial // 2, grid[1])
    pos_spatial = np.concatenate([emb_h, emb_w], axis=1)   # [H*W, 3D/4]

    pos_temporal = _sincos_1d(dim_temporal,
                              np.arange(t_size, dtype=np.float32))

    pos_temporal = np.repeat(pos_temporal[:, None, :], grid_size ** 2, axis=1)
    pos_spatial = np.repeat(pos_spatial[None, :, :], t_size, axis=0)
    pos = np.concatenate([pos_temporal, pos_spatial],
                         axis=-1).reshape(-1, embed_dim)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim)), pos], axis=0)
    return pos.astype(np.float32)


def interpolate_temporal_pos_embed(pos_embed: np.ndarray, orig_t: int,
                                   new_t: int,
                                   spatial_tokens: int) -> np.ndarray:
    """Linearly interpolate the temporal axis of a [1+T*L, D] pos embed
    (align_corners=False), as when loading the 4-frame checkpoint into the
    8-frame model."""
    cls_row, rest = pos_embed[:1], pos_embed[1:]
    D = pos_embed.shape[-1]
    grid = rest.reshape(orig_t, spatial_tokens, D)
    new_pos = (np.arange(new_t) + 0.5) / new_t
    out = np.empty((new_t, spatial_tokens, D), dtype=pos_embed.dtype)
    for j, p in enumerate(new_pos):
        x = p * orig_t - 0.5
        lo = int(np.floor(x))
        hi = min(lo + 1, orig_t - 1)
        w = x - lo
        lo = max(lo, 0)
        out[j] = (1 - w) * grid[lo] + w * grid[hi]
    return np.concatenate([cls_row, out.reshape(-1, D)], axis=0)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: InternVideo2Config, *, generator: torch.Generator,
                device, dtype=torch.float32):
    D, Lyr = cfg.embed_dim, cfg.depth
    I = cfg.mlp_hidden
    P = cfg.patch_size
    kw = dict(generator=generator, device=device, dtype=dtype)

    def init(shape):
        return truncated_normal(shape, 0.02, **kw)

    def dense(d_in, d_out):
        return {"kernel": init((Lyr, d_in, d_out)),
                "bias": torch.zeros(Lyr, d_out, device=device, dtype=dtype)}

    def full(value):
        return torch.full((Lyr, D), value, device=device, dtype=dtype)

    t = cfg.num_frames // cfg.tubelet_size
    pos = get_3d_sincos_pos_embed(D, cfg.image_size // P, t, cls_token=True)
    return {
        "patch_kernel": init((P, P, 3, D)),
        "patch_bias": torch.zeros(D, device=device, dtype=dtype),
        "cls_token": torch.zeros(D, device=device, dtype=dtype),
        "pos_embed": torch.from_numpy(pos).to(device=device, dtype=dtype),
        "blocks": {
            "norm1_w": full(1.0),
            "qkv_kernel": init((Lyr, D, 3 * D)),
            "q_norm_w": full(1.0),
            "k_norm_w": full(1.0),
            "proj": dense(D, D),
            "ls1": full(cfg.layerscale_init),
            "norm2_w": full(1.0),
            "fc1": dense(D, I),
            "fc2": dense(I, D),
            "ls2": full(cfg.layerscale_init),
        },
    }


def init_clip_projector(cfg: InternVideo2Config, *,
                        generator: torch.Generator, device,
                        out_dim: int = 768, dtype=torch.float32):
    """CLIP-teacher attention-pooling head (reference internvideo2.py:338-435:
    CrossAttention + AttentionPoolingBlock, qkv_bias=True, out_dim=768).
    Off the VLM runtime path: the full architecture (contrastive or
    retrieval use of the encoder), whose tree
    models/convert.convert_clip_projector_head reads."""
    D = cfg.embed_dim
    kw = dict(generator=generator, device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dtype)

    def ln():
        return {"scale": torch.ones(D, device=device, dtype=dtype),
                "bias": zeros(D)}

    return {
        "norm_q": ln(), "norm_k": ln(), "norm_v": ln(),
        "q": {"kernel": truncated_normal((D, D), 0.02, **kw), "bias": zeros(D)},
        "k": {"kernel": truncated_normal((D, D), 0.02, **kw), "bias": zeros(D)},
        "v": {"kernel": truncated_normal((D, D), 0.02, **kw), "bias": zeros(D)},
        "proj": {"kernel": truncated_normal((D, out_dim), 0.02, **kw),
                 "bias": zeros(out_dim)},
    }


def clip_projector(params, cfg: InternVideo2Config,
                   x: torch.Tensor) -> torch.Tensor:
    """Attention pooling: the mean token cross-attends the sequence →
    [B, out_dim] (reference AttentionPoolingBlock.forward)."""
    B, S, D = x.shape
    H = cfg.num_heads
    Dh = D // H
    xq = x.mean(dim=1, keepdim=True)
    q_in = layer_norm(xq, params["norm_q"]["scale"], params["norm_q"]["bias"])
    k_in = layer_norm(x, params["norm_k"]["scale"], params["norm_k"]["bias"])
    v_in = layer_norm(x, params["norm_v"]["scale"], params["norm_v"]["bias"])
    q = (q_in @ params["q"]["kernel"] + params["q"]["bias"]).reshape(
        B, 1, H, Dh)
    k = (k_in @ params["k"]["kernel"] + params["k"]["bias"]).reshape(
        B, S, H, Dh)
    v = (v_in @ params["v"]["kernel"] + params["v"]["bias"]).reshape(
        B, S, H, Dh)
    pooled = mha(q, k, v, causal=False).reshape(B, D)
    return pooled @ params["proj"]["kernel"] + params["proj"]["bias"]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _block_fused_int8(x, bp, cfg: InternVideo2Config):
    """The W8A8 block through K10: four fused GEMMs. Same quantization
    semantics as the unfused W8A8 block (per-row dynamic activations,
    per-output-channel weights), except that the normed activations are
    quantized in fp32 where the unfused block rounds them to bf16 first."""
    B, S, D = x.shape
    H = cfg.num_heads
    Dh = cfg.head_dim
    qn = torch.stack([bp["q_norm_w"], bp["k_norm_w"]])
    qkv = fused_norm_quant_gemm(
        x, bp["norm1_w"], bp["qkv_kernel"], eps=cfg.rms_eps,
        epilogue="qk_norm" if cfg.qk_normalization else "none", qk_norm_w=qn)
    q, k, v = (t.reshape(B, S, H, Dh) for t in qkv.split(D, dim=-1))
    attn = mha(q, k, v, causal=False,
               bounded_softmax=cfg.qk_normalization).reshape(B, S, D)
    x = fused_quant_gemm_ls_residual(attn, bp["proj"]["kernel"],
                                     bp["proj"]["bias"], bp["ls1"], x)
    h = fused_norm_quant_gemm(x, bp["norm2_w"], bp["fc1"]["kernel"],
                              eps=cfg.rms_eps, epilogue="gelu",
                              bias=bp["fc1"]["bias"])
    return fused_quant_gemm_ls_residual(h, bp["fc2"]["kernel"],
                                        bp["fc2"]["bias"], bp["ls2"], x)


_LEG_WEIGHTS = {"qkv": ("qkv_kernel",), "proj": ("proj", "kernel"),
                "fc1": ("fc1", "kernel"), "fc2": ("fc2", "kernel")}


def _leg_weight(bp, leg: str):
    """The block's weight of a GEMM leg (None where the block has none)."""
    w = bp
    for k in _LEG_WEIGHTS[leg]:
        w = w.get(k) if isinstance(w, dict) else None
    return w


def _fused_int8_ok(bp, cfg: InternVideo2Config) -> bool:
    """Opt-in (GVLLM_FUSED_IV2=1), as in the JAX package, which keeps it off
    because the fused block measured slower there on the TPU (PERF.md has
    the H100's numbers); for int8 weights at widths the kernels tile. On
    the CPU other widths take the unfused block, as in the JAX package; on
    any other device they raise, since there the switch means K10. Weights
    with static activation scales raise on every device: the fused GEMMs
    quantize per row and would drop them."""
    w = bp.get("qkv_kernel")
    if (os.environ.get("GVLLM_FUSED_IV2", "0") != "1"
            or not isinstance(w, Int8Weight)):
        return False
    static = [leg for leg in _LEG_WEIGHTS
              if getattr(_leg_weight(bp, leg), "x_scale", None) is not None]
    if static:
        raise ValueError(
            f"GVLLM_FUSED_IV2=1: the fused W8A8 block has no static "
            f"activation scales, and {static} carry them; unset the switch "
            "or serve without static_scales")
    if (cfg.embed_dim % 128 == 0 and cfg.mlp_hidden % 512 == 0
            and (not cfg.qk_normalization
                 or qk_norm_tile(cfg.embed_dim) is not None)):
        return True
    if w.q.device.type != "cpu":
        raise ValueError(
            f"GVLLM_FUSED_IV2=1: the fused W8A8 block needs embed_dim % 128 "
            f"== 0, mlp_hidden % 512 == 0 and, with qk_normalization, an "
            f"embed_dim of at most 8 column tiles of 256, 176 or 128; got "
            f"{cfg.embed_dim} and {cfg.mlp_hidden}")
    return False


def _absmax(t: torch.Tensor) -> torch.Tensor:
    """Per-channel fp32 absmax over every leading axis."""
    return t.float().abs().amax(dim=tuple(range(t.dim() - 1)))


def _block(x, bp, cfg: InternVideo2Config, stats=None):
    """One block. stats: a dict that receives, per GEMM leg ("qkv",
    "proj", "fc1", "fc2"), the per-channel fp32 absmax of that GEMM's input
    (the calibration pass); a stats request takes the unfused route."""
    if stats is None and _fused_int8_ok(bp, cfg):
        return _block_fused_int8(x, bp, cfg)
    B, S, D = x.shape
    H = cfg.num_heads
    Dh = cfg.head_dim

    def record(leg, t):
        if stats is not None:
            stats[leg] = _absmax(t)
        return t

    h = record("qkv", rms_norm(x, bp["norm1_w"], cfg.rms_eps))
    q, k, v = matmul_any(h, bp["qkv_kernel"]).split(D, dim=-1)  # [B,S,D]
    if cfg.qk_normalization:
        # RMSNorm over the flattened head dim
        q = rms_norm(q, bp["q_norm_w"], cfg.rms_eps)
        k = rms_norm(k, bp["k_norm_w"], cfg.rms_eps)
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, H, Dh)
    v = v.reshape(B, S, H, Dh)
    # QK-RMSNorm bounds the scores, so the kernel keeps a fixed softmax offset
    attn = record("proj", mha(q, k, v, causal=False,
                              bounded_softmax=cfg.qk_normalization)
                  .reshape(B, S, D))
    attn = matmul_any(attn, bp["proj"]["kernel"]) + bp["proj"]["bias"]
    x = x + layer_scale(attn, bp["ls1"])

    h = record("fc1", rms_norm(x, bp["norm2_w"], cfg.rms_eps))
    h = record("fc2", F.gelu(matmul_any(h, bp["fc1"]["kernel"])
                             + bp["fc1"]["bias"], approximate="none"))
    h = matmul_any(h, bp["fc2"]["kernel"]) + bp["fc2"]["bias"]
    return x + layer_scale(h, bp["ls2"])


def patch_embed(params, cfg: InternVideo2Config,
                pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, T, S, S, 3] → [B, T*L, D]; tubelet 1 is a per-frame 2D
    conv."""
    B, T, Hp, Wp, C = pixels.shape
    kernel = params["patch_kernel"]                       # [P, P, 3, D] HWIO
    flat = pixels.reshape(B * T, Hp, Wp, C).to(kernel.dtype)
    patches = F.conv2d(flat.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                       stride=cfg.patch_size)             # [B*T, D, 16, 16]
    patches = patches.flatten(2).transpose(1, 2) + params["patch_bias"]
    return patches.reshape(B, T * cfg.patches_per_frame, cfg.embed_dim)


def _trunk(params, cfg: InternVideo2Config, pixels: torch.Tensor,
           stats=None) -> torch.Tensor:
    x = patch_embed(params, cfg, pixels)
    B = x.shape[0]
    cls = params["cls_token"].to(x.dtype).expand(B, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(x.dtype)
    for i in range(cfg.num_blocks_used):
        block_stats = None if stats is None else {}
        x = _block(x, layer_slice(params["blocks"], i), cfg, block_stats)
        if stats is not None:
            stats.append(block_stats)
    return x


def features(params, cfg: InternVideo2Config,
             pixels: torch.Tensor) -> torch.Tensor:
    """The trunk with early exit after num_blocks_used blocks → [B, 1+T*L, D]
    (CLS included; callers drop it)."""
    return _trunk(params, cfg, pixels)


def features_absmax(params, cfg: InternVideo2Config, pixels: torch.Tensor):
    """features() and, per block run, the per-channel fp32 absmax of each
    GEMM input: (x, {"qkv"/"proj"/"fc1" [Lyr_used, D], "fc2" [Lyr_used,
    mlp_hidden]}), the calibration pass of serve/calibrate.py. It runs
    whatever weights the tree holds (bf16 or W8A8), so the maxima match the
    numerics that will consume them."""
    per_block = []
    x = _trunk(params, cfg, pixels, per_block)
    return x, {leg: torch.stack([s[leg] for s in per_block])
               for leg in _LEG_WEIGHTS}
