"""Static W8A8 activation scales for the InternVideo2 trunk (port of
grounded_video_llm_tpu/serve/calibrate.py).

The dynamic W8A8 path (ops/int8_matmul.dynamic_int8_matmul) reads each GEMM
input twice to quantize it per row (absmax, then scale and round). A
calibrated per-tensor scale per block and leg makes the quantization a
plain elementwise pass:

1. ``calibrate_video_encoder`` runs the trunk over sample clips and records,
   per block, the per-channel absmax of every GEMM leg's input
   (models/internvideo2.features_absmax), max-reduced over the batches;
2. ``static_scales_from_absmax`` reduces them to per-tensor int8 scales
   (max over channels × margin / 127, at least 1e-8);
3. ``apply_static_scales`` sets the ``x_scale`` [Lyr_total] of the chosen
   legs' ``Int8Weight``s; ops/int8_matmul.matmul_any dispatches on it.

Per-tensor static scales are coarser than per-row dynamic ones; the
accuracy bar is serve/quant_ab.py. The engine calibrates lazily on the
first request (serve/engine.py, ``static_scales=True``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from ..core.config import VLMConfig
from ..models import internvideo2
from ..models.vlm import _maybe_normalize
from ..ops.int8_matmul import Int8Weight
from ..ops.preprocess import INTERNVIDEO_MEAN, INTERNVIDEO_STD

# Encoder GEMM legs, in block order. fc2 (the GELU output) is the largest
# input; proj is the leg whose dynamic quantization the JAX package measured
# as a net loss on the TPU.
LEGS = ("qkv", "proj", "fc1", "fc2")
DEFAULT_LEGS = ("fc2", "proj")
# Headroom over the observed calibration max: absmax clipping saturates
# rarely seen outliers instead of scaling everything else down.
DEFAULT_MARGIN = 1.0


def calibrate_video_encoder(params, cfg: VLMConfig,
                            temporal_pixel_batches: Iterable
                            ) -> Dict[str, np.ndarray]:
    """Per-block per-channel input absmaxes {"qkv"/"proj"/"fc1" [Lyr, D],
    "fc2" [Lyr, mlp_hidden]} (numpy fp32), max-reduced over the batches.

    params: the full VLM tree (calibrate on the tree that will serve);
    batches: [B, num_frames, S, S, 3] temporal pixels as encode_video takes
    them (uint8 or normalized float; numpy arrays or tensors), run on the
    encoder's device."""
    enc = params["video_encoder"]
    dtype = enc["patch_kernel"].dtype
    device = enc["patch_kernel"].device
    fps = cfg.num_frames_per_seg
    agg: Dict[str, np.ndarray] = {}
    with torch.inference_mode():
        for px in temporal_pixel_batches:
            px = (px if torch.is_tensor(px)
                  else torch.from_numpy(np.array(px))).to(device)
            px = _maybe_normalize(px, INTERNVIDEO_MEAN, INTERNVIDEO_STD,
                                  dtype)
            B = px.shape[0]
            clips = px.reshape(B * cfg.num_segs, fps, *px.shape[2:])
            _, stats = internvideo2.features_absmax(enc, cfg.video, clips)
            for leg in LEGS:
                s = stats[leg].cpu().numpy()
                agg[leg] = np.maximum(agg[leg], s) if leg in agg else s
    return agg


def static_scales_from_absmax(calib: Dict[str, np.ndarray],
                              legs: Sequence[str] = DEFAULT_LEGS,
                              margin: float = DEFAULT_MARGIN
                              ) -> Dict[str, np.ndarray]:
    """Per-channel absmaxes → per-tensor int8 scales [Lyr] per leg."""
    out = {}
    for leg in legs:
        amax = np.asarray(calib[leg], np.float32).max(axis=-1)    # [Lyr]
        out[leg] = np.maximum(amax * margin / 127.0, 1e-8).astype(np.float32)
    return out


def apply_static_scales(encoder_params: dict,
                        calib: Dict[str, np.ndarray],
                        legs: Sequence[str] = DEFAULT_LEGS,
                        margin: float = DEFAULT_MARGIN) -> dict:
    """A new encoder tree whose chosen legs' ``Int8Weight``s carry an
    ``x_scale`` [Lyr_total]; blocks past num_blocks_used (the early-exit
    tail, never run) pad with 1.0. The legs must be W8A8 already
    (serve/quantize.quantize_video_encoder_for_serving); the input tree is
    not modified."""
    scales = static_scales_from_absmax(calib, legs, margin)
    blocks = dict(encoder_params["blocks"])
    n_total = blocks["norm1_w"].shape[0]
    for leg in legs:
        node = blocks["qkv_kernel" if leg == "qkv" else leg]
        kern = node if leg == "qkv" else node["kernel"]
        if not isinstance(kern, Int8Weight):
            raise ValueError(
                f"leg {leg!r} is not W8A8-quantized; run "
                "quantize_video_encoder_for_serving first")
        s = scales[leg]
        s = np.concatenate([s, np.ones(n_total - s.shape[0], np.float32)])
        kern = kern._replace(x_scale=torch.from_numpy(s).to(kern.q.device))
        if leg == "qkv":
            blocks["qkv_kernel"] = kern
        else:
            blocks[leg] = dict(node, kernel=kern)
    return dict(encoder_params, blocks=blocks)


def calibrate_and_apply(params: dict, cfg: VLMConfig,
                        temporal_pixel_batches: Iterable,
                        legs: Sequence[str] = DEFAULT_LEGS,
                        margin: float = DEFAULT_MARGIN) -> dict:
    """Calibrate on the given clips and return a new VLM tree with static
    scales applied to the video encoder."""
    calib = calibrate_video_encoder(params, cfg, temporal_pixel_batches)
    return dict(params, video_encoder=apply_static_scales(
        params["video_encoder"], calib, legs, margin))
