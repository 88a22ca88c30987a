"""Frame preprocessing (port of grounded_video_llm_tpu/ops/preprocess.py):
shorter-edge bicubic resize, center crop, normalization.

Two routes, as in the JAX package:
  * host   — PIL-exact bicubic resize and center crop (the port's copy of
             the framework-free ops/pil_resize.py). The serving path stays
             uint8 and normalizes on the device
             (models/vlm.py:_maybe_normalize); the training datasets
             normalize on the host (``dual_stream_preprocess_host``, fp32).
  * device — ``preprocess_frames_device`` / ``dual_stream_preprocess_device``
             (JAX: ``preprocess_frames_xla`` / ``dual_stream_preprocess_xla``):
             uint8 frames on a tensor's device, resized as
             ``jax.image.resize(method="bicubic", antialias=True)`` resizes,
             clipped to [0, 1], center-cropped and normalized there. No
             caller of either package uses it; it is not PIL-exact.

Output layout is channel-last [T, S, S, 3].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..video.sampling import spatial_indices
from .pil_resize import resize_bicubic_batch_u8, resized_shape_torchvision

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
INTERNVIDEO_MEAN = (0.485, 0.456, 0.406)
INTERNVIDEO_STD = (0.229, 0.224, 0.225)


def _resize_shape(h: int, w: int, size: int) -> Tuple[int, int]:
    """Shorter edge → size, the long edge truncated (torchvision 0.16.2)."""
    return resized_shape_torchvision(h, w, size)


def _crop_box(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision CenterCrop origin."""
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return top, left


def resize_frames_host_u8(frames: np.ndarray, size: int) -> np.ndarray:
    """uint8 [T, H, W, 3] → PIL-exact bicubic shorter-edge resize → center
    crop → uint8 [T, size, size, 3]."""
    T, h, w, _ = frames.shape
    rh, rw = _resize_shape(h, w, size)
    top, left = _crop_box(rh, rw, size)
    r = resize_bicubic_batch_u8(np.ascontiguousarray(frames), rh, rw)
    return np.ascontiguousarray(r[:, top:top + size, left:left + size])


def dual_stream_resize_host(frames: np.ndarray, num_segs: int,
                            temporal_size: int = 224,
                            spatial_size: int = 336
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """frames uint8 [F, H, W, 3] → (temporal [F, 224, 224, 3] all frames,
    spatial [num_segs, 336, 336, 3] mid-segment frames), both uint8."""
    num_frames = frames.shape[0]
    temporal = resize_frames_host_u8(frames, temporal_size)
    idx = spatial_indices(num_frames, num_segs)
    spatial = resize_frames_host_u8(frames[idx], spatial_size)
    return temporal, spatial


def preprocess_frames_host(frames: np.ndarray, size: int,
                           mean: Tuple[float, float, float],
                           std: Tuple[float, float, float],
                           dtype=np.float32) -> np.ndarray:
    """uint8 [T, H, W, 3] → resize and crop as resize_frames_host_u8 →
    /255 → (x - mean) / std in dtype: the reference's ToPILImage → Resize
    (BICUBIC) → CenterCrop → ToTensor → Normalize."""
    u8 = resize_frames_host_u8(frames, size)
    mean_arr = np.asarray(mean, dtype=np.float32)
    std_arr = np.asarray(std, dtype=np.float32)
    out = (u8.astype(np.float32) / 255.0 - mean_arr) / std_arr
    return out.astype(dtype, copy=False)


def dual_stream_preprocess_host(frames: np.ndarray, num_segs: int,
                                temporal_size: int = 224,
                                spatial_size: int = 336, dtype=np.float32
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """frames uint8 [F, H, W, 3] → (temporal [F, 224, 224, 3] all frames,
    InternVideo2 normalization; spatial [num_segs, 336, 336, 3]
    mid-segment frames, CLIP normalization), both in dtype."""
    num_frames = frames.shape[0]
    temporal = preprocess_frames_host(frames, temporal_size,
                                      INTERNVIDEO_MEAN, INTERNVIDEO_STD, dtype)
    idx = spatial_indices(num_frames, num_segs)
    spatial = preprocess_frames_host(frames[idx], spatial_size,
                                     OPENAI_DATASET_MEAN, OPENAI_DATASET_STD,
                                     dtype)
    return temporal, spatial


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, at |distance| x."""
    one, two = np.float32(1.0), np.float32(2.0)
    near = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + one
    far = ((np.float32(-0.5) * x + np.float32(2.5)) * x
           - np.float32(4.0)) * x + two
    out = np.where(x >= one, far, near)
    return np.where(x >= two, np.float32(0.0), out).astype(np.float32)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """fp32 [in_size, out_size]: the resampling matrix of one axis, computed
    as jax.image.scale_and_translate computes it for a resize (scale
    out/in, no translation, antialias): half-pixel sample positions, the
    kernel widened by 1/scale when downsampling, the weights of each output
    pixel normalised to sum to 1, and zero where the sample falls outside
    the input."""
    f32 = np.float32
    # the scale and its inverse in float64, as Python computes them there,
    # then rounded to float32
    inv = 1.0 / (out_size / in_size)
    inv_scale = np.asarray(inv, f32)
    kernel_scale = np.asarray(max(inv, 1.0), f32)
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    eps = f32(1000.0) * np.finfo(f32).eps
    w = np.where(np.abs(total) > eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(in_size) - f32(0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def preprocess_frames_device(frames: torch.Tensor, size: int,
                             mean: Tuple[float, float, float],
                             std: Tuple[float, float, float],
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 [T, H, W, 3] on any device → [T, size, size, 3] in out_dtype
    on the same device (JAX: preprocess_frames_xla): /255, bicubic
    antialiased resize of the shorter edge to size (the long edge
    truncated, torchvision 0.16.2), clip to [0, 1], center crop,
    (x - mean) / std. The resize is two fp32 products with the matrices of
    resize_weights, made on the host; an axis whose size does not change is
    not resampled, as in JAX. The crop selects the matrices' columns."""
    T, h, w, _ = frames.shape
    rh, rw = _resize_shape(h, w, size)
    top, left = _crop_box(rh, rw, size)
    x = frames.to(torch.float32)
    x = x / x.new_full((), 255.0)
    if rh != h:
        wh = torch.from_numpy(resize_weights(h, rh)[:, top:top + size])
        x = torch.einsum("thwc,hs->tswc", x, wh.to(x.device))
    else:
        x = x[:, top:top + size]
    if rw != w:
        ww = torch.from_numpy(resize_weights(w, rw)[:, left:left + size])
        x = torch.einsum("tswc,wr->tsrc", x, ww.to(x.device))
    else:
        x = x[:, :, left:left + size]
    x = x.clamp(0.0, 1.0)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean_t) / std_t).to(out_dtype)


def dual_stream_preprocess_device(frames: torch.Tensor, num_segs: int,
                                  temporal_size: int = 224,
                                  spatial_size: int = 336,
                                  out_dtype=torch.bfloat16
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 frames [F, H, W, 3] on a device → (temporal [F, 224, 224, 3]
    all frames, InternVideo2 normalization; spatial [num_segs, 336, 336, 3]
    mid-segment frames, CLIP normalization), both in out_dtype on that
    device (JAX: dual_stream_preprocess_xla)."""
    temporal = preprocess_frames_device(frames, temporal_size,
                                        INTERNVIDEO_MEAN, INTERNVIDEO_STD,
                                        out_dtype)
    idx = torch.as_tensor(spatial_indices(frames.shape[0], num_segs),
                          device=frames.device)
    spatial = preprocess_frames_device(frames[idx], spatial_size,
                                       OPENAI_DATASET_MEAN,
                                       OPENAI_DATASET_STD, out_dtype)
    return temporal, spatial
