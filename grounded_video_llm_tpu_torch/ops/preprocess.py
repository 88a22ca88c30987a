"""Host half of frame preprocessing (port of
grounded_video_llm_tpu/ops/preprocess.py): shorter-edge PIL-exact bicubic
resize and center crop. The serving path stays uint8 and normalizes on the
device (models/vlm.py:_maybe_normalize); the training datasets normalize on
the host (``dual_stream_preprocess_host``, fp32). The resize itself is the
port's copy of the JAX package's framework-free ops/pil_resize.py.

Output layout is channel-last [T, S, S, 3].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

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
