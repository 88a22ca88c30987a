# The port's own copy of grounded_video_llm_tpu/video/reader.py, which imports no
# framework; tests/test_torch_shared_modules.py holds the two to each other.
"""Video frame reading: indexed batch decode with a robustness fallback chain.

Functional parity with reference mm_utils/video_utils.py:56-139 (decord batch
decode + PyAV sequential fallback) but TPU-host-native:

  1. native  — C++ libav decoder (video/native/, ctypes-bound): random-access
               batch seek-decode of N frame indices → uint8 RGB buffer. The
               fast path; built separately, auto-detected at import.
  2. cv2     — OpenCV sequential grab/retrieve fallback (always available).

Frames are returned channel-last uint8 [T, H, W, 3] — the layout the XLA
preprocessing kernel wants (the reference returns [T, C, H, W] torch tensors;
the transform stack here consumes HWC directly).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .sampling import get_frame_indices

_FALLBACK_LOGGED = set()


@dataclass
class VideoFrames:
    frames: np.ndarray          # uint8 [T, H, W, 3] RGB
    frame_indices: List[int]
    fps: float
    vlen: int                   # total frame count
    duration: float             # seconds


def _read_frames_cv2(video_path: str, frame_indices: List[int]) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cv2 cannot open {video_path}")
    wanted = sorted(set(int(i) for i in frame_indices))
    got: dict = {}
    pos = 0
    max_wanted = wanted[-1]
    want_set = set(wanted)
    try:
        while pos <= max_wanted:
            if pos in want_set:
                ok, frame = cap.read()
                if not ok:
                    break
                got[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            else:
                if not cap.grab():
                    break
            pos += 1
    finally:
        cap.release()
    if not got:
        raise IOError(f"cv2 decoded no frames from {video_path}")
    last = got[max(got)]
    frames = np.stack([got.get(int(i), last) for i in frame_indices])
    return frames


def _video_meta_cv2(video_path: str) -> Tuple[int, float]:
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cv2 cannot open {video_path}")
    try:
        vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = float(cap.get(cv2.CAP_PROP_FPS))
    finally:
        cap.release()
    if vlen <= 0:
        raise IOError(f"no frame count for {video_path}")
    if fps <= 0:
        fps = 30.0
    return vlen, fps


def _native_decoder():
    try:
        from .native import decoder as native_decoder

        return native_decoder if native_decoder.available() else None
    except Exception:
        return None


def read_frames(
    video_path: str,
    num_frames: int,
    sample: str = "rand",
    fix_start: Optional[int] = None,
    max_num_frames: int = -1,
    rng: Optional[np.random.Generator] = None,
    backend: str = "auto",
) -> VideoFrames:
    """Decode num_frames sampled frames. backend: auto|native|cv2."""
    native = _native_decoder() if backend in ("auto", "native") else None
    if native is not None:
        try:
            vlen, fps = native.probe(video_path)
            duration = vlen / fps
            indices = get_frame_indices(num_frames, vlen, sample, fix_start,
                                        input_fps=fps,
                                        max_num_frames=max_num_frames, rng=rng)
            frames = native.decode_frames(video_path, indices)
            return VideoFrames(frames, indices, fps, vlen, duration)
        except Exception as e:  # noqa: BLE001 — any decode error falls through
            if backend == "native":
                raise
            if video_path not in _FALLBACK_LOGGED:
                _FALLBACK_LOGGED.add(video_path)
                print(f"native decode failed for {video_path}: {e}; trying cv2")
    vlen, fps = _video_meta_cv2(video_path)
    duration = vlen / fps
    indices = get_frame_indices(num_frames, vlen, sample, fix_start,
                                input_fps=fps, max_num_frames=max_num_frames,
                                rng=rng)
    frames = _read_frames_cv2(video_path, indices)
    return VideoFrames(frames, indices, fps, vlen, duration)


def read_frames_with_fallback(
    video_path: str,
    num_frames: int,
    sample: str,
    fallback_video: str,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[VideoFrames, bool]:
    """Decode-failure chain matching reference datasets/mix_sft.py:94-119:
    primary backend → alternate backend → stock fallback video. Returns
    (frames, used_fallback)."""
    try:
        return read_frames(video_path, num_frames, sample, rng=rng), False
    except Exception:
        print(f"read_frames ERROR: {video_path}")
        try:
            return read_frames(video_path, num_frames, sample, rng=rng,
                               backend="cv2"), False
        except Exception:
            print(f"cv2 fallback ERROR: {video_path}")
            return read_frames(fallback_video, num_frames, sample, rng=rng), True
