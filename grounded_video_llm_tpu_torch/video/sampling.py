# The port's own copy of grounded_video_llm_tpu/video/sampling.py, which imports no
# framework; tests/test_torch_shared_modules.py holds the two to each other.
"""Frame-index sampling — parity with reference mm_utils/video_utils.py:13-51.

Pure numpy/python; runs on the data-loading host threads. The 'rand' mode takes
an explicit numpy Generator instead of global random state so per-worker seeding
is reproducible (reference train.py:59-77 seeds workers for the same reason).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def get_frame_indices(
    num_frames: int,
    vlen: int,
    sample: str = "rand",
    fix_start: Optional[int] = None,
    input_fps: float = 1.0,
    max_num_frames: int = -1,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """Uniform interval sampling ('rand'/'middle') or fixed-fps sampling ('fpsX').

    'middle': midpoint of each of num_frames equal intervals (the inference
    path, reference inference.py:73). Short videos pad with the last frame.
    """
    if sample in ("rand", "middle"):
        acc_samples = min(num_frames, vlen)
        intervals = np.linspace(start=0, stop=vlen, num=acc_samples + 1).astype(int)
        ranges = [(intervals[i], intervals[i + 1] - 1) for i in range(acc_samples)]
        if sample == "rand":
            rng = rng or np.random.default_rng()
            # Reference (mm_utils/video_utils.py:22-28) draws choice(range(lo, hi))
            # per interval; an EMPTY range (hi <= lo, short videos) raises and the
            # except-branch replaces the whole draw with a sorted permutation
            # sample over the full video. Mirror that branch structure exactly.
            if any(hi <= lo for lo, hi in ranges):
                frame_indices = sorted(
                    int(i) for i in rng.permutation(vlen)[:acc_samples])
            else:
                frame_indices = [int(rng.integers(lo, hi)) for lo, hi in ranges]
        elif fix_start is not None:
            frame_indices = [int(lo) + fix_start for lo, _ in ranges]
        else:  # middle
            frame_indices = [(int(lo) + int(hi)) // 2 for lo, hi in ranges]
        if len(frame_indices) < num_frames:  # pad short videos with last frame
            padded = [frame_indices[-1]] * num_frames
            padded[:len(frame_indices)] = frame_indices
            frame_indices = padded
        return frame_indices
    if sample.startswith("fps"):
        output_fps = float(sample[3:])
        duration = float(vlen) / input_fps
        delta = 1.0 / output_fps
        frame_seconds = np.arange(0 + delta / 2, duration + delta / 2, delta)
        frame_indices = np.around(frame_seconds * input_fps).astype(int)
        frame_indices = [int(e) for e in frame_indices if e < vlen]
        if 0 < max_num_frames < len(frame_indices):
            frame_indices = frame_indices[:max_num_frames]
        return frame_indices
    raise ValueError(f"unknown sample mode {sample!r}")


def spatial_indices(num_frames: int, num_segs: int) -> List[int]:
    """Mid-segment frame positions within an already-sampled frame stack:
    i*frames_per_seg + frames_per_seg//2 (reference inference.py:83-84)."""
    per_seg = num_frames // num_segs
    return [i * per_seg + per_seg // 2 for i in range(num_segs)]


def pts_to_secs(pts: int, time_base: float, start_pts: int) -> float:
    """Presentation timestamp → seconds (reference mm_utils/video_utils.py:101-108)."""
    return (pts - start_pts) * time_base
