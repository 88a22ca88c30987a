"""The reference's pixel path in plain torch: the shorter edge resized with
Pillow's bicubic resample (8-bit fixed point, antialiased, the horizontal
pass first, uint8 between the passes), then a center crop; the temporal
stream takes every frame at 224, the spatial stream the middle frame of
each segment at 336.

The passes run in int64 on the frames' device. This restates Pillow's
Resample.c (precompute_coeffs and normalize_coeffs_8bpc) and torchvision
0.16.2's size and crop arithmetic, which the model's preprocessing
follows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def coefficients(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] int64 fixed-point weights of one axis."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    out = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        w = _bicubic((np.arange(hi - lo) + lo - center + 0.5) / filterscale)
        total = 0.0
        for v in w:                      # C's sequential sum
            total += float(v)
        if total != 0.0:
            w = w / total
        q = w * float(1 << PRECISION_BITS)
        out[xx, lo:hi] = np.trunc(q + np.where(w < 0.0, -0.5, 0.5))
    return out


def _taps(coeff: np.ndarray):
    """A banded coefficient matrix as (indices [out, K], weights [out, K])."""
    nz = coeff != 0
    lo = np.argmax(nz, axis=1)
    K = int((coeff.shape[1] - np.argmax(nz[:, ::-1], axis=1) - lo).max())
    pos = lo[:, None] + np.arange(K)
    idx = np.minimum(pos, coeff.shape[1] - 1)
    w = np.take_along_axis(coeff, idx, axis=1)
    w[pos >= coeff.shape[1]] = 0
    return idx, w


def _pass(x: torch.Tensor, coeff: np.ndarray, axis: int) -> torch.Tensor:
    """One resample pass along axis 1 (rows) or 2 (columns) of uint8
    [T, H, W, 3], in int64 on x's device."""
    idx, w = (torch.from_numpy(a).to(x.device) for a in _taps(coeff))
    shape = [1] * 5
    shape[axis], shape[axis + 1] = w.shape
    out = []
    for t0 in range(0, x.shape[0], 8):
        g = x[t0:t0 + 8].long().index_select(axis, idx.reshape(-1))
        g = g.reshape(*g.shape[:axis], *idx.shape, *g.shape[axis + 1:])
        acc = ((g * w.reshape(shape)).sum(axis + 1)
               + (1 << (PRECISION_BITS - 1)))
        out.append((acc.clamp_min(0) >> PRECISION_BITS).clamp_max(255)
                   .to(torch.uint8))
    return torch.cat(out)


def resize(frames: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """uint8 [T, H, W, 3] → [T, out_h, out_w, 3] on frames' device."""
    x = frames
    if out_w != x.shape[2]:
        x = _pass(x, coefficients(x.shape[2], out_w), 2)
    if out_h != x.shape[1]:
        x = _pass(x, coefficients(x.shape[1], out_h), 1)
    return x


def _shape(h: int, w: int, size: int) -> Tuple[int, int]:
    if h <= w:
        return size, int(size * w / h)
    return int(size * h / w), size


def resize_crop(frames: torch.Tensor, size: int) -> torch.Tensor:
    h, w = frames.shape[1:3]
    rh, rw = _shape(h, w, size)
    top = int(round((rh - size) / 2.0))
    left = int(round((rw - size) / 2.0))
    return resize(frames, rh, rw)[:, top:top + size, left:left + size]


def dual_stream(frames: torch.Tensor, num_segs: int, temporal: int = 224,
                spatial: int = 336) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 frames [F, H, W, 3] (on any device) → (temporal [F, 224, 224,
    3], spatial [num_segs, 336, 336, 3]) there."""
    per = frames.shape[0] // num_segs
    mid = [i * per + per // 2 for i in range(num_segs)]
    return (resize_crop(frames, temporal).contiguous(),
            resize_crop(frames[mid], spatial).contiguous())
