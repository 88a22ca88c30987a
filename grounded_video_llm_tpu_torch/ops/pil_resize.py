# The port's own copy of grounded_video_llm_tpu/ops/pil_resize.py, which imports no
# framework, with one more native route: cpp/pil_resize.cc built alone
# (ops/host_build.py) where the libav decoder library is absent.
# tests/test_torch_shared_modules.py and tests/test_torch_host_resize.py hold
# it to the original.
"""PIL-exact bicubic resize (uint8, fixed-point) — the reference's pixel path.

The reference preprocesses every frame with torchvision's PIL backend:
ToPILImage → Resize(size, BICUBIC) → CenterCrop (mm_utils/utils.py:153-183,
torchvision==0.16.2 + Pillow==11.1.0 per requirements.txt). PIL *antialiases*
on downscale — the filter support is scaled by the scale factor — and runs
uint8 fixed-point arithmetic with a quantized uint8 intermediate between the
horizontal and vertical passes. cv2.INTER_CUBIC does neither, and the frozen
encoders were trained on PIL-resized pixels, so anything but bit-exact PIL
output is an uncontrolled accuracy perturbation at the benchmark gate.

This module reproduces Pillow's `ImagingResample` (src/libImaging/Resample.c)
bit-for-bit for 8-bit RGB:

  * precompute_coeffs: scaled support (bicubic support=2.0 × max(1, scale)),
    window [int(center-support+0.5), int(center+support+0.5)), per-window
    double-precision normalization with C's sequential summation order;
  * normalize_coeffs_8bpc: coefficients quantized to int32 with
    PRECISION_BITS = 32-8-2 = 22 and round-half-away truncation;
  * two passes, horizontal then vertical, each accumulating
    pix·kk + (1 << (PRECISION_BITS-1)) and applying clip8 (clamp-then-shift),
    with the uint8 quantization BETWEEN the passes as PIL does.

The numpy implementation is the portable oracle; the C++ twin
(cpp/pil_resize.cc) is the hot path of the host pipeline. It is bound from
video/native/decoder.py's .so where ``make -C cpp`` built it, else from the
source built alone with g++ at first use (ops/host_build.py; a host without
libav, such as the GPU host, has no decoder library). `resize_bicubic_u8`
dispatches native→numpy; ``ROUTE_CALLS`` counts the batch calls each route
served, so a caller can require the native one. Both are parity-tested
against Pillow itself (tests/test_pil_resize.py) and against each other.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2  # Pillow Resample.c
_SUPPORT = 2.0               # bicubic filter support


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter, a = -0.5, exact expression order."""
    a = -0.5
    x = np.abs(x)
    # ((a + 2) * x - (a + 3)) * x * x + 1            for x < 1
    # (((x - 5) * x + 8) * x - 4) * a                for x < 2
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@functools.lru_cache(maxsize=64)
def _coeff_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] int64 matrix of Pillow's quantized
    coefficients (zero outside each output pixel's window). Dense keeps the
    pass a single integer tensordot; at frame sizes the matrix is ≤ a few
    hundred KB and LRU-cached per (in,out) pair."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ss = 1.0 / filterscale
    W = np.zeros((out_size, in_size), dtype=np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = int(center - support + 0.5)
        if xmin < 0:
            xmin = 0
        xmax = int(center + support + 0.5)
        if xmax > in_size:
            xmax = in_size
        n = xmax - xmin
        w = _bicubic((np.arange(n) + xmin - center + 0.5) * ss)
        # C normalizes by a sequentially-accumulated sum; numpy's pairwise
        # .sum() can differ in the last ulp, which the int quantization below
        # would amplify to an off-by-one coefficient
        ww = 0.0
        for v in w:
            ww += float(v)
        if ww != 0.0:
            w = w / ww
        # normalize_coeffs_8bpc: (int)(±0.5 + w * (1 << PRECISION_BITS))
        q = w * float(1 << PRECISION_BITS)
        W[xx, xmin:xmax] = np.trunc(q + np.where(w < 0.0, -0.5, 0.5)).astype(
            np.int64)
    return W


def _clip8(v: np.ndarray) -> np.ndarray:
    """Pillow clip8: clamp the ACCUMULATOR, then shift out the precision."""
    return np.minimum(np.maximum(v, 0) >> PRECISION_BITS, 255).astype(np.uint8)


def _resize_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bit-exact numpy twin of Pillow's two-pass 8bpc resample."""
    h, w = img.shape[:2]
    half = np.int64(1 << (PRECISION_BITS - 1))
    x = img
    if out_w != w:
        Wm = _coeff_matrix(w, out_w)                       # [out_w, w]
        acc = np.tensordot(x.astype(np.int64), Wm, axes=([1], [1]))
        x = _clip8(acc + half).transpose(0, 2, 1)          # [h, out_w, C]
    if out_h != h:
        Wm = _coeff_matrix(h, out_h)                       # [out_h, h]
        acc = np.tensordot(Wm, x.astype(np.int64), axes=([1], [0]))
        x = _clip8(acc + half)                             # [out_h, out_w, C]
    return np.ascontiguousarray(x)


# ---------------------------------------------------------------------------
# native dispatch
# ---------------------------------------------------------------------------

NATIVE_SOURCE = Path(__file__).resolve().parents[2] / "cpp" / "pil_resize.cc"
# batch resizes served by each route since import (or reset_native_cache)
ROUTE_CALLS = {"native": 0, "numpy": 0}
# the library the native route loaded, and why the standalone build failed
NATIVE_LIBRARY = None
NATIVE_ERROR = None

_lock = threading.Lock()
_native_checked = False
_native = None


def _bind(lib):
    lib.gvd_pil_resize_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int]
    lib.gvd_pil_resize_batch_u8.restype = ctypes.c_int
    return lib


def _native_lib():
    """The decoder library where it exports the resize, else
    cpp/pil_resize.cc built alone; None (the numpy route) where neither
    loads."""
    global _native_checked, _native, NATIVE_LIBRARY, NATIVE_ERROR
    with _lock:
        if _native_checked:
            return _native
        _native_checked = True
        from ..video.native import decoder as nd
        lib = nd._load()
        if lib is not None and hasattr(lib, "gvd_pil_resize_batch_u8"):
            _native, NATIVE_LIBRARY = _bind(lib), nd._LIB_PATH
            return _native
        from . import host_build
        try:
            so = host_build.build_library(NATIVE_SOURCE, "gvd_pil_resize")
            _native, NATIVE_LIBRARY = _bind(ctypes.CDLL(str(so))), str(so)
        except (OSError, RuntimeError) as e:
            NATIVE_ERROR = str(e)
        return _native


def reset_native_cache():
    """Re-probe the libraries (bench.py builds cpp/ after first import) and
    zero the route counts."""
    global _native_checked, _native, NATIVE_LIBRARY, NATIVE_ERROR
    with _lock:
        _native_checked = False
        _native = NATIVE_LIBRARY = NATIVE_ERROR = None
        ROUTE_CALLS.update(native=0, numpy=0)


def _count(route: str) -> None:
    with _lock:
        ROUTE_CALLS[route] += 1


def resize_bicubic_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 [H, W, 3] → [out_h, out_w, 3], bit-exact with
    PIL.Image.resize((out_w, out_h), Image.BICUBIC)."""
    return resize_bicubic_batch_u8(img[None], out_h, out_w)[0]


def resize_bicubic_batch_u8(frames: np.ndarray, out_h: int,
                            out_w: int) -> np.ndarray:
    """uint8 [T, H, W, 3] → [T, out_h, out_w, 3], PIL-bit-exact. One C call
    for the whole batch when the native library loads (the GIL is released
    for the duration, so resize overlaps the device like decode does)."""
    assert frames.dtype == np.uint8 and frames.ndim == 4 and \
        frames.shape[-1] == 3, frames.shape
    T, h, w, _ = frames.shape
    if (h, w) == (out_h, out_w):
        return frames
    lib = _native_lib()
    if lib is not None:
        frames = np.ascontiguousarray(frames)
        out = np.empty((T, out_h, out_w, 3), dtype=np.uint8)
        rc = lib.gvd_pil_resize_batch_u8(
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int(T), ctypes.c_int(h), ctypes.c_int(w),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int(out_h), ctypes.c_int(out_w))
        if rc == 0:
            _count("native")
            return out
    _count("numpy")
    return np.stack([_resize_np(f, out_h, out_w) for f in frames])


def resized_shape_torchvision(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision 0.16.2 shorter-edge arithmetic
    (transforms/functional.py int-size path): the long edge is TRUNCATED,
    `int(size * long / short)`, not rounded."""
    short, long = (h, w) if h <= w else (w, h)
    new_short, new_long = size, int(size * long / short)
    return (new_short, new_long) if h <= w else (new_long, new_short)
