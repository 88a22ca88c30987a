# The port's own copy of grounded_video_llm_tpu/video/native/decoder.py, which imports no
# framework; tests/test_torch_shared_modules.py holds the two to each other.
"""ctypes binding for the native libav frame decoder (cpp/frame_decoder.cc);
the port's copy of grounded_video_llm_tpu/video/native/decoder.py.

The fast path for video/reader.py: batch random-access frame decode with
keyframe-aware seeking, one context per call (thread-safe from loader worker
threads; ctypes releases the GIL during the C call, so decode overlaps with
device compute).

The library is the one ``make -C cpp`` builds (cpp/Makefile writes it under
grounded_video_llm_tpu/video/native/); it is loaded by path, so no Python
module of the JAX package is imported."""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir, os.pardir,
    "grounded_video_llm_tpu", "video", "native", "libgvd_decoder.so")
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.gvd_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.gvd_probe.restype = ctypes.c_int
        lib.gvd_decode_frames.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.gvd_decode_frames.restype = ctypes.c_int
        _lib = lib
    except OSError:
        _load_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def reload() -> bool:
    """Retry loading after an external build (e.g. bench.py building cpp/
    on a fresh checkout where the .so wasn't present at first import)."""
    global _load_failed
    _load_failed = False
    return available()


def probe(path: str) -> Tuple[int, float]:
    """→ (num_frames, fps). Raises IOError on failure."""
    lib = _load()
    if lib is None:
        raise IOError("native decoder not built")
    nframes = ctypes.c_int64()
    fps = ctypes.c_double()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.gvd_probe(path.encode(), ctypes.byref(nframes), ctypes.byref(fps),
                       ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"gvd_probe({path}) failed: {rc}")
    return int(nframes.value), float(fps.value)


def probe_full(path: str) -> Tuple[int, float, int, int]:
    lib = _load()
    if lib is None:
        raise IOError("native decoder not built")
    nframes = ctypes.c_int64()
    fps = ctypes.c_double()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.gvd_probe(path.encode(), ctypes.byref(nframes), ctypes.byref(fps),
                       ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"gvd_probe({path}) failed: {rc}")
    return int(nframes.value), float(fps.value), int(w.value), int(h.value)


def decode_frames(path: str, indices: List[int]) -> np.ndarray:
    """→ uint8 [len(indices), H, W, 3] RGB, in the order given."""
    lib = _load()
    if lib is None:
        raise IOError("native decoder not built")
    _, _, w, h = probe_full(path)
    n = len(indices)
    out = np.empty((n, h, w, 3), dtype=np.uint8)
    idx = np.asarray(indices, dtype=np.int64)
    rc = lib.gvd_decode_frames(
        path.encode(), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(n), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise IOError(f"gvd_decode_frames({path}) failed: {rc}")
    return out
