"""Build the port's host-side C++ helpers (no CUDA): at first use a source
is compiled with g++ into
``build/host_kernels/<hash of source and flags>/lib<name>.so`` under the
repository root (gitignored) and loaded with ctypes by its caller. An edit
of the source or of the flags changes the hash, so a stale library is never
loaded. Nothing is built when a module is imported; ``ops/cuda_build.py``
does the same for the CUDA kernels.

The first helper is the PIL-exact resize, ``cpp/pil_resize.cc`` built
alone: it needs only the C++ standard library, where ``cpp/Makefile`` links
it with the libav frame decoder into ``libgvd_decoder.so``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BUILD_ROOT = REPO / "build" / "host_kernels"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path(source: Path, name: str) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(GXX_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"


def build_library(source: Path, name: str) -> Path:
    """Compile ``source`` into lib<name>.so unless this exact source (by
    hash) was built already → the library's path. Raises RuntimeError if
    g++ is missing or fails."""
    so = library_path(source, name)
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: cannot build " + str(source))
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so
