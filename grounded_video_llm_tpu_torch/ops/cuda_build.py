"""Build and bind the port's hand-written CUDA kernels.

Every kernel source lives in ``grounded_video_llm_tpu_torch/csrc/`` and has a
plain C interface (no PyTorch headers, so nvcc takes seconds). At first use
it is compiled with nvcc for ``sm_90a`` into
``build/torch_kernels/<hash of source, its headers and flags>/lib<stem>.so``
under the repository root (gitignored) and loaded with ctypes. An edit of
the source or of a header it includes from its own directory (or of one
that header includes) changes the hash, so a stale library is never
loaded. Nothing is built when a module is imported.

``CudaKernel`` is one exported C entry point of such a library plus the
number of launches made through its Python wrapper (``launches``). Several
entry points may share one source; the library is built once.
``build_all`` starts one nvcc per distinct source at the same time and waits
for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every CudaKernel made, in creation order (tests and chip_smoke walk it)
REGISTRY: List["CudaKernel"] = []


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return nvcc


def _headers(source: Path, seen: Optional[set] = None) -> set:
    """The headers ``source`` includes from its own directory, and theirs."""
    seen = set() if seen is None else seen
    for name in re.findall(rb'#include "([^"]+)"', source.read_bytes()):
        header = source.parent / name.decode()
        if header not in seen:
            seen.add(header)
            _headers(header, seen)
    return seen


class CudaKernel:
    """A ctypes-bound entry point ``symbol`` of the library built from
    ``csrc/<source>``. argtypes: the C signature (c_void_p for every pointer
    and the stream); every entry point returns a cudaError_t as int."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._fn = None
        REGISTRY.append(self)

    def library_path(self) -> Path:
        text = self.source.read_bytes()
        digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
        for header in sorted(_headers(self.source)):
            digest.update(header.read_bytes())
        return (BUILD_ROOT / digest.hexdigest()[:16]
                / f"lib{self.source.stem}.so")

    def _command(self, out: Path) -> List[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def build(self) -> Path:
        """Compile the source unless this exact source (by hash) was built
        already. Raises if nvcc is missing or fails."""
        so = self.library_path()
        if not so.exists():
            build_all([self])
        return so

    def function(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(self.build()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        """Launch through the C entry point; raise on a refused launch.
        The caller counts the launch (``launches``) where it means one."""
        err = self.function()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError {err}")


def build_all(kernels: Optional[List[CudaKernel]] = None) -> Dict[str, float]:
    """Build every distinct source of ``kernels`` (default: all registered)
    with one nvcc process each, all started together. Returns
    {source name: seconds}; each kernel's build_log / build_seconds is set.
    Raises if nvcc is missing or any build fails."""
    kernels = REGISTRY if kernels is None else kernels
    by_so: Dict[Path, List[CudaKernel]] = {}
    for k in kernels:
        by_so.setdefault(k.library_path(), []).append(k)
    todo = {so: ks for so, ks in by_so.items() if not so.exists()}
    procs = []
    for so, ks in todo.items():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs.append((so, tmp, ks, time.perf_counter(), subprocess.Popen(
            ks[0]._command(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    seconds, failed = {}, []
    for so, tmp, ks, t0, proc in procs:
        log, _ = proc.communicate()
        dt = time.perf_counter() - t0
        seconds[ks[0].source.name] = dt
        for k in ks:
            k.build_log, k.build_seconds = log, dt
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {ks[0].source.name}:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds
