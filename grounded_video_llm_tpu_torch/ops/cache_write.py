"""In-place per-row slot writes into the int8 KV cache: K5
(``scatter_write``, csrc/cache_write.cu) and its plain PyTorch version (port
of grounded_video_llm_tpu/ops/cache_write.py, ``scatter_write_kv`` and
``scatter_write_scale``).

``scatter_write(caches, news, idx)`` does, for each pair at once,
``cache[l, b, h, idx[b]] = new[l, b, h]`` for every layer l, row b and kv
head h: caches are [L, B, Hkv, max_len, *E] (int8 values with E = (D,), or
fp32 scales with E = ()), news [L, B, Hkv, *E] in the cache's dtype. The
buffers keep their storage (same data_ptr) and every other byte. One launch
writes up to four buffers (k, k scales, v, v scales): one per decode step.
A slot outside [0, max_len) writes nothing.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .cuda_build import CudaKernel

# gvllm_scatter_write(dst[], src[], elem_bytes[], n, idx, rows, B, Hkv,
#                     max_len, stream) -> cudaError_t
SCATTER_WRITE = CudaKernel(
    "cache_write.cu", "gvllm_scatter_write",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def scatter_write_reference(caches: Sequence[torch.Tensor],
                            news: Sequence[torch.Tensor],
                            idx: torch.Tensor) -> None:
    """Plain version: the same writes, one row at a time."""
    for cache, new in zip(caches, news):
        max_len = cache.shape[3]
        for b, slot in enumerate(idx.tolist()):
            if 0 <= slot < max_len:
                cache[:, b, :, slot] = new[:, b]


def _check_launch_args(caches, news, idx):
    if not 1 <= len(caches) <= 4 or len(caches) != len(news):
        raise ValueError(f"scatter_write takes 1 to 4 cache/new pairs, got "
                         f"{len(caches)} caches and {len(news)} news")
    lead = caches[0].shape[:4]
    if len(lead) != 4:
        raise ValueError("scatter_write: caches are [L, B, Hkv, max_len, *E]")
    for cache, new in zip(caches, news):
        if cache.device != idx.device or new.device != idx.device:
            raise ValueError("scatter_write: caches, news and idx must share "
                             "a device")
        if cache.shape[:4] != lead:
            raise ValueError(f"scatter_write: cache {tuple(cache.shape)} does "
                             f"not share [L, B, Hkv, max_len] = {tuple(lead)}")
        if tuple(new.shape) != tuple(cache.shape[:3] + cache.shape[4:]):
            raise ValueError(f"scatter_write: new {tuple(new.shape)} does "
                             f"not match cache {tuple(cache.shape)}")
        if new.dtype != cache.dtype:
            raise TypeError(f"scatter_write: new is {new.dtype}, cache "
                            f"{cache.dtype}")
        if not (cache.is_contiguous() and new.is_contiguous()) or \
                cache.data_ptr() % 4 or new.data_ptr() % 4:
            raise ValueError("scatter_write kernel takes contiguous, 4-byte "
                             "aligned caches and news")
        if (new[0, 0, 0].numel() * new.element_size()) % 4:
            raise ValueError("scatter_write kernel moves 4-byte words: a "
                             "slot's bytes must be a multiple of 4")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (lead[1],):
        raise ValueError(f"scatter_write kernel takes int32 idx [B], got "
                         f"{idx.dtype} {tuple(idx.shape)}")


def scatter_write(caches: Sequence[torch.Tensor],
                  news: Sequence[torch.Tensor], idx: torch.Tensor) -> None:
    """K5, in place. CPU tensors run the plain version; CUDA tensors launch
    the kernel once for all pairs (counted in SCATTER_WRITE.launches) or
    raise."""
    if idx.device.type == "cpu":
        scatter_write_reference(caches, news, idx)
        return
    if idx.device.type != "cuda":
        raise RuntimeError(f"scatter_write: no kernel for device {idx.device}")
    idx = idx.to(torch.int32).contiguous()
    news = [n.contiguous() for n in news]
    _check_launch_args(caches, news, idx)
    n = len(caches)
    L, B, Hkv, max_len = caches[0].shape[:4]
    dst = (ctypes.c_void_p * 4)(*[c.data_ptr() for c in caches])
    src = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in news])
    elem = (ctypes.c_int * 4)(*[t[0, 0, 0].numel() * t.element_size()
                                for t in news])
    SCATTER_WRITE(ctypes.cast(dst, ctypes.c_void_p),
                  ctypes.cast(src, ctypes.c_void_p),
                  ctypes.cast(elem, ctypes.c_void_p), n, idx.data_ptr(),
                  L * B * Hkv, B, Hkv, max_len,
                  torch.cuda.current_stream(idx.device).cuda_stream)
    SCATTER_WRITE.launches += 1
