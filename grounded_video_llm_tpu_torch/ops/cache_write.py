"""In-place per-row slot writes into the int8 KV cache: K5
(``scatter_write``) and K9 (``scatter_write_multi``), both in
csrc/cache_write.cu, with their plain PyTorch versions (port of
grounded_video_llm_tpu/ops/cache_write.py: ``scatter_write_kv`` /
``scatter_write_scale`` and ``scatter_write_kv_multi`` /
``scatter_write_scale_multi``).

``scatter_write(caches, news, idx)`` does, for each pair at once,
``cache[l, b, h, idx[b]] = new[l, b, h]`` for every layer l, row b and kv
head h: caches are [L, B, Hkv, max_len, *E] (int8 values with E = (D,), or
fp32 scales with E = ()), news [L, B, Hkv, *E] in the cache's dtype. The
buffers keep their storage (same data_ptr) and every other byte. One launch
writes up to four buffers (k, k scales, v, v scales): one per decode step.
A slot outside [0, max_len) writes nothing.

``scatter_write_multi(caches, news, base)`` is the speculative-verify
commit: ``cache[l, b, h, base[b] + s] = new[l, b, s, h]`` for s < S <= 128,
news [L, B, S, Hkv, *E]. One launch per verify pass writes all four
buffers. It has its own launch counter (``SCATTER_WRITE_MULTI``), so K5's
and K9's launches are told apart.
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
# gvllm_scatter_write_multi(dst[], src[], elem_bytes[], n, base, rows, B,
#                           Hkv, S, max_len, stream) -> cudaError_t
SCATTER_WRITE_MULTI = CudaKernel(
    "cache_write.cu", "gvllm_scatter_write_multi",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def scatter_write_multi_reference(caches: Sequence[torch.Tensor],
                                  news: Sequence[torch.Tensor],
                                  base: torch.Tensor) -> None:
    """Plain version of K9: the same writes, one row and slot at a time."""
    for cache, new in zip(caches, news):
        max_len, S = cache.shape[3], new.shape[2]
        for b, b0 in enumerate(base.tolist()):
            for s in range(S):
                if 0 <= b0 + s < max_len:
                    cache[:, b, :, b0 + s] = new[:, b, s]


def scatter_write_reference(caches: Sequence[torch.Tensor],
                            news: Sequence[torch.Tensor],
                            idx: torch.Tensor) -> None:
    """Plain version of K5: K9's with one slot per row."""
    scatter_write_multi_reference(caches, [n.unsqueeze(2) for n in news], idx)


def _check(name, caches, news, idx):
    """Launch checks of both kernels; news [L, B, S, Hkv, *E]."""
    if not 1 <= len(caches) <= 4 or len(caches) != len(news):
        raise ValueError(f"{name} takes 1 to 4 cache/new pairs, got "
                         f"{len(caches)} caches and {len(news)} news")
    lead = caches[0].shape[:4]
    if len(lead) != 4:
        raise ValueError(f"{name}: caches are [L, B, Hkv, max_len, *E]")
    S = news[0].shape[2] if news[0].dim() >= 4 else 0
    if not 1 <= S <= 128:
        raise ValueError(f"{name} writes 1 to 128 slots per row, got news "
                         f"{tuple(news[0].shape)}")
    for cache, new in zip(caches, news):
        if cache.device != idx.device or new.device != idx.device:
            raise ValueError(f"{name}: caches, news and the slots must share "
                             "a device")
        if cache.shape[:4] != lead:
            raise ValueError(f"{name}: cache {tuple(cache.shape)} does not "
                             f"share [L, B, Hkv, max_len] = {tuple(lead)}")
        want = (tuple(cache.shape[:2]) + (S, cache.shape[2])
                + tuple(cache.shape[4:]))
        if tuple(new.shape) != want:
            raise ValueError(f"{name}: new {tuple(new.shape)} does not match "
                             f"cache {tuple(cache.shape)} with {S} slots")
        if new.dtype != cache.dtype:
            raise TypeError(f"{name}: new is {new.dtype}, cache {cache.dtype}")
        if not (cache.is_contiguous() and new.is_contiguous()) or \
                cache.data_ptr() % 4 or new.data_ptr() % 4:
            raise ValueError(f"{name} kernel takes contiguous, 4-byte aligned "
                             "caches and news")
        if (new[0, 0, 0, 0].numel() * new.element_size()) % 4:
            raise ValueError(f"{name} kernel moves 4-byte words: a slot's "
                             "bytes must be a multiple of 4")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (lead[1],):
        raise ValueError(f"{name} kernel takes int32 slots [B], got "
                         f"{idx.dtype} {tuple(idx.shape)}")


def _check_launch_args(caches, news, idx):
    _check("scatter_write", caches, [n.unsqueeze(2) for n in news], idx)


def _check_multi_args(caches, news, base):
    _check("scatter_write_multi", caches, news, base)


def _launch(kernel, name, caches, news, idx):
    """One launch of K5 or K9 for all pairs; news [L, B, S, Hkv, *E]."""
    if idx.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {idx.device}")
    idx = idx.to(torch.int32).contiguous()
    news = [n.contiguous() for n in news]
    _check(name, caches, news, idx)
    L, B, Hkv, max_len = caches[0].shape[:4]
    S = news[0].shape[2]
    dst = (ctypes.c_void_p * 4)(*[c.data_ptr() for c in caches])
    src = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in news])
    elem = (ctypes.c_int * 4)(*[t[0, 0, 0, 0].numel() * t.element_size()
                                for t in news])
    slots = (S,) if kernel is SCATTER_WRITE_MULTI else ()
    kernel(ctypes.cast(dst, ctypes.c_void_p), ctypes.cast(src, ctypes.c_void_p),
           ctypes.cast(elem, ctypes.c_void_p), len(caches), idx.data_ptr(),
           L * B * Hkv, B, Hkv, *slots, max_len,
           torch.cuda.current_stream(idx.device).cuda_stream)
    kernel.launches += 1


def scatter_write(caches: Sequence[torch.Tensor],
                  news: Sequence[torch.Tensor], idx: torch.Tensor) -> None:
    """K5, in place. CPU tensors run the plain version; CUDA tensors launch
    the kernel once for all pairs (counted in SCATTER_WRITE.launches) or
    raise."""
    if idx.device.type == "cpu":
        scatter_write_reference(caches, news, idx)
        return
    _launch(SCATTER_WRITE, "scatter_write", caches,
            [n.unsqueeze(2) for n in news], idx)


def scatter_write_multi(caches: Sequence[torch.Tensor],
                        news: Sequence[torch.Tensor],
                        base: torch.Tensor) -> None:
    """K9, in place. CPU tensors run the plain version; CUDA tensors launch
    the kernel once for all pairs (counted in SCATTER_WRITE_MULTI.launches)
    or raise."""
    if base.device.type == "cpu":
        scatter_write_multi_reference(caches, news, base)
        return
    _launch(SCATTER_WRITE_MULTI, "scatter_write_multi", caches, news, base)
