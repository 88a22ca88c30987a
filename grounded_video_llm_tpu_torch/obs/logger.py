"""Rank-aware logging — the overwatch equivalent (reference
overwatch/overwatch.py:21-150): context-prefixed format, INFO on process 0 /
ERROR elsewhere (a copy of grounded_video_llm_tpu/obs/logger.py; the rank
comes from torch.distributed when a process group is initialized, else 0;
tests/test_torch_shared_modules.py holds it to the original)."""

from __future__ import annotations

import logging
import sys
from typing import Optional

LOG_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s :: %(message)s"
DATE_FORMAT = "%m/%d %H:%M:%S"

_CTX_PREFIXES = {1: "=>> ", 2: "   ->> ", 3: "      +>> "}


class ContextAdapter(logging.LoggerAdapter):
    """overwatch-style ctx-level indent prefixes (reference overwatch.py:42-47)."""

    def process(self, msg, kwargs):
        ctx_level = kwargs.pop("ctx_level", 0)
        return f"{_CTX_PREFIXES.get(ctx_level, '')}{msg}", kwargs


class Overwatch:
    def __init__(self, name: str, rank: int, world_size: int):
        self._rank = rank
        self._world_size = world_size
        logger = logging.getLogger(name)
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter(LOG_FORMAT, DATE_FORMAT))
            logger.addHandler(handler)
        logger.setLevel(logging.INFO if rank == 0 else logging.ERROR)
        self.logger = ContextAdapter(logger, {})
        for level in ("debug", "info", "warning", "error", "critical"):
            setattr(self, level, getattr(self.logger, level))

    def rank(self) -> int:
        return self._rank

    def world_size(self) -> int:
        return self._world_size

    def is_rank_zero(self) -> bool:
        return self._rank == 0

    def rank_zero_only(self, fn):
        if self._rank == 0:
            return fn
        return lambda *a, **k: None


def initialize_overwatch(name: str = "grounded_video_llm_tpu",
                         rank: Optional[int] = None,
                         world_size: Optional[int] = None) -> Overwatch:
    if rank is None or world_size is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            rank, world_size = dist.get_rank(), dist.get_world_size()
        else:
            rank, world_size = 0, 1
    return Overwatch(name, rank, world_size)
