"""The one traffic generator: every mix is a data file under
gvbench/traffic/ that this module reads.

A mix fixes the clients of a closed loop, the frames of each video and the
duration it stands for, how many questions a session asks about one video,
the multiset of answer budgets, the questions, and the server it is sent
to; its "sources" say where each value comes from. From a seed it gives
each client a plan: the same requests, in the same order, whatever the
timing. Budgets are stratified: each client's budgets come in blocks, each
block the whole multiset in an order drawn from the seed, so runs of
different seeds ask for the same work.

Videos: a few base videos are made in set-up (``base_video``, moving waves
and noise, a few vectorized passes); each session's video is derived from
one of them by a seeded time shift, channel order and mirror, a copy that
costs milliseconds, made by the client before its request's clock starts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 128 - 1), *keys])


def base_video(seed: int, n_frames: int, h: int, w: int) -> np.ndarray:
    """Seeded uint8 frames [F, h, w, 3]: moving waves of a random phase and
    frequency per channel plus uniform noise, made in a few vectorized
    passes."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    t = (0.2 * np.arange(n_frames, dtype=np.float32))[:, None, None]
    out = np.empty((n_frames, h, w, 3), np.uint8)
    for c in range(3):
        a = xx / r.uniform(10, 30) + yy / r.uniform(15, 35) \
            + r.uniform(0, 2 * np.pi)
        wave = np.sin(a)[None] * np.cos(t) + np.cos(a)[None] * np.sin(t)
        noise = r.integers(-12, 13, (n_frames, h, w), dtype=np.int16)
        out[..., c] = np.clip(127.5 + 90 * wave + noise, 0, 255)
    return out


@dataclass(frozen=True)
class VideoSpec:
    base: int
    shift: int
    channels: tuple
    mirror: bool
    duration: float


@dataclass(frozen=True)
class Planned:
    client: int
    index: int          # the client's k-th request
    session: int        # the client's k-th session
    video: VideoSpec
    question: str
    budget: int


def derive(bases: List[np.ndarray], spec: VideoSpec) -> np.ndarray:
    frames = np.roll(bases[spec.base], spec.shift, axis=0)[..., spec.channels]
    if spec.mirror:
        frames = frames[:, :, ::-1]
    return np.ascontiguousarray(frames)


def bases(mix: dict, seed: int, n_frames: int) -> List[np.ndarray]:
    v = mix["videos"]
    return [base_video(int(rng(seed, 1, i).integers(2 ** 31)), n_frames,
                       v["height"], v["width"])
            for i in range(v["bases"])]


def plan(mix: dict, seed: int, client: int,
         n_frames: int) -> Iterator[Planned]:
    """Client ``client``'s requests, in order, without end."""
    r = rng(seed, 2, client)
    budgets: List[int] = []
    per = mix["questions_per_video"]
    k = 0
    session = 0
    while True:
        video = VideoSpec(int(r.integers(mix["videos"]["bases"])),
                          int(r.integers(n_frames)),
                          tuple(int(c) for c in r.permutation(3)),
                          bool(r.integers(2)),
                          float(mix["videos"]["duration_s"]))
        for _ in range(per):
            if not budgets:
                budgets = [int(b) for b in r.permutation(mix["budgets"])]
            yield Planned(client, k, session, video,
                          mix["questions"][int(r.integers(
                              len(mix["questions"])))], budgets.pop())
            k += 1
        session += 1
