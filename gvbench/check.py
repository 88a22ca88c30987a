"""The comparison that decides ``correct`` in the serving cells.

Once the window has closed, a sample of the requests it finished, drawn
from the seed and always holding the one with the most served tokens, is
run through the float32 reference: each request's video from its frames
(the reference's own resize and encoders), its prompt from its question
(the reference's own template and tokens), then the served tokens, as one
sequence. The number compared is the widest gap by which a served token's
reference logit lies below the reference's best at that position (greedy
serving gives every token the program thought best).

The control puts the reference in the program's place at the precision
below the one the configuration states (bf16 → fp8 e4m3: every weight and
every activation rounded to e4m3 with one scale a tensor before each
product) and reads, at each position of the same prompts and tokens, the
gap of the token it puts first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from .reference import resize as ref_resize
from .reference.vlm import Reference, grounding_prompt_ids, strict_float32

E4M3_MAX = 448.0


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with both operands rounded to fp8 e4m3, one scale a tensor."""
    def q(t):
        s = t.abs().amax().clamp_min(1e-12) / E4M3_MAX
        return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return q(x) @ q(w)


@dataclass
class Served:
    """One finished request as the check sees it."""
    video: object          # traffic.VideoSpec
    question: str
    tokens: List[int]


def sample(done: Sequence[Served], n: int, seed: int) -> List[int]:
    """Indices of n requests drawn from the seed, the longest always in."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].tokens))
    rest = [i for i in range(len(done)) if i != longest]
    r = np.random.default_rng([int(seed) & (2 ** 128 - 1), 3])
    pick = list(r.choice(rest, size=min(n - 1, len(rest)), replace=False))
    return sorted([longest] + [int(i) for i in pick])


def gaps(conf: dict, weights: dict, requests: Sequence[Served],
         frames_of: Callable, device, control: bool = False) -> Dict:
    """Over every served token of ``requests``: the widest gap of the
    served token (and, with control, of the token the fp8 reference puts
    first) below the float32 reference's best → {"gap", "control_gap",
    "tokens"}."""
    ref = Reference(conf, weights)
    low = Reference(conf, weights, fp8_matmul) if control else None
    worst, worst_ctl, count = 0.0, 0.0, 0
    videos: dict = {}
    with torch.no_grad(), strict_float32():
        for req in requests:
            if not req.tokens:
                continue
            if req.video not in videos:
                frames = torch.from_numpy(frames_of(req.video)).to(device)
                t, s = ref_resize.dual_stream(
                    frames, conf["num_segs"], conf["temporal_image_size"],
                    conf["spatial_image_size"])
                videos[req.video] = tuple(
                    r.video_tokens(t, s) for r in ([ref, low] if control
                                                   else [ref]))
            ids = grounding_prompt_ids(conf, req.question)
            logits = ref.served_logits(ids, videos[req.video][0], req.tokens)
            best = logits.max(-1).values
            tok = torch.tensor(req.tokens, device=logits.device)
            served = logits.gather(1, tok[:, None])[:, 0]
            worst = max(worst, float((best - served).max()))
            count += len(req.tokens)
            if control:
                lo = low.served_logits(ids, videos[req.video][1], req.tokens)
                pick = lo.argmax(-1)
                ctl = logits.gather(1, pick[:, None])[:, 0]
                worst_ctl = max(worst_ctl, float((best - ctl).max()))
                del lo
            del logits
    out = {"gap": worst, "tokens": count}
    if control:
        out["control_gap"] = worst_ctl
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} for each number compared."""
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def passed(checks: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
