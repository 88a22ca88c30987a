"""Sizes for the benchmark's CPU tests."""

import dataclasses


def micro_config(conf: dict) -> dict:
    """The configuration at the program's micro test sizes: the same
    keys, every width and depth small, no LongRoPE tables. The output
    head is drawn wider (std scaled by the root of the hidden sizes' ratio)
    so that the logits spread as the configuration's do, and a gap means
    at this size what it means at full size."""
    from grounded_video_llm_tpu_torch.core.config import micro_vlm_config

    m = micro_vlm_config(conf["llm_name"])
    d = dataclasses.asdict(m)
    out = dict(conf)
    for k in ("clip", "video", "llm"):
        out[k] = d[k]
    out["llm"]["rope_scaling_short"] = []
    out["llm"]["rope_scaling_long"] = []
    out["num_frames"], out["num_segs"] = m.num_frames, m.num_segs
    std = 0.02 * (conf["llm"]["hidden_size"] / m.llm.hidden_size) ** 0.5
    out["init"] = [["llm/lm_head", "normal", 0.0, std]] + conf["init"]
    return out


def small_mix(mix: dict) -> dict:
    """The mix with 2 clients, 96x128 frames, a pool of 2 and answers of
    2-8 tokens."""
    out = dict(mix, clients=2, budgets=[2, 4, 6, 8])
    out["videos"] = dict(mix["videos"], height=96, width=128)
    out["server"] = dict(mix["server"], pool_size=2, max_new_tokens=8)
    out["check"] = dict(mix["check"], sample=3)
    out["trace"] = dict(mix["trace"], seconds=0.5)
    return out
