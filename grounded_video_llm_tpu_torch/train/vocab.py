"""Vocabulary expansion for the temporal tokens (port of
grounded_video_llm_tpu/train/vocab.py): NUM_SPECIAL_TOKENS new rows
(<0>..<300> and <timestamp_grounding>) appended to the input embedding and
as columns to lm_head, each the mean of the rows that were there.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def expand_vocab(llm_params: dict, num_new_tokens: int) -> dict:
    """A new LLM tree with num_new_tokens mean-initialised rows appended to
    embed [V, D] and columns to lm_head [D, V]."""
    embed = llm_params["embed"]
    lm_head = llm_params["lm_head"]
    mean_embed = embed.mean(dim=0, keepdim=True)
    new_embed = torch.cat(
        [embed, mean_embed.expand(num_new_tokens, embed.shape[1])], dim=0)
    mean_head = lm_head.mean(dim=1, keepdim=True)
    new_head = torch.cat(
        [lm_head, mean_head.expand(lm_head.shape[0], num_new_tokens)], dim=1)
    out = dict(llm_params)
    out["embed"] = new_embed
    out["lm_head"] = new_head
    return out
