"""Collation: dataset samples → a vlm.Batch of tensors on one device (port of
grounded_video_llm_tpu/data/collate.py).

Tokenization, label masking, right padding and truncation at max_txt_len
(text/tokenizer.py), pixel stacking (fp32 normalized or raw uint8, which
models/vlm.encode_video normalizes on the device) and the text-only flag
(video_ids == 'text'). Sequence lengths are rounded up to pad_to, as in the
JAX package, so batches come in a few shapes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.vlm import Batch
from ..text.templates import ChatTemplate
from ..text.tokenizer import make_labels, pad_batch_train, tokenize_with_image


def collate(samples: List[Dict], tokenizer, template: ChatTemplate,
            max_txt_len: int = 2048, pad_to: Optional[int] = 64,
            device="cpu") -> Batch:
    seq_ids, seq_labels = [], []
    for s in samples:
        ids = tokenize_with_image(s["text_inputs"], tokenizer)
        seq_ids.append(ids)
        seq_labels.append(make_labels(ids, s["text_inputs"], tokenizer,
                                      template))
    input_ids, labels, mask = pad_batch_train(
        seq_ids, seq_labels, tokenizer.pad_token_id, tokenizer.eos_token_id,
        max_txt_len, pad_to=pad_to)
    temporal = np.stack([s["temporal_pixel_values"] for s in samples])
    spatial = np.stack([s["spatial_pixel_values"] for s in samples])
    is_text = np.asarray([s["video_ids"] == "text" for s in samples])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Batch(input_ids=dev(input_ids), labels=dev(labels),
                 attn_mask=dev(mask), spatial_pixels=dev(spatial),
                 temporal_pixels=dev(temporal), is_text=dev(is_text))
