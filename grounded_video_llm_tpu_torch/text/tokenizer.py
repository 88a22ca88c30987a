# The port's own copy of grounded_video_llm_tpu/text/tokenizer.py, which imports no
# framework; tests/test_torch_shared_modules.py holds the two to each other.
"""Tokenizer protocol, vocab expansion, image-token splicing, and label masking.

Host-side text processing with exact reference parity:
  tokenize_with_image — reference models/llava_next_video.py:409-426
  make_labels         — reference models/llava_next_video.py:325-407 (per-LLM
                        off-by-one variants)
  pad/truncate        — reference models/llava_next_video.py:428-452 (train,
                        right-pad) and :630-647 (generate, flip-pad-flip left pad)

Two tokenizer backends: an HF adapter (when tokenizer files are on disk) and a
deterministic byte-level fallback used by tests and offline smoke runs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .templates import (DEFAULT_IMAGE_TOKEN, GROUNDING_TOKEN, IGNORE_INDEX,
                        IMAGE_TOKEN_INDEX, ChatTemplate, get_template)


def temporal_token_strings(num_temporal_tokens: int = 300) -> List[str]:
    """<0>..<N> plus the grounding control token — 302 strings for N=300
    (reference llava_next_video.py:236-238)."""
    toks = [f"<{i}>" for i in range(num_temporal_tokens + 1)]
    toks.append(GROUNDING_TOKEN)
    return toks


class ByteTokenizer:
    """Deterministic byte-level tokenizer with registered multi-byte specials.

    Layout: 0=pad, 1=bos, 2=eos(unused placeholder), 3..258 = bytes,
    then registered special strings in registration order. Special strings
    (template separators, temporal tokens) always tokenize to a single id so
    the label-masking arithmetic (eos_token_length=1 etc.) holds exactly as it
    does for the reference's sentencepiece vocabularies.
    """

    def __init__(self, specials: Sequence[str] = (), add_bos: bool = True):
        self.pad_token_id = 0
        self.bos_token_id = 1
        self._byte_offset = 3
        self.add_bos = add_bos
        self._specials: Dict[str, int] = {}
        self._specials_rev: Dict[int, str] = {}
        for s in specials:
            self.add_special(s)
        self.eos_token_id = 2  # may be overridden to a registered special

    @property
    def vocab_size(self) -> int:
        return self._byte_offset + 256 + len(self._specials)

    def add_special(self, s: str) -> int:
        if s in self._specials:
            return self._specials[s]
        idx = self._byte_offset + 256 + len(self._specials)
        self._specials[s] = idx
        self._specials_rev[idx] = s
        return idx

    def add_specials(self, strings: Sequence[str]) -> List[int]:
        return [self.add_special(s) for s in strings]

    def convert_token_to_id(self, s: str) -> Optional[int]:
        return self._specials.get(s)

    def _encode_raw(self, text: str) -> List[int]:
        ids: List[int] = []
        i = 0
        # longest-match specials first
        specials = sorted(self._specials, key=len, reverse=True)
        while i < len(text):
            matched = False
            for s in specials:
                if text.startswith(s, i):
                    ids.append(self._specials[s])
                    i += len(s)
                    matched = True
                    break
            if not matched:
                ids.extend(self._byte_offset + b for b in text[i].encode("utf-8"))
                i += 1
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self._encode_raw(text)
        if self.add_bos and add_special_tokens:
            return [self.bos_token_id] + ids
        return ids

    def __call__(self, text: str):
        class _Out:
            pass

        out = _Out()
        out.input_ids = self.encode(text)
        return out

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def _flush():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i in self._specials_rev:
                _flush()
                s = self._specials_rev[i]
                # temporal tokens are not "special" for decoding purposes: the
                # grounding parser needs to see <n> in the output text.
                is_temporal = s.startswith("<") and s[1:-1].lstrip("-").isdigit()
                if not skip_special_tokens or is_temporal:
                    out.append(s)
            elif i >= self._byte_offset and i < self._byte_offset + 256:
                byte_buf.append(i - self._byte_offset)
            elif not skip_special_tokens:
                _flush()
                out.append(f"<id_{i}>")
        _flush()
        return "".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]


def build_test_tokenizer(llm_name: str = "phi3.5",
                         num_temporal_tokens: int = 300) -> ByteTokenizer:
    """Byte tokenizer pre-loaded with the template's control strings + temporal
    tokens, with eos/pad wired the way the reference overrides them
    (llama3: eos=<|eot_id|>, pad=<|end_of_text|>; phi3.5: pad=<|end|>,
    reference llava_next_video.py:103-114)."""
    template = get_template(llm_name)
    tok = ByteTokenizer()
    if llm_name == "phi3.5":
        specials = ["<|system|>", "<|user|>", "<|assistant|>", "<|endoftext|>", "<|end|>"]
    elif llm_name == "llama3":
        specials = ["<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>",
                    "<|end_of_text|>"]
    else:
        specials = ["</s>"]
    tok.add_specials(specials)
    tok.eos_token_id = tok.convert_token_to_id(template.eos)
    if llm_name == "phi3.5":
        tok.pad_token_id = tok.convert_token_to_id("<|end|>")
    elif llm_name == "llama3":
        tok.pad_token_id = tok.convert_token_to_id("<|end_of_text|>")
    else:
        tok.pad_token_id = 0
    tok.add_specials(temporal_token_strings(num_temporal_tokens))
    return tok


class HFTokenizer:
    """Adapter over a transformers tokenizer loaded from local files, applying
    the reference's per-LLM id overrides (llava_next_video.py:100-115)."""

    def __init__(self, path: str, llm_name: str):
        from transformers import AutoTokenizer

        self.tk = AutoTokenizer.from_pretrained(path, truncation_side="left",
                                                local_files_only=True)
        self.llm_name = llm_name
        if llm_name == "llama3":
            self.tk.eos_token_id = 128009   # <|eot_id|>
            self.tk.pad_token_id = 128001   # <|end_of_text|>
        elif llm_name == "phi3.5":
            self.tk.pad_token = "<|end|>"   # 32007

    def add_specials(self, strings: Sequence[str]) -> None:
        self.tk.add_tokens(list(strings), special_tokens=True)

    @property
    def vocab_size(self) -> int:
        return len(self.tk)

    @property
    def bos_token_id(self):
        return self.tk.bos_token_id

    @property
    def eos_token_id(self):
        return self.tk.eos_token_id

    @property
    def pad_token_id(self):
        return self.tk.pad_token_id

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self.tk(text, add_special_tokens=add_special_tokens).input_ids

    def __call__(self, text: str):
        return self.tk(text)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.tk.decode(ids, skip_special_tokens=skip_special_tokens)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return self.tk.batch_decode(batch, skip_special_tokens=skip_special_tokens)


def load_tokenizer(llm_name: str, path: Optional[str] = None,
                   num_temporal_tokens: int = 300, expand_vocab: bool = True):
    """HF tokenizer when files are available, byte fallback otherwise."""
    if path and os.path.exists(path):
        tok = HFTokenizer(path, llm_name)
        if expand_vocab:
            tok.add_specials(temporal_token_strings(num_temporal_tokens))
        return tok
    return build_test_tokenizer(llm_name, num_temporal_tokens)


# ---------------------------------------------------------------------------
# Image-token splice + label masking (pure functions over python lists)
# ---------------------------------------------------------------------------


def tokenize_with_image(prompt: str, tokenizer,
                        image_token_index: int = IMAGE_TOKEN_INDEX) -> List[int]:
    """Tokenize text containing one-or-more <image> placeholders; each becomes
    image_token_index (-200). Parity with reference llava_next_video.py:409-426:
    a leading bos in the first chunk is kept once, and chunk-leading bos copies
    are stripped from subsequent chunks via the offset trick."""
    chunks = [tokenizer(c).input_ids for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    input_ids: List[int] = []
    offset = 0
    if chunks and len(chunks[0]) > 0 and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    joined: List[List[int]] = []
    for i, c in enumerate(chunks):
        joined.append(c)
        if i != len(chunks) - 1:
            joined.append(sep)
    for x in joined:
        input_ids.extend(x[offset:])
    return input_ids


def make_labels(input_ids: Sequence[int], prompt: str, tokenizer,
                template: ChatTemplate) -> List[int]:
    """Mask instruction spans with IGNORE_INDEX, leaving only assistant responses
    (+ their eos) as targets. Exact parity with _make_masks_{llama3,vicuna,phi3}
    (reference llava_next_video.py:346-407) including the i>=1 off-by-one
    adjustments that account for sentencepiece joining behavior."""
    labels = list(input_ids)
    sep, eos_token = template.separator
    rounds = prompt.split(eos_token)
    family = template.name

    cur_len = 1  # bos
    bos_len = 1
    eos_len = 1
    labels[:cur_len] = [IGNORE_INDEX] * cur_len
    for i, rou in enumerate(rounds):
        if rou == "":
            break
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        instruction = parts[0] + sep
        round_len = len(tokenize_with_image(rou, tokenizer)) + eos_len - bos_len
        instruction_len = len(tokenize_with_image(instruction, tokenizer)) - bos_len
        if family == "vicuna":
            instruction_len -= 1
            if i >= 1:
                instruction_len -= 1
                round_len -= 1
        elif family == "phi3.5":
            instruction_len -= 1
            if i >= 1:
                instruction_len += 1
                round_len += 1
        labels[cur_len:cur_len + instruction_len] = [IGNORE_INDEX] * instruction_len
        cur_len += round_len
    labels[cur_len:] = [IGNORE_INDEX] * (len(labels) - cur_len)
    return labels


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------


def pad_batch_train(
    seq_ids: Sequence[Sequence[int]],
    seq_labels: Sequence[Sequence[int]],
    pad_token_id: int,
    eos_token_id: int,
    max_txt_len: int,
    pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Right-pad + truncate a batch for training (reference
    llava_next_video.py:428-452). On truncation the final label is forced to eos.
    pad_to additionally rounds the length up to a static bucket so jit shapes
    stay stable across batches (TPU-friendly; the reference pads to batch max)."""
    maxlen = max(len(s) for s in seq_ids)
    maxlen = min(maxlen, max_txt_len)
    if pad_to is not None:
        maxlen = min(-(-maxlen // pad_to) * pad_to, max_txt_len)
    B = len(seq_ids)
    input_ids = np.full((B, maxlen), pad_token_id, dtype=np.int32)
    labels = np.full((B, maxlen), IGNORE_INDEX, dtype=np.int32)
    mask = np.zeros((B, maxlen), dtype=np.int32)
    for b, (ids, labs) in enumerate(zip(seq_ids, seq_labels)):
        truncated = len(ids) > maxlen
        ids = list(ids)[:maxlen]
        labs = list(labs)[:maxlen]
        input_ids[b, :len(ids)] = ids
        labels[b, :len(labs)] = labs
        if truncated:
            labels[b, maxlen - 1] = eos_token_id
        mask[b, :len(ids)] = 1
    return input_ids, labels, mask


def pad_batch_generate(
    seq_ids: Sequence[Sequence[int]],
    pad_token_id: int,
    max_txt_len: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad a batch for generation via flip → right-pad → truncate → flip
    (reference llava_next_video.py:630-647). Truncation therefore keeps the
    *tail* of each prompt."""
    flipped = [list(reversed(ids)) for ids in seq_ids]
    maxlen = min(max(len(s) for s in flipped), max_txt_len)
    B = len(flipped)
    out = np.full((B, maxlen), pad_token_id, dtype=np.int32)
    mask = np.zeros((B, maxlen), dtype=np.int32)
    for b, ids in enumerate(flipped):
        ids = ids[:maxlen]
        out[b, :len(ids)] = ids
        mask[b, :len(ids)] = 1
    return out[:, ::-1].copy(), mask[:, ::-1].copy()
