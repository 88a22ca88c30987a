# The port's own copy of grounded_video_llm_tpu/text/codec.py, which imports no
# framework; tests/test_torch_shared_modules.py holds the two to each other.
"""Temporal-token codec: float seconds ↔ discrete <n> tokens, bit-for-bit with the
reference (SURVEY §2.2).

Encode (training):  <12.5> in an answer → <n>, n = min(int(N * t / duration), N)
                    (reference datasets/mix_sft.py:62-71).
Encode (referring): "12 seconds" in a user query → <int(t / duration * N)>
                    (reference inference.py:107).
Decode:             <x> → duration * x / N seconds, rendered " %.2f seconds"
                    (phi3.5, leading space) or "%.2f seconds" (llama3)
                    (reference inference.py:125-134).
Grounding marker:   a conversation whose answer contains <float> gets
                    <timestamp_grounding> prepended to the question
                    (reference datasets/mix_sft.py:73-84).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

from .templates import DEFAULT_IMAGE_TOKEN, GROUNDING_TOKEN

TIMESTAMP_PATTERN = re.compile(r"<-?\d+(\.\d+)?>")
TOKEN_PATTERN = re.compile(r"<(\d+)>")
SECONDS_PATTERN = re.compile(r"(\d+) seconds")


def quantize_time(t: float, duration: float, num_temporal_tokens: int = 300) -> int:
    """Map seconds → bin index, training-side rounding (int() truncation + clamp)."""
    return min(int(num_temporal_tokens * t / duration), num_temporal_tokens)


def convert_time_position(answer: str, duration: float,
                          num_temporal_tokens: int = 300) -> str:
    """Replace every <float-seconds> in an answer with its quantized <n> token."""

    def _replace(match: re.Match) -> str:
        t = float(match.group(0).strip("<>"))
        return f"<{quantize_time(t, duration, num_temporal_tokens)}>"

    return TIMESTAMP_PATTERN.sub(_replace, answer)


def encode_referring_query(query: str, duration: float,
                           num_temporal_tokens: int = 300) -> str:
    """Quantize "N seconds" mentions in a user query to <n> tokens
    (reference inference.py:107 — note int(float(t)/duration*N) truncation,
    no clamping)."""
    return SECONDS_PATTERN.sub(
        lambda m: f"<{int(float(m.group(1)) / duration * num_temporal_tokens)}>",
        query,
    )


def parse_time_interval(text: str, duration: float,
                        num_temporal_tokens: int = 300,
                        llm: str = "phi3.5") -> str:
    """Replace every <x> in generated text with seconds. phi3.5 renders with a
    leading space (its tokenizer absorbs the space before <x>); llama3 without."""

    def _replace(match: re.Match) -> str:
        x = int(match.group(1))
        m = duration * x / num_temporal_tokens
        if llm == "phi3.5":
            return f" {m:.2f} seconds"
        return f"{m:.2f} seconds"

    return TOKEN_PATTERN.sub(_replace, text)


def extract_intervals(text: str, duration: float,
                      num_temporal_tokens: int = 300) -> List[tuple]:
    """Extract (start, end) second pairs from generated <a> ... <b> spans — used
    by the grounding eval harness (Charades-STA / ActivityNet R1@IoU)."""
    xs = [int(m.group(1)) for m in TOKEN_PATTERN.finditer(text)]
    secs = [duration * x / num_temporal_tokens for x in xs]
    return [(secs[i], secs[i + 1]) for i in range(0, len(secs) - 1, 2)]


def has_timestamp(text: str) -> bool:
    return bool(TIMESTAMP_PATTERN.search(text))


def mark_grounding_conversations(convs: Sequence[Dict[str, str]]) -> List[Dict[str, str]]:
    """Prepend <timestamp_grounding> to each question whose answer contains a
    timestamp (reference datasets/mix_sft.py:73-84). Assumes alternating
    human/gpt turns starting with human."""
    out = [dict(c) for c in convs]
    for i in range(0, len(out) - 1, 2):
        if has_timestamp(out[i + 1]["value"]):
            q = out[i]["value"]
            if DEFAULT_IMAGE_TOKEN in q:
                out[i]["value"] = (DEFAULT_IMAGE_TOKEN + " " + GROUNDING_TOKEN + "\n"
                                   + q.replace(DEFAULT_IMAGE_TOKEN + "\n", ""))
            else:
                out[i]["value"] = GROUNDING_TOKEN + "\n" + q
    return out


def quantize_conversation(convs: Sequence[Dict[str, str]], duration: float,
                          num_temporal_tokens: int = 300) -> List[Dict[str, str]]:
    """Quantize <float> timestamps in all answers of a conversation."""
    out = []
    for c in convs:
        c = dict(c)
        if c["from"] == "gpt":
            c["value"] = convert_time_position(c["value"], duration,
                                               num_temporal_tokens)
        out.append(c)
    return out
