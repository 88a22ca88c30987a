"""Incremental detokenization for slot-level streaming (the port's copy of
grounded_video_llm_tpu/text/streaming.py; it works on the port's
text/tokenizer.py tokenizers).

The continuous-batching server fires a host-side `on_token` callback per
generated token (serve/continuous.Request.on_token). Token ids are not text:
byte-level BPE (and the byte fallback tokenizer) can split one UTF-8
character across several tokens, so per-token `decode` calls would emit
replacement characters mid-glyph. TokenTextStream re-decodes the growing id
list and releases only the stable prefix — text deltas arrive as soon as
they are unambiguous, matching the reference's end-of-generation `decode`
output exactly once flushed (tested vs whole-sequence decode).

Match: beyond-parity serving axis — the reference (inference.py:137-190)
only returns whole generations.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence


class TokenTextStream:
    """Feed token ids one at a time; receive text deltas.

    push(tid) -> str: the newly-stable text (may be "" while a multi-byte
    character is still incomplete). flush() -> str: whatever remains,
    including a trailing replacement char if the stream ended mid-character.
    `on_text` (optional) is also called with each non-empty delta."""

    def __init__(self, tokenizer, on_text: Optional[Callable[[str], None]]
                 = None, skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip = skip_special_tokens
        self._on = on_text
        self._ids: list = []
        self._released = ""

    @property
    def text(self) -> str:
        """Text released so far (excludes any held-back incomplete tail)."""
        return self._released

    def _decode(self) -> str:
        return self._tok.decode(self._ids, skip_special_tokens=self._skip)

    def push(self, token_id: int) -> str:
        self._ids.append(int(token_id))
        full = self._decode()
        delta = full[len(self._released):]
        # hold back while the tail may still be a partially-received UTF-8
        # character (byte-level tokenizers surface those as U+FFFD until the
        # remaining continuation bytes arrive)
        if not delta or delta.endswith("�"):
            return ""
        self._released = full
        if self._on is not None:
            self._on(delta)
        return delta

    def push_many(self, token_ids: Sequence[int]) -> str:
        return "".join(self.push(t) for t in token_ids)

    def flush(self) -> str:
        """Release any held-back tail (end of generation)."""
        full = self._decode()
        delta = full[len(self._released):]
        self._released = full
        if delta and self._on is not None:
            self._on(delta)
        return delta
