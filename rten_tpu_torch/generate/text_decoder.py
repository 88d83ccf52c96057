"""Streaming text decoding (the port of ``rten_tpu/generate/text_decoder.py``;
rten rten-generate/src/text_decoder.rs:13).

Decodes incrementally: emits only the new text suffix for each token,
holding back output while the byte stream ends mid-UTF-8-sequence (the
replacement char would otherwise flicker). Each ``push`` decodes the whole
sequence so far, as the reference does, so its cost grows with the length."""

from __future__ import annotations

from typing import Iterable, Iterator, List


class TextDecoder:
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.ids: List[int] = []
        self.emitted = ""

    def push(self, token_id: int) -> str:
        """Add a token; return newly-decodable text (possibly empty)."""
        self.ids.append(int(token_id))
        text = self.tokenizer.decode(self.ids)
        if text.endswith("�"):  # incomplete utf-8 tail; hold back
            return ""
        new = text[len(self.emitted):]
        self.emitted = text
        return new

    def wrap(self, token_iter: Iterable[int]) -> Iterator[str]:
        for tid in token_iter:
            chunk = self.push(tid)
            if chunk:
                yield chunk
