"""Decode-only Tekken tokenizer.

Parses `tekken.json` (the only runtime-parsed config in the reference —
SURVEY.md §5.6) and decodes token IDs to UTF-8 strings.  ID layout
(voxtral_tokenizer.c:186-352, python_simple_implementation.py:670-719):

  - IDs [0, n_special) are special/control tokens -> decode to ""
  - ID >= n_special indexes vocab[id - n_special], whose `token_bytes`
    field is base64-encoded raw bytes.

Single-token decode may produce invalid UTF-8 (tokens can split multi-byte
characters); like the C engine we decode per-token with errors="replace" for
classification, but `decode_seq` concatenates raw bytes before decoding so
multi-token characters reassemble correctly.
"""

from __future__ import annotations

import base64
import json
from typing import Iterable

from .config import TOKEN_EOS, TOKEN_TEXT_MIN


class TekkenTokenizer:
    def __init__(self, token_bytes: list[bytes], n_special: int):
        self._tokens = token_bytes          # vocab entries (no specials)
        self.n_special = n_special
        self._piece_cache: dict[int, str] = {}

    @classmethod
    def load(cls, path: str) -> "TekkenTokenizer":
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        config = data.get("config", {})
        n_special = int(config.get("default_num_special_tokens", 1000))
        vocab = data["vocab"]
        toks = [base64.b64decode(entry["token_bytes"]) for entry in vocab]
        return cls(toks, n_special)

    @property
    def vocab_size(self) -> int:
        return self.n_special + len(self._tokens)

    def token_bytes(self, token_id: int) -> bytes:
        if token_id < self.n_special:
            return b""
        vid = token_id - self.n_special
        if vid >= len(self._tokens):
            return b""
        return self._tokens[vid]

    def decode(self, token_id: int) -> str:
        """Decode one token (lossy on split UTF-8, like vox_tokenizer_decode)."""
        piece = self._piece_cache.get(token_id)
        if piece is None:
            piece = self.token_bytes(token_id).decode("utf-8", errors="replace")
            self._piece_cache[token_id] = piece
        return piece

    def decode_seq(self, token_ids: Iterable[int]) -> str:
        """Decode a sequence, reassembling multi-token UTF-8 characters."""
        out = bytearray()
        for tid in token_ids:
            out += self.token_bytes(int(tid))
        return out.decode("utf-8", errors="replace")

    # -- token classification (voxtral.c:480-495) ---------------------------
    TOK_TEXT = 0
    TOK_CONTROL = 1
    TOK_INVALID = 2
    TOK_EOS = 3

    def classify(self, token_id: int) -> int:
        if token_id == TOKEN_EOS:
            return self.TOK_EOS
        if token_id < TOKEN_TEXT_MIN:
            return self.TOK_CONTROL
        # Token 1000 is the raw byte 0x00; as text it is "empty" — treat
        # empty/NUL-leading decodes as non-text (voxtral.c:487-494).
        piece = self.decode(token_id)
        if not piece or piece[0] == "\x00":
            return self.TOK_INVALID
        return self.TOK_TEXT
