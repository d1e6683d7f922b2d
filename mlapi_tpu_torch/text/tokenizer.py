"""Byte-level tokenizer: the ``gpt_lm`` serving pairing.

Counterpart of ``mlapi_tpu/text/tokenizer.py::ByteTokenizer``: UTF-8
bytes shifted past four reserved specials, so ids stay below 260 and a
round trip is lossless with no vocab file. The WordPiece and hashing
tokenizers of the classification path are not ported.
"""

from __future__ import annotations


class ByteTokenizer:
    """Byte-level ids (+4 reserved specials)."""

    pad_id, cls_id, sep_id, unk_id = 0, 1, 2, 3
    _RESERVED = 4
    vocab_size = 256 + _RESERVED

    def token_ids(self, text: str) -> list[int]:
        return [self._RESERVED + b for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        # Drops specials and ids past the byte range (a model's vocab
        # may exceed 260).
        return bytes(
            int(i) - self._RESERVED
            for i in ids
            if self._RESERVED <= int(i) < self._RESERVED + 256
        ).decode("utf-8", "replace")

    def fingerprint(self) -> dict:
        return {"kind": "bytes", "vocab_size": self.vocab_size}


def tokenizer_from_fingerprint(fp: dict):
    """Rebuild the tokenizer a checkpoint names, or refuse: serving must
    not pair a model with a tokenization it was not made for."""
    if fp.get("kind") == "bytes":
        return ByteTokenizer()
    raise ValueError(
        f"tokenizer {fp!r} is not ported (the port serves byte-level "
        "gpt_lm checkpoints)"
    )
