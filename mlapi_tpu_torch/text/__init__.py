"""Tokenizers for the classification (WordPiece, hash) and generative
(byte-level) paths."""

from mlapi_tpu_torch.text.tokenizer import (
    ByteTokenizer,
    HashTokenizer,
    WordPieceTokenizer,
    load_tokenizer,
    tokenizer_from_fingerprint,
)

__all__ = [
    "ByteTokenizer",
    "HashTokenizer",
    "WordPieceTokenizer",
    "load_tokenizer",
    "tokenizer_from_fingerprint",
]
