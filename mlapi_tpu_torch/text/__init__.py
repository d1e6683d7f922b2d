"""Tokenizers for the generative serving path."""

from mlapi_tpu_torch.text.tokenizer import (
    ByteTokenizer,
    tokenizer_from_fingerprint,
)

__all__ = ["ByteTokenizer", "tokenizer_from_fingerprint"]
