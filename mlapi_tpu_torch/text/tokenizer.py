"""Tokenizers: WordPiece and hashing (the BERT path) and byte-level (the
GPT path).

Counterpart of ``mlapi_tpu/text/tokenizer.py``, copied so that ids and
fingerprints are the same in both packages:

- :class:`WordPieceTokenizer` — BERT's scheme: basic tokenization
  (lowercase, accents stripped, punctuation split) then greedy
  longest-match-first wordpiece with ``##`` continuations, over a
  ``vocab.txt`` (one token per line).
- :class:`HashTokenizer` — the fallback with no vocab file: word →
  crc32 → id (stable across processes, unlike Python's ``hash``). Not
  compatible with pretrained BERT weights.
- :class:`ByteTokenizer` — UTF-8 bytes past four reserved specials; the
  ``gpt_lm`` serving pairing.
"""

from __future__ import annotations

import hashlib
import os
import unicodedata
import zlib
from pathlib import Path

import numpy as np

PAD, CLS, SEP, UNK = "[PAD]", "[CLS]", "[SEP]", "[UNK]"


def _basic_tokens(text: str) -> list[str]:
    """Lowercase, strip accents, split on whitespace and punctuation
    (each punctuation char its own token) — BERT's BasicTokenizer."""
    text = unicodedata.normalize("NFD", text.lower())
    out: list[str] = []
    word: list[str] = []
    for ch in text:
        cat = unicodedata.category(ch)
        if cat == "Mn":  # combining accent
            continue
        if ch.isspace():
            if word:
                out.append("".join(word))
                word = []
        elif cat.startswith("P") or cat in ("Sm", "Sc", "Sk", "So"):
            if word:
                out.append("".join(word))
                word = []
            out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


class _Base:
    pad_id: int
    cls_id: int
    sep_id: int

    def token_ids(self, text: str) -> list[int]:
        raise NotImplementedError

    def fingerprint(self) -> dict:
        """Identity of this tokenization scheme, recorded in checkpoints
        so that serving refuses a model paired with another one."""
        raise NotImplementedError

    def encode(self, text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
        """``[CLS] tokens [SEP]`` padded/truncated to ``max_len`` → (ids
        int32 [max_len], mask int32 [max_len])."""
        body = self.token_ids(text)[: max_len - 2]
        ids = [self.cls_id, *body, self.sep_id]
        n = len(ids)
        ids = ids + [self.pad_id] * (max_len - n)
        mask = [1] * n + [0] * (max_len - n)
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)

    def decode(self, ids) -> str:
        """Best-effort ids → text; schemes without a vocab render
        placeholders."""
        return " ".join(f"<{int(i)}>" for i in ids)


class WordPieceTokenizer(_Base):
    def __init__(self, vocab: list[str], max_chars_per_word: int = 100):
        self.vocab = list(vocab)
        self._index = {t: i for i, t in enumerate(self.vocab)}
        for required in (PAD, CLS, SEP, UNK):
            if required not in self._index:
                raise ValueError(f"vocab missing {required}")
        self.pad_id = self._index[PAD]
        if self.pad_id != 0:
            # Models mask attention with ``ids != 0``; a vocab that puts
            # [PAD] elsewhere would silently attend padding.
            raise ValueError(
                f"[PAD] must be vocab index 0, found at {self.pad_id}"
            )
        self.cls_id = self._index[CLS]
        self.sep_id = self._index[SEP]
        self.unk_id = self._index[UNK]
        self.max_chars_per_word = max_chars_per_word

    @classmethod
    def from_vocab_file(cls, path: str | Path) -> "WordPieceTokenizer":
        lines = Path(path).read_text(encoding="utf-8").splitlines()
        return cls([ln.rstrip("\n") for ln in lines if ln.strip()])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def fingerprint(self) -> dict:
        digest = hashlib.sha256(
            "\n".join(self.vocab).encode("utf-8")
        ).hexdigest()[:16]
        return {
            "kind": "wordpiece",
            "vocab_size": self.vocab_size,
            "vocab_sha256": digest,
        }

    def token_ids(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in _basic_tokens(text):
            if len(word) > self.max_chars_per_word:
                ids.append(self.unk_id)
                continue
            # Greedy longest-match-first wordpiece.
            start = 0
            pieces: list[int] = []
            while start < len(word):
                end = len(word)
                found = None
                while start < end:
                    sub = word[start:end]
                    if start > 0:
                        sub = "##" + sub
                    if sub in self._index:
                        found = self._index[sub]
                        break
                    end -= 1
                if found is None:
                    pieces = [self.unk_id]
                    break
                pieces.append(found)
                start = end
            ids.extend(pieces)
        return ids

    def decode(self, ids) -> str:
        """``##`` continuation pieces join their predecessor; specials
        are dropped."""
        words: list[str] = []
        specials = {self.pad_id, self.cls_id, self.sep_id}
        for i in ids:
            i = int(i)
            if i in specials or not 0 <= i < len(self.vocab):
                continue
            tok = self.vocab[i]
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            else:
                words.append(tok)
        return " ".join(words)


class HashTokenizer(_Base):
    """word → crc32 hash → id in [4, vocab_size)."""

    pad_id, cls_id, sep_id, unk_id = 0, 1, 2, 3
    _RESERVED = 4

    def __init__(self, vocab_size: int = 30522):
        if vocab_size <= self._RESERVED:
            raise ValueError("vocab_size too small")
        self.vocab_size = vocab_size

    def token_ids(self, text: str) -> list[int]:
        span = self.vocab_size - self._RESERVED
        return [
            self._RESERVED + (zlib.crc32(w.encode("utf-8")) % span)
            for w in _basic_tokens(text)
        ]

    def fingerprint(self) -> dict:
        return {"kind": "hash", "vocab_size": self.vocab_size}


class ByteTokenizer(_Base):
    """Byte-level ids (+4 reserved specials): ids stay below 260 and a
    round trip is lossless with no vocab file."""

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


def _find_vocab_file(data_dir: str | None = None) -> Path | None:
    for root in (data_dir, os.environ.get("MLAPI_TPU_DATA_DIR"), "data"):
        if root is None:
            continue
        p = Path(root) / "bert" / "vocab.txt"
        if p.exists():
            return p
    return None


def load_tokenizer(vocab_size: int = 30522, data_dir: str | None = None):
    """The WordPiece vocab if a ``vocab.txt`` is on disk, else the hash
    fallback. Searched: ``data_dir``, ``$MLAPI_TPU_DATA_DIR``, then
    ``data``, each with ``bert/vocab.txt`` under it."""
    p = _find_vocab_file(data_dir)
    if p is not None:
        return WordPieceTokenizer.from_vocab_file(p)
    return HashTokenizer(vocab_size)


def tokenizer_from_fingerprint(fp: dict, data_dir: str | None = None):
    """Rebuild exactly the tokenizer a checkpoint was trained with, or
    refuse: serving must not pair a model with a tokenization it was
    not made for."""
    kind = fp.get("kind")
    if kind == "hash":
        return HashTokenizer(fp["vocab_size"])
    if kind == "bytes":
        return ByteTokenizer()
    if kind == "wordpiece":
        p = _find_vocab_file(data_dir)
        if p is None:
            raise FileNotFoundError(
                "checkpoint was trained with a WordPiece vocab "
                f"(sha256 {fp.get('vocab_sha256')}); place the same "
                "vocab.txt at $MLAPI_TPU_DATA_DIR/bert/ or data/bert/"
            )
        tok = WordPieceTokenizer.from_vocab_file(p)
        got = tok.fingerprint()
        if got.get("vocab_sha256") != fp.get("vocab_sha256"):
            raise ValueError(
                f"vocab.txt at {p} (sha256 {got.get('vocab_sha256')}) does "
                f"not match the checkpoint's training vocab "
                f"(sha256 {fp.get('vocab_sha256')})"
            )
        return tok
    raise ValueError(f"unknown tokenizer fingerprint {fp!r}")
