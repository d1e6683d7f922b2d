"""SST-2 sentiment (counterpart of ``mlapi_tpu/datasets/sst2.py``).

Reads the GLUE TSV files (``sentence<TAB>label`` with a header) from
``$MLAPI_TPU_DATA_DIR/sst2/`` or ``data/sst2/`` when present; otherwise
a deterministic synthetic corpus: neutral filler words with planted
polarity words, which a BERT can only classify by learning token
embeddings. The same seed gives the same arrays as the JAX package, bit
for bit (the same numpy draws, the same tokenizers).

Rows are tokenized to fixed-length int32 id vectors; the model
recomputes the attention mask (``ids != pad``).
"""

from __future__ import annotations

import csv
import os
from pathlib import Path

import numpy as np

from mlapi_tpu_torch.datasets import SupervisedSplits, register_dataset
from mlapi_tpu_torch.utils.vocab import LabelVocab

LABELS = ("negative", "positive")

_POSITIVE = (
    "wonderful", "delightful", "charming", "moving", "brilliant",
    "captivating", "superb", "heartfelt", "masterful", "joyous",
)
_NEGATIVE = (
    "dreadful", "tedious", "clumsy", "hollow", "grating",
    "lifeless", "shoddy", "dismal", "incoherent", "stale",
)
_FILLER = (
    "the", "movie", "film", "story", "plot", "acting", "scene",
    "director", "script", "ending", "a", "with", "and", "of", "was",
    "that", "this", "its", "on", "in",
)


def _synthetic_corpus(n: int, rng) -> tuple[list[str], np.ndarray]:
    texts, labels = [], np.empty(n, np.int32)
    for i in range(n):
        label = int(rng.integers(0, 2))
        words = list(rng.choice(_FILLER, size=int(rng.integers(6, 14))))
        pool = _POSITIVE if label else _NEGATIVE
        for _ in range(int(rng.integers(1, 3))):
            words.insert(int(rng.integers(0, len(words))),
                         str(rng.choice(pool)))
        texts.append(" ".join(words))
        labels[i] = label
    return texts, labels


def _read_tsv(path: Path) -> tuple[list[str], np.ndarray]:
    texts, labels = [], []
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t", quoting=csv.QUOTE_NONE)
        header = next(reader)
        s_col = header.index("sentence")
        l_col = header.index("label")
        for row in reader:
            texts.append(row[s_col])
            labels.append(int(row[l_col]))
    return texts, np.asarray(labels, np.int32)


@register_dataset("sst2")
def load_sst2(
    *,
    max_len: int = 128,
    tokenizer=None,
    vocab_size: int = 30522,
    n_train: int = 8192,
    n_test: int = 1024,
    seed: int = 11,
) -> SupervisedSplits:
    from mlapi_tpu_torch.text import load_tokenizer

    tokenizer = tokenizer or load_tokenizer(vocab_size)

    data_dir = None
    for root in (os.environ.get("MLAPI_TPU_DATA_DIR"), "data"):
        if root and (Path(root) / "sst2" / "train.tsv").exists():
            data_dir = Path(root) / "sst2"
            break

    if data_dir is not None:
        train_texts, y_train = _read_tsv(data_dir / "train.tsv")
        test_texts, y_test = _read_tsv(data_dir / "dev.tsv")
        source = "tsv"
    else:
        train_texts, y_train = _synthetic_corpus(
            n_train, np.random.default_rng((seed, 1))
        )
        test_texts, y_test = _synthetic_corpus(
            n_test, np.random.default_rng((seed, 2))
        )
        source = "synthetic"

    def encode_all(texts):
        return np.stack([tokenizer.encode(t, max_len)[0] for t in texts])

    return SupervisedSplits(
        x_train=encode_all(train_texts),
        y_train=y_train,
        x_test=encode_all(test_texts),
        y_test=y_test,
        vocab=LabelVocab(labels=LABELS),
        source=source,
        extras={"tokenizer": tokenizer.fingerprint(), "max_len": max_len},
    )
