"""Handwritten digits (counterpart of ``mlapi_tpu/datasets/digits.py``).

1,797 real 8x8 scans (UCI optdigits) from the copy of scikit-learn's
bundled ``digits.csv.gz`` in ``data/``, scaled to [0, 1] by the pixel
maximum 16, labels ``"0"`` … ``"9"``, split 80/20 stratified by label
as ``train_test_split(..., random_state=1, shuffle=True, stratify=y)``
does (``_split.py``): the JAX package's rows, in its order.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from mlapi_tpu_torch.datasets import SupervisedSplits, register_dataset
from mlapi_tpu_torch.datasets._split import split_indices
from mlapi_tpu_torch.utils.vocab import LabelVocab

DATA = Path(__file__).resolve().parent / "data" / "digits.csv.gz"


@register_dataset("digits")
def load_digits(*, test_fraction: float = 0.20,
                seed: int = 1) -> SupervisedSplits:
    """1,797 scans → 64 features in [0, 1], 10 classes."""
    with gzip.open(DATA, "rt") as f:
        raw = np.loadtxt(f, delimiter=",", dtype=np.float64)
    x = (raw[:, :-1] / 16.0).astype(np.float32)
    labels = np.asarray([str(int(t)) for t in raw[:, -1]])
    vocab = LabelVocab.from_labels(labels)
    y = vocab.encode(labels)
    train, test = split_indices(len(x), test_fraction, seed, stratify=y)
    return SupervisedSplits(
        x_train=x[train], y_train=y[train].astype(np.int32),
        x_test=x[test], y_test=y[test].astype(np.int32),
        vocab=vocab,
        feature_names=tuple(f"px_{i}" for i in range(x.shape[1])),
        source="real",
    )
