"""Iris (counterpart of ``mlapi_tpu/datasets/iris.py``).

The 150 UCI rows from the copy of scikit-learn's bundled ``iris.csv``
in ``data/`` (see its README), labels in the UCI string form
(``Iris-setosa`` …) that ``/predict`` answers with, split 80/20 as
``train_test_split(test_size=0.2, random_state=1, shuffle=True)`` does
(``_split.py``): the JAX package's rows, in its order.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from mlapi_tpu_torch.datasets import SupervisedSplits, register_dataset
from mlapi_tpu_torch.datasets._split import split_indices
from mlapi_tpu_torch.utils.vocab import LabelVocab

DATA = Path(__file__).resolve().parent / "data" / "iris.csv"
FEATURE_NAMES = (
    "sepal_length",
    "sepal_width",
    "petal_length",
    "petal_width",
)


@register_dataset("iris")
def load_iris(*, test_fraction: float = 0.20,
              seed: int = 1) -> SupervisedSplits:
    """150 rows → 120 train / 30 test."""
    with open(DATA, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        names = header[2:]
        rows = [r for r in reader if r]
    x = np.asarray([r[:4] for r in rows], np.float64).astype(np.float32)
    labels = np.asarray([f"Iris-{names[int(r[4])]}" for r in rows])
    vocab = LabelVocab.from_labels(labels)
    y = vocab.encode(labels)
    train, test = split_indices(len(x), test_fraction, seed)
    return SupervisedSplits(
        x_train=x[train], y_train=y[train].astype(np.int32),
        x_test=x[test], y_test=y[test].astype(np.int32),
        vocab=vocab, feature_names=FEATURE_NAMES,
    )
