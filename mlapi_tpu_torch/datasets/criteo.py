"""Criteo-style click-through data (counterpart of
``mlapi_tpu/datasets/criteo.py``; the same seeds give the same arrays).

Real Criteo-1TB is not in the repository, so
this is a deterministic synthetic generator with the same *shape* of
problem: 13 dense (integer-ish, heavy-tailed) features + 26
categorical features drawn from large hashed vocabularies, binary
click label. The planted structure gives every categorical id a
stable pseudo-random effect, so a model only beats chance by actually
learning per-id embeddings — which is exactly what the sharded
embedding path must get right.

Feature layout matches production Criteo naming: dense ``I1..I13``,
categorical ``C1..C26``. Rows are a single float32 vector
``[I1..I13, C1..C26]`` (categorical ids carried as floats, cast back
to ints inside the model) so the whole tabular train/serve stack
works unchanged.
"""

from __future__ import annotations

import numpy as np

from mlapi_tpu_torch.datasets import SupervisedSplits, register_dataset
from mlapi_tpu_torch.utils.vocab import LabelVocab

LABELS = ("no-click", "click")  # id 1 == click

_MIX1 = np.uint64(0x9E3779B97F4A7C15)
_MIX2 = np.uint64(0xBF58476D1CE4E5B9)


def _hash_effect(ids: np.ndarray, feature: int) -> np.ndarray:
    """Stable pseudo-random effect in [-0.5, 0.5) for each (feature, id)."""
    with np.errstate(over="ignore"):  # uint64 wraparound is the mixer
        h = (ids.astype(np.uint64) + np.uint64(feature + 1) * _MIX1) * _MIX2
    h ^= h >> np.uint64(31)
    return (h % np.uint64(10_000)).astype(np.float32) / 10_000.0 - 0.5


@register_dataset("criteo")
def load_criteo(
    *,
    num_dense: int = 13,
    num_categorical: int = 26,
    vocab_size: int = 100_000,
    n_train: int = 32768,
    n_test: int = 4096,
    seed: int = 7,
) -> SupervisedSplits:
    rng = np.random.default_rng(seed)
    w_dense = rng.normal(0.0, 0.6, size=num_dense).astype(np.float32)
    beta = rng.normal(0.0, 1.2, size=num_categorical).astype(np.float32)

    def make(n: int, rng):
        dense = rng.lognormal(0.0, 1.0, size=(n, num_dense)).astype(np.float32)
        dense = np.log1p(dense)  # the standard Criteo dense transform
        cat = rng.integers(0, vocab_size, size=(n, num_categorical))
        logit = dense @ w_dense
        for f in range(num_categorical):
            logit += beta[f] * _hash_effect(cat[:, f], f)
        logit += rng.normal(0.0, 0.25, size=n).astype(np.float32)
        y = (logit > np.median(logit)).astype(np.int32)  # balanced classes
        x = np.concatenate([dense, cat.astype(np.float32)], axis=1)
        return x, y

    x_train, y_train = make(n_train, np.random.default_rng((seed, 1)))
    x_test, y_test = make(n_test, np.random.default_rng((seed, 2)))
    vocab = LabelVocab(labels=LABELS)
    return SupervisedSplits(
        x_train=x_train,
        y_train=y_train,
        x_test=x_test,
        y_test=y_test,
        vocab=vocab,
        feature_names=tuple(
            [f"I{i+1}" for i in range(num_dense)]
            + [f"C{i+1}" for i in range(num_categorical)]
        ),
        source="synthetic",
    )

