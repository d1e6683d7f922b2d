"""scikit-learn's ``train_test_split`` in numpy, for the arguments the
JAX package's loaders pass (``test_size`` a fraction, an integer
``random_state``, ``shuffle=True``, with or without ``stratify``).

sklearn is not installed where the port runs, and the Iris and digits
splits must be the JAX package's row for row. The draws follow
sklearn 1.9's ``ShuffleSplit`` / ``StratifiedShuffleSplit`` on one
``np.random.RandomState(seed)``: the test count is
``ceil(test_size * n)``; a plain split takes the first ``n_test``
entries of one permutation as the test rows and the next ``n_train``
as the train rows; a stratified split gives each class its
approximate-mode share of both sides, ties broken by the same
generator, then shuffles each side.
"""

from __future__ import annotations

import math

import numpy as np


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``utils.extmath._approximate_mode``: the per-class draw
    counts, remainders handed out largest first, ties broken by
    ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def split_indices(n: int, test_fraction: float, seed: int,
                  stratify: np.ndarray | None = None):
    """``(train_idx, test_idx)`` as ``train_test_split`` draws them."""
    n_test = math.ceil(test_fraction * n)
    n_train = n - n_test
    rng = np.random.RandomState(seed)
    if stratify is None:
        perm = rng.permutation(n)
        return perm[n_test:n_test + n_train], perm[:n_test]
    classes, y_idx, counts = np.unique(stratify, return_inverse=True,
                                       return_counts=True)
    class_indices = np.split(np.argsort(y_idx, kind="stable"),
                             np.cumsum(counts)[:-1])
    n_i = _approximate_mode(counts, n_train, rng)
    t_i = _approximate_mode(counts - n_i, n_test, rng)
    train: list = []
    test: list = []
    for i in range(len(classes)):
        perm = rng.permutation(counts[i])
        idx = class_indices[i].take(perm, mode="clip")
        train.extend(idx[: n_i[i]])
        test.extend(idx[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)
