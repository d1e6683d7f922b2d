"""MNIST / Fashion-MNIST (counterpart of ``mlapi_tpu/datasets/mnist.py``).

Reads the standard IDX files (``train-images-idx3-ubyte`` etc., the
format both datasets are distributed in) from
``$MLAPI_TPU_DATA_DIR/<name>/`` or ``./data/<name>/``, optionally
gzipped. When the files are absent the loader falls back to a
**deterministic synthetic stand-in** — class-conditional templates
plus noise at the same shapes/dtypes — clearly marked via ``source="synthetic"``. The synthetic sets
exercise the exact same training/serving code paths (784 features, 10
classes); published accuracy claims only apply to runs with the real
files present.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

from mlapi_tpu_torch.datasets import SupervisedSplits, register_dataset
from mlapi_tpu_torch.utils.vocab import LabelVocab

MNIST_CLASSES = tuple(str(d) for d in range(10))
FASHION_CLASSES = (
    "T-shirt/top", "Trouser", "Pullover", "Dress", "Coat",
    "Sandal", "Shirt", "Sneaker", "Bag", "Ankle boot",
)

_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def _open_maybe_gz(path: Path):
    gz = path.with_name(path.name + ".gz")
    if path.exists():
        return open(path, "rb")
    if gz.exists():
        return gzip.open(gz, "rb")
    raise FileNotFoundError(path)


def read_idx(path: Path) -> np.ndarray:
    """Parse one IDX file (images uint8 [n,r,c]; labels uint8 [n])."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _data_dir(name: str) -> Path | None:
    for root in (os.environ.get("MLAPI_TPU_DATA_DIR"), "data"):
        if root is None:
            continue
        d = Path(root) / name
        if d.is_dir():
            return d
    return None


def _load_idx_splits(d: Path, classes: tuple[str, ...]) -> SupervisedSplits:
    x_train = read_idx(d / _FILES["train_images"]).reshape(-1, 784)
    y_train = read_idx(d / _FILES["train_labels"])
    x_test = read_idx(d / _FILES["test_images"]).reshape(-1, 784)
    y_test = read_idx(d / _FILES["test_labels"])
    vocab = LabelVocab(labels=classes)
    return SupervisedSplits(
        x_train=(x_train.astype(np.float32) / 255.0),
        y_train=y_train.astype(np.int32),
        x_test=(x_test.astype(np.float32) / 255.0),
        y_test=y_test.astype(np.int32),
        vocab=vocab,
        source="idx",
    )


def _synthetic_splits(
    classes: tuple[str, ...],
    *,
    seed: int,
    n_train: int,
    n_test: int,
    noise: float = 0.35,
) -> SupervisedSplits:
    """Class-template + Gaussian-noise images, fixed by seed.

    Learnable but not trivially so (templates overlap through noise),
    so optimizer/parallelism regressions still show up as accuracy
    regressions in tests.
    """
    k = len(classes)
    rng = np.random.default_rng(seed)
    templates = rng.uniform(0.0, 1.0, size=(k, 784)).astype(np.float32)

    def make(n: int, rng):
        y = rng.integers(0, k, size=n).astype(np.int32)
        x = templates[y] + rng.normal(0.0, noise, size=(n, 784)).astype(np.float32)
        return np.clip(x, 0.0, 1.0), y

    x_train, y_train = make(n_train, np.random.default_rng((seed, 1)))
    x_test, y_test = make(n_test, np.random.default_rng((seed, 2)))
    return SupervisedSplits(
        x_train=x_train,
        y_train=y_train,
        x_test=x_test,
        y_test=y_test,
        vocab=LabelVocab(labels=classes),
        source="synthetic",
    )


@register_dataset("mnist")
def load_mnist(
    *, seed: int = 0, synthetic_train: int = 8192, synthetic_test: int = 1024
) -> SupervisedSplits:
    d = _data_dir("mnist")
    if d is not None:
        return _load_idx_splits(d, MNIST_CLASSES)
    return _synthetic_splits(
        MNIST_CLASSES, seed=seed, n_train=synthetic_train, n_test=synthetic_test
    )


@register_dataset("fashion_mnist")
def load_fashion_mnist(
    *, seed: int = 1, synthetic_train: int = 8192, synthetic_test: int = 1024
) -> SupervisedSplits:
    d = _data_dir("fashion_mnist")
    if d is not None:
        return _load_idx_splits(d, FASHION_CLASSES)
    return _synthetic_splits(
        FASHION_CLASSES, seed=seed, n_train=synthetic_train, n_test=synthetic_test
    )
