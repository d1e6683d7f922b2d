"""Dataset loaders for training (counterpart of ``mlapi_tpu/datasets``).

Loaders return a :class:`SupervisedSplits` of host-side numpy arrays
plus the string-label vocab, and never touch the network. Every loader
of the JAX package is ported: ``iris`` and ``digits`` read copies of
scikit-learn's bundled files (``data/``), ``mnist``, ``fashion_mnist``,
``criteo`` and ``sst2`` fall back to the JAX package's seeded synthetic
stand-ins when their files are absent, and ``docs_text`` and
``docs_clf`` read the repository's documentation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mlapi_tpu_torch.utils.registry import Registry
from mlapi_tpu_torch.utils.vocab import LabelVocab


@dataclass(frozen=True)
class SupervisedSplits:
    """Train/test split of a supervised dataset, labels encoded.
    ``source`` records provenance (``"tsv"`` for real files,
    ``"synthetic"`` for the offline stand-in); ``extras`` carries what
    must travel into checkpoints (the tokenizer fingerprint, max_len)."""

    x_train: np.ndarray
    y_train: np.ndarray  # int32 class ids
    x_test: np.ndarray
    y_test: np.ndarray  # int32 class ids
    vocab: LabelVocab
    feature_names: tuple[str, ...] = ()
    source: str = "real"
    extras: dict = field(default_factory=dict)

    @property
    def num_features(self) -> int:
        return int(np.prod(self.x_train.shape[1:]))

    @property
    def num_classes(self) -> int:
        return self.vocab.size


_LOADERS: Registry = Registry("dataset")
register_dataset = _LOADERS.register


def get_dataset(name: str, **kwargs) -> SupervisedSplits:
    """Load a dataset by registry name (``iris``, ``sst2``, …)."""
    return _LOADERS.get(name)(**kwargs)


def dataset_registered(name: str) -> bool:
    return name in _LOADERS.names()


from mlapi_tpu_torch.datasets.criteo import load_criteo  # noqa: E402,F401
from mlapi_tpu_torch.datasets.digits import load_digits  # noqa: E402,F401
from mlapi_tpu_torch.datasets.docs_clf import (  # noqa: E402,F401
    load_docs_clf,
)
from mlapi_tpu_torch.datasets.iris import load_iris  # noqa: E402,F401
from mlapi_tpu_torch.datasets.mnist import (  # noqa: E402,F401
    load_fashion_mnist,
    load_mnist,
)
from mlapi_tpu_torch.datasets.sst2 import load_sst2  # noqa: E402,F401
from mlapi_tpu_torch.datasets.textlm import (  # noqa: E402,F401
    load_docs_text,
)
