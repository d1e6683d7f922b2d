"""String-label vocabulary (counterpart of ``mlapi_tpu/utils/vocab.py``).

Models work on integer class ids; the string↔id mapping travels with
every checkpoint (``MANIFEST.json``'s ``vocab``), so serving answers with
the label a model was trained on.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class LabelVocab:
    """Immutable ordered mapping between string class labels and int ids."""

    labels: tuple[str, ...]
    _index: dict[str, int] = field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        if len(set(self.labels)) != len(self.labels):
            raise ValueError(f"duplicate labels in vocab: {self.labels}")
        object.__setattr__(
            self, "_index", {label: i for i, label in enumerate(self.labels)}
        )

    @classmethod
    def from_labels(cls, raw_labels) -> "LabelVocab":
        """A vocab from (possibly repeated) labels, sorted, so the same
        dataset yields the same vocab whatever its row order."""
        return cls(labels=tuple(sorted({str(x) for x in raw_labels})))

    @property
    def size(self) -> int:
        return len(self.labels)

    def encode(self, raw_labels) -> np.ndarray:
        """String labels → int32 ids."""
        try:
            return np.asarray([self._index[str(x)] for x in raw_labels],
                              dtype=np.int32)
        except KeyError as e:
            raise ValueError(
                f"label {e.args[0]!r} not in vocab {self.labels}"
            ) from None

    def decode(self, ids) -> list[str]:
        """Int ids → string labels."""
        return [self.labels[int(i)] for i in np.asarray(ids).reshape(-1)]

    def to_json(self) -> dict:
        return {"labels": list(self.labels)}

    @classmethod
    def from_json(cls, obj: dict) -> "LabelVocab":
        return cls(labels=tuple(obj["labels"]))
