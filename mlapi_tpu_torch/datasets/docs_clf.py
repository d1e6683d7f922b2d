"""Text classification over the repository's documentation
(counterpart of ``mlapi_tpu/datasets/docs_clf.py``).

Fixed-length byte-id windows over the four corpus files
(``_corpus.py``), labelled by the file each window came from: real
prose, the task shape of SST-2 (short text → class id), and the data
the ``docsclf-bert`` preset trains on. It reads the frozen snapshot by
default, the same bytes ``docs_text`` reads, and gives the JAX
package's arrays.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mlapi_tpu_torch.datasets import SupervisedSplits, register_dataset
from mlapi_tpu_torch.utils.vocab import LabelVocab

from mlapi_tpu_torch.datasets._corpus import (
    DOC_SOURCES as _DOC_SOURCES,
    corpus_provenance as _corpus_provenance,
    resolve_doc as _resolve_doc,
    resolve_root as _resolve_root,
)


@register_dataset("docs_clf")
def load_docs_clf(
    *,
    seq_len: int = 64,
    stride: int | None = None,
    test_fraction: float = 0.2,
    root: str | None = None,
) -> SupervisedSplits:
    """Byte-id windows over the repo docs, labeled by source file.

    With non-overlapping windows (``stride >= seq_len``, the default)
    the test split is a per-class STRATIFIED RANDOM sample — no token
    appears in both splits, and the split is free of the head-vs-tail
    register shift a positional split would add on top of the task.
    With overlapping windows (``stride < seq_len``) adjacent windows
    share bytes, so the split falls back to each file's TAIL to keep
    train/test disjoint.

    ``root`` selects the corpus: ``None`` (default) reads the FROZEN
    commit-pinned snapshot shipped in ``docs_corpus/`` so measured
    accuracies reproduce; ``"live"`` reads the repo's current docs
    (the old behavior — drifts every round); any other value is a
    directory of the four files (flat or repo-layout).
    """
    from mlapi_tpu_torch.text import ByteTokenizer

    tok = ByteTokenizer()
    stride = stride or seq_len
    base = _resolve_root(root)

    per_class: list[tuple[str, np.ndarray]] = []
    for rel in _DOC_SOURCES:
        p = _resolve_doc(base, rel)
        if p is None:
            continue
        ids = np.asarray(
            tok.token_ids(p.read_text(errors="replace")), np.int32
        )
        if len(ids) < 2 * seq_len:
            continue
        windows = np.stack([
            ids[s: s + seq_len]
            for s in range(0, len(ids) - seq_len + 1, stride)
        ])
        per_class.append((Path(rel).name, windows))
    if len(per_class) < 2:
        raise FileNotFoundError(
            f"docs_clf needs >= 2 documentation files under {base}; "
            f"found {[n for n, _ in per_class]}"
        )

    rng_split = np.random.default_rng(11)
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for label, (name, windows) in enumerate(per_class):
        n_test = max(1, int(len(windows) * test_fraction))
        if stride >= seq_len:
            order = rng_split.permutation(len(windows))
            test_idx, train_idx = order[:n_test], order[n_test:]
            if len(train_idx) == 0:
                raise ValueError(
                    f"docs_clf: class {name!r} yields only "
                    f"{len(windows)} window(s) at seq_len={seq_len} — "
                    f"the test split takes them all and training "
                    f"would silently see zero examples of it; shrink "
                    f"seq_len or test_fraction"
                )
        else:
            # Tail split with overlapping windows: drop train windows
            # whose span reaches into the first test window's bytes,
            # or the boundary pair would share stride..seq_len bytes.
            split = len(windows) - n_test
            test_start_byte = split * stride
            test_idx = np.arange(split, len(windows))
            train_idx = np.asarray(
                [i for i in range(split)
                 if i * stride + seq_len <= test_start_byte],
                np.int64,
            )
            if len(train_idx) == 0:
                raise ValueError(
                    f"docs_clf: class {name!r} has no train windows "
                    f"left after the overlap filter (stride={stride} "
                    f"<< seq_len={seq_len} for a short document) — "
                    f"training would silently see zero examples of "
                    f"it; raise stride or shrink test_fraction"
                )
        xs_tr.append(windows[train_idx])
        ys_tr.append(np.full(len(train_idx), label, np.int32))
        xs_te.append(windows[test_idx])
        ys_te.append(np.full(len(test_idx), label, np.int32))

    # Interleave classes deterministically so full-batch or sequential
    # minibatch training sees every class early.
    rng = np.random.default_rng(7)
    x_train = np.concatenate(xs_tr)
    y_train = np.concatenate(ys_tr)
    order = rng.permutation(len(x_train))
    return SupervisedSplits(
        x_train=x_train[order],
        y_train=y_train[order],
        x_test=np.concatenate(xs_te),
        y_test=np.concatenate(ys_te),
        vocab=LabelVocab(tuple(n for n, _ in per_class)),
        source="real",
        extras={
            "tokenizer": tok.fingerprint(),
            "max_len": seq_len,
            "corpus": _corpus_provenance(base),
        },
    )
