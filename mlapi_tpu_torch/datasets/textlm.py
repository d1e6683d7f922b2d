"""Language-modelling corpus from the repository's own documentation
(counterpart of ``mlapi_tpu/datasets/textlm.py``).

``docs_text`` byte-tokenizes four prose files (``_corpus.py``) into
fixed-length windows for next-token training: it makes the decoder
families (``gpt_lm``, ``llama_lm``) trainable through ``fit`` and the
train CLI, and their checkpoints then serve ``/generate`` (the
checkpoint carries the tokenizer fingerprint). The bytes are real text
on disk, but the corpus is small: its perplexity shows the pipeline
works, not language quality. The arrays equal the JAX package's.
"""

from __future__ import annotations

import numpy as np

from mlapi_tpu_torch.datasets import SupervisedSplits, register_dataset
from mlapi_tpu_torch.datasets._corpus import (
    DOC_SOURCES,
    corpus_provenance,
    live_markdown_docs,
    resolve_doc,
    resolve_root,
)
from mlapi_tpu_torch.utils.vocab import LabelVocab


@register_dataset("docs_text")
def load_docs_text(
    *,
    seq_len: int = 128,
    stride: int | None = None,
    test_fraction: float = 0.1,
    root: str | None = None,
) -> SupervisedSplits:
    """Byte-id windows over the docs: ``x == y`` (``[N, L]`` int32; the
    LM loss shifts the targets). Windows are cut every ``stride`` bytes
    (default ``seq_len``: no overlap); the test split is the TAIL of the
    stream, and with ``stride < seq_len`` train windows that reach into
    it are dropped, so the two never overlap.

    ``root``: ``None`` reads the frozen snapshot (the four
    ``DOC_SOURCES`` files), ``"live"`` the repository's current docs
    plus every other ``docs/*.md``, anything else a user directory."""
    from mlapi_tpu_torch.text import ByteTokenizer

    tok = ByteTokenizer()
    stride = stride or seq_len
    base = resolve_root(root)
    paths = [
        p for rel in DOC_SOURCES
        if (p := resolve_doc(base, rel)) is not None
    ]
    if root == "live":
        paths += live_markdown_docs(base)
    texts = [p.read_text(errors="replace") for p in paths]
    if not texts:
        raise FileNotFoundError(f"no corpus files under {base}")
    ids = np.asarray(tok.token_ids("\n\n".join(texts)), np.int32)

    windows = [
        ids[s : s + seq_len]
        for s in range(0, len(ids) - seq_len + 1, stride)
    ]
    x = np.stack(windows)
    n_test = max(1, int(len(x) * test_fraction))
    split = len(x) - n_test
    if stride < seq_len:
        limit = split * stride
        keep = [i for i in range(split) if i * stride + seq_len <= limit]
        x_train = x[keep]
    else:
        x_train = x[:split]
    x_test = x[split:]
    return SupervisedSplits(
        x_train=x_train,
        y_train=x_train,  # LM: targets are the inputs, shifted in the loss
        x_test=x_test,
        y_test=x_test,
        vocab=LabelVocab(("<lm>",)),  # no class labels
        source="real",
        extras={
            "tokenizer": tok.fingerprint(),
            "task": "lm",
            "corpus": corpus_provenance(base),
        },
    )
