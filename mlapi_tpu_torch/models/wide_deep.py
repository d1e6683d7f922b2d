"""Wide&Deep classifier (counterpart of
``mlapi_tpu/models/wide_deep.py``).

- **Wide**: a linear map of the dense features plus, per categorical
  feature, a ``num_classes``-wide embedding row summed over features.
- **Deep**: ``embed_dim``-wide embeddings of every categorical feature,
  concatenated after the dense features into an MLP whose hidden layers
  run in ``compute_dtype`` (bf16) and whose output layer runs in f32.

The tables of all features are stacked, ``[F, V, K]`` and ``[F, V, D]``
with ``V`` the largest vocab, so the lookup is one advanced-indexing
gather. A row is a flat float32 ``[num_dense + F]`` vector, categorical
ids carried as floats: ``embedding_ids`` truncates them toward zero to
int32 and takes each feature's vocab remainder (the sign of the
divisor, as ``jnp.remainder``), so negative and out-of-vocab ids land
inside the table. Parameters keep the JAX key paths (``wide_dense``,
``wide_bias``, ``wide_tables``, ``deep_tables``,
``deep_{i}/{kernel,bias}``).

The forward is split at the gather (``split_embeddings``,
``gather_rows``, ``apply_from_rows``, ``merge_embeddings``) so the
sparse training step (``train/sparse_embed.py``) can take gradients
with respect to the gathered rows; ``optimizer_partitions`` labels the
tables for rowwise AdaGrad (``train/optimizers.py``). Not ported here:
``param_shardings`` (vocab-sharded tables wait for ROADMAP Queue A item
8).
"""

from __future__ import annotations

import torch
from torch import nn

from mlapi_tpu_torch.models import register_model
from mlapi_tpu_torch.models.gpt import _DTYPES, _Dense
from mlapi_tpu_torch.ops.quant import take, weight
from mlapi_tpu_torch.utils.platform import resolve_device


@register_model("wide_deep")
class WideDeepClassifier(nn.Module):
    """The JAX dataclass's fields. Weights are drawn from ``seed`` with
    the JAX package's distributions (tables ``1e-3 · N`` and
    ``N / sqrt(D)``, MLP kernels ``sqrt(2 / fan_in) · N``, zero wide
    weights and biases; the port's own numbers); ``seed=None`` skips the
    draw for weights about to be loaded."""

    input_kind = "tabular"

    def __init__(self, num_dense: int, vocab_sizes, embed_dim: int = 16,
                 hidden_dims=(256, 128), num_classes: int = 2,
                 compute_dtype: str = "bfloat16", *, seed: int | None = 0,
                 device=None):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
        self.num_dense = int(num_dense)
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.embed_dim = int(embed_dim)
        self.hidden_dims = tuple(int(w) for w in hidden_dims)
        self.num_classes = int(num_classes)
        self.compute_dtype = compute_dtype
        f, v, d = self.num_categorical, self.padded_vocab, self.embed_dim
        self.wide_dense = nn.Parameter(torch.zeros(self.num_dense,
                                                   self.num_classes))
        self.wide_bias = nn.Parameter(torch.zeros(self.num_classes))
        self.wide_tables = nn.Parameter(torch.zeros(f, v, self.num_classes))
        self.deep_tables = nn.Parameter(torch.zeros(f, v, d))
        widths = [self.num_dense + f * d, *self.hidden_dims,
                  self.num_classes]
        for i, (w_in, w_out) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"deep_{i}", _Dense(w_in, w_out))
        if seed is not None:
            gen = torch.Generator().manual_seed(int(seed))
            with torch.no_grad():
                self.wide_tables.normal_(0.0, 1e-3, generator=gen)
                self.deep_tables.normal_(0.0, d ** -0.5, generator=gen)
                for i, w_in in enumerate(widths[:-1]):
                    getattr(self, f"deep_{i}").kernel.normal_(
                        0.0, (2.0 / w_in) ** 0.5, generator=gen)
        self.requires_grad_(True)
        self.register_buffer(
            "_vocab", torch.tensor(self.vocab_sizes, dtype=torch.int32),
            persistent=False,
        )
        self.to(resolve_device(device))

    @property
    def num_categorical(self) -> int:
        return len(self.vocab_sizes)

    @property
    def num_features(self) -> int:
        return self.num_dense + self.num_categorical

    @property
    def padded_vocab(self) -> int:
        return max(self.vocab_sizes)

    @property
    def device(self) -> torch.device:
        return self.wide_bias.device

    def embedding_ids(self, x):
        """Categorical ids ``[B, F]`` int32: the float columns truncated
        toward zero, then the remainder by each feature's vocab."""
        return torch.remainder(x[:, self.num_dense:].to(torch.int32),
                               self._vocab)

    def params_tree(self) -> dict:
        """The parameters as the JAX pytree: top-level tensors and one
        ``{"kernel", "bias"}`` dict per MLP layer."""
        tree = {k: getattr(self, k) for k in
                ("wide_dense", "wide_bias", "wide_tables", "deep_tables")}
        for i in range(len(self.hidden_dims) + 1):
            layer = getattr(self, f"deep_{i}")
            tree[f"deep_{i}"] = {"kernel": layer.kernel, "bias": layer.bias}
        return tree

    @staticmethod
    def split_embeddings(params: dict) -> tuple[dict, dict]:
        """(dense leaves, embedding-table leaves)."""
        tables = {k: v for k, v in params.items() if k.endswith("_tables")}
        dense = {k: v for k, v in params.items() if k not in tables}
        return dense, tables

    @staticmethod
    def merge_embeddings(dense: dict, tables: dict) -> dict:
        return {**dense, **tables}

    def gather_rows(self, tables: dict, ids) -> dict:
        """Per-occurrence rows of every table, ``{name: [B, F, D_k]}``."""
        feat = torch.arange(self.num_categorical, device=ids.device)[None, :]
        return {k: take(t, feat, ids.long()) for k, t in tables.items()}

    def apply_from_rows(self, dense_params: dict, rows: dict, x):
        """The forward from gathered rows (``apply`` delegates here)."""
        dense = x[:, : self.num_dense]
        wide_logits = (dense @ weight(dense_params["wide_dense"])
                       + dense_params["wide_bias"]
                       + rows["wide_tables"].sum(dim=1))
        cdt = _DTYPES[self.compute_dtype]
        h = torch.cat([dense, rows["deep_tables"].reshape(dense.shape[0], -1)],
                      dim=1).to(cdt)
        n_hidden = len(self.hidden_dims)
        for i in range(n_hidden):
            layer = dense_params[f"deep_{i}"]
            h = torch.relu(h @ weight(layer["kernel"], cdt)
                           + layer["bias"].to(cdt))
        out = dense_params[f"deep_{n_hidden}"]
        deep_logits = (h.to(torch.float32) @ weight(out["kernel"])
                       + out["bias"])
        return wide_logits + deep_logits

    def apply(self, x):
        """``[B, num_dense + F]`` float rows → ``[B, num_classes]`` f32
        logits."""
        dense_params, tables = self.split_embeddings(self.params_tree())
        rows = self.gather_rows(tables, self.embedding_ids(x))
        return self.apply_from_rows(dense_params, rows, x)

    forward = apply

    def optimizer_partitions(self) -> dict[str, str]:
        """``{parameter name: label}`` for ``train.optimizers.partitioned``:
        the two embedding stacks ``"embedding"`` (rowwise AdaGrad, the
        Wide&Deep paper's recipe), everything else ``"default"``."""
        return {name: "embedding" if name.endswith("_tables") else "default"
                for name, _ in self.named_parameters()}

    def param_shardings(self, layout=None):
        raise NotImplementedError(
            "vocab-sharded Wide&Deep tables are not ported (ROADMAP "
            "Queue A item 8)"
        )
