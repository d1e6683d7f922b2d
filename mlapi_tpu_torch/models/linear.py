"""Linear (multinomial logistic-regression) classifier (counterpart of
``mlapi_tpu/models/linear.py``).

``logits = x @ w + b`` in float32; prediction and probability come
from the same logits, so the engine serves both from one device call.
Parameters ``{"w": [d, k], "b": [k]}``, the JAX pytree's key paths, so
``checkpoint.params_from_jax`` carries weights across unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from mlapi_tpu_torch.models import register_model
from mlapi_tpu_torch.models.gpt import _DTYPES
from mlapi_tpu_torch.ops.quant import weight
from mlapi_tpu_torch.utils.platform import resolve_device


@register_model("linear")
class LinearClassifier(nn.Module):
    """Multinomial softmax classifier. Zero-initialised, as in the JAX
    package (a convex objective has no symmetry to break), so ``seed``
    draws nothing; ``device`` as ``utils/platform`` resolves it."""

    input_kind = "tabular"

    def __init__(self, num_features: int, num_classes: int,
                 param_dtype: str = "float32", *, seed: int | None = 0,
                 device=None):
        super().__init__()
        del seed
        dt = _DTYPES[param_dtype]
        self.num_features = int(num_features)
        self.num_classes = int(num_classes)
        self.w = nn.Parameter(torch.zeros(num_features, num_classes, dtype=dt))
        self.b = nn.Parameter(torch.zeros(num_classes, dtype=dt))
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.w.device

    def apply(self, x):
        """``[B, d]`` features → ``[B, k]`` logits."""
        return x @ weight(self.w) + self.b

    forward = apply
