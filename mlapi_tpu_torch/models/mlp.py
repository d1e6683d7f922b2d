"""MLP classifier (counterpart of ``mlapi_tpu/models/mlp.py``).

The JAX package's mixed precision, kept: the input, each hidden
layer's kernel and bias cast to ``compute_dtype`` (bf16 by default),
the product and the bias add rounded there, ReLU in that dtype; the
output layer in float32 on the float32 cast of the last hidden state.
Parameters keep Flax's key paths: ``dense_{i}/{kernel,bias}`` and
``out/{kernel,bias}``, kernels ``[d_in, d_out]``.
"""

from __future__ import annotations

import torch
from torch import nn

from mlapi_tpu_torch.models import register_model
from mlapi_tpu_torch.models.gpt import _DTYPES, _Dense
from mlapi_tpu_torch.utils.platform import resolve_device


@register_model("mlp")
class MLPClassifier(nn.Module):
    """``num_features`` → ``hidden_dims`` (ReLU) → ``num_classes``.

    Kernels are drawn from ``seed`` with Flax's default variance
    (normal, ``1 / fan_in``; the port draws its own numbers, so a seed
    gives other weights than the JAX package's), biases zero;
    ``seed=None`` skips the draw for weights about to be loaded."""

    input_kind = "tabular"

    def __init__(self, num_features: int, num_classes: int,
                 hidden_dims=(256, 128), compute_dtype: str = "bfloat16",
                 *, seed: int | None = 0, device=None):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
        self.num_features = int(num_features)
        self.num_classes = int(num_classes)
        self.hidden_dims = tuple(int(w) for w in hidden_dims)
        self.compute_dtype = compute_dtype
        widths = [self.num_features, *self.hidden_dims]
        for i, (w_in, w_out) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"dense_{i}", _Dense(w_in, w_out))
        self.out = _Dense(widths[-1], self.num_classes)
        if seed is not None:
            gen = torch.Generator().manual_seed(int(seed))
            with torch.no_grad():
                for mod in self.modules():
                    if isinstance(mod, _Dense):
                        fan_in = mod.kernel.shape[0]
                        mod.kernel.normal_(0.0, fan_in ** -0.5,
                                           generator=gen)
        self.requires_grad_(True)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.out.kernel.device

    def apply(self, x):
        """``[B, num_features]`` → ``[B, num_classes]`` f32 logits."""
        cdt = _DTYPES[self.compute_dtype]
        h = x.to(cdt)
        for i in range(len(self.hidden_dims)):
            h = torch.relu(getattr(self, f"dense_{i}")(h, cdt))
        return self.out(h.to(torch.float32), torch.float32)

    forward = apply
