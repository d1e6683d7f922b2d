"""Weight-only int8 view of any model family (counterpart of
``mlapi_tpu/models/quantized.py``).

``QuantizedModel(inner)`` quantizes ``inner`` in place
(``ops/quant.quantize_module_``: every float parameter with ``ndim >=
2`` and at least ``MIN_QUANT_SIZE`` elements becomes a ``QuantLeaf`` of
int8 ``q`` and f32 ``scale`` buffers, the rest stays float) and wraps
it. Nothing is dequantized ahead of time: each model reads its weights
through ``ops/quant.weight`` / ``ops/quant.take``, so a quantized leaf
expands at its use, one layer's weights at a time, and an embedding
table only for the rows a step gathers (GPT-2's tied head needs the
whole ``wte`` each step). The float models run the same ops as
before through those two calls.

Every attribute the wrapper does not define is the inner model's, so
the engines serve it as they serve the float model (``apply``,
``prefill_core``, ``decode_step``, ``extend_core``, ``generate``,
``init_cache``, ...). The KV-cache format stays the inner model's
``kv_quant``: int8 weights and an int8 cache compose, neither knowing
of the other. The state dict is the inner model's, with each quantized
leaf as ``<path>.q`` / ``<path>.scale``, the JAX package's quantized
tree, so ``checkpoint.params_from_jax`` of a JAX ``quantize_tree``
result loads into it.
"""

from __future__ import annotations

from torch import nn

from mlapi_tpu_torch.ops.quant import quantize_module_


class QuantizedModel(nn.Module):
    """Weight-only int8 wrapper over any model of the port. Quantize on
    the host, before the model moves to the card."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = quantize_module_(inner)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["inner"], name)

    def state_dict(self, *args, **kwargs):
        return self.inner.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        return self.inner.load_state_dict(state_dict, strict=strict,
                                          assign=assign)

    def apply(self, *args, **kwargs):
        return self.inner.apply(*args, **kwargs)

    def cast_dense_(self) -> "QuantizedModel":
        """The inner model's float dense leaves in the compute dtype;
        the int8 ones stay as they are."""
        self.inner.cast_dense_()
        return self

    forward = apply

    def param_shardings(self, layout=None):
        raise NotImplementedError(
            "quantized serving on a device mesh is not ported (ROADMAP "
            "Queue A item 8)"
        )
