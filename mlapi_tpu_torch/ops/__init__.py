"""Tensor ops: attention, the KV-cache formats, and the CUDA kernels."""

from mlapi_tpu_torch.ops.attention import NEG, full_attention

__all__ = ["NEG", "full_attention"]
