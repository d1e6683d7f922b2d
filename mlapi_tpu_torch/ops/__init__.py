"""Tensor ops: attention, the KV-cache formats, the CUDA kernels, and
speculative decoding (draft-propose / target-verify)."""

from mlapi_tpu_torch.ops.attention import NEG, full_attention
from mlapi_tpu_torch.ops.speculative import (
    speculative_generate,
    speculative_generate_batched,
    speculative_sample,
    speculative_sample_batched,
)

__all__ = [
    "NEG",
    "full_attention",
    "speculative_generate",
    "speculative_generate_batched",
    "speculative_sample",
    "speculative_sample_batched",
]
