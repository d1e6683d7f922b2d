"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

The counterpart of ``mlapi_tpu/ops/pallas``. Each wrapper launches its
kernel for CUDA tensors (or raises) and runs the plain PyTorch version
beside it only for CPU tensors; each counts its launches in a plain
integer attribute (``decode_attention.launches``).
"""

from mlapi_tpu_torch.ops.cuda.decode_attention import (
    decode_attention,
    decode_attention_plain,
    extend_attention,
    extend_attention_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_extend_attention,
    paged_extend_attention_plain,
)
from mlapi_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_attention_with_lse,
    flash_backward_dkv,
    flash_backward_dq,
    flash_backward_plain,
    flash_forward,
    flash_forward_plain,
)

__all__ = [
    "decode_attention",
    "decode_attention_plain",
    "extend_attention",
    "extend_attention_plain",
    "flash_attention",
    "flash_attention_with_lse",
    "flash_backward_dkv",
    "flash_backward_dq",
    "flash_backward_plain",
    "flash_forward",
    "flash_forward_plain",
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "paged_extend_attention",
    "paged_extend_attention_plain",
]
