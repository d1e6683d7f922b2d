"""Device selection: CUDA unless the caller asks for the CPU.

The JAX package re-pins ``jax_platforms`` from ``MLAPI_TPU_PLATFORM``
(``mlapi_tpu/utils/platform.py``). The port keeps the same variable
and adds an explicit argument: :func:`resolve_device` returns the
device an entry point runs on. The order is the ``device`` argument
(``--device`` on a CLI), then ``MLAPI_TPU_PLATFORM``, then CUDA. A
request for CUDA on a machine without a card raises — the port never
falls back to the CPU on its own, because a server silently running a
GPT on host cores is a failure that only shows as latency.
"""

from __future__ import annotations

import os

import torch

ENV_VAR = "MLAPI_TPU_PLATFORM"


def resolve_device(device=None, env_var: str = ENV_VAR) -> torch.device:
    """The device to run on: ``device`` if given, else ``cpu`` when
    ``$MLAPI_TPU_PLATFORM`` says so, else ``cuda``. Raises
    ``RuntimeError`` when the answer is a CUDA device and none is
    available."""
    if device is None:
        env = os.environ.get(env_var, "").strip().lower()
        device = "cpu" if env == "cpu" else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            f"--device cpu, or {env_var}=cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
