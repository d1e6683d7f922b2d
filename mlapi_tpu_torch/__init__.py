"""mlapi_tpu_torch — the PyTorch/CUDA port of mlapi_tpu's serving path.

The port mirrors the JAX package's layout (``models/gpt.py``,
``ops/quant.py``, ``serving/engine.py``, ...) so each module has an
obvious counterpart, and it imports neither JAX nor anything of
``mlapi_tpu``: it carries its own copies of what it needs. The cache
reads that the JAX package wrote as Pallas TPU kernels are CUDA C++
kernels for Hopper here (``csrc/``, bound through ``ops/cuda``).

Every entry point runs on the CUDA device unless the caller asks for
the CPU (``device="cpu"``, ``--device cpu`` or
``MLAPI_TPU_PLATFORM=cpu``); see :mod:`mlapi_tpu_torch.utils.platform`.
"""

__version__ = "0.1.0"
