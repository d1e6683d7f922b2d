"""mlapi_tpu_torch — the PyTorch/CUDA port of mlapi_tpu's serving and
training paths.

The port mirrors the JAX package's layout (``models/gpt.py``,
``models/llama.py``, ``models/bert.py``, ``ops/quant.py``,
``serving/engine.py``,
``train/loop.py``, ...) so each module has an obvious counterpart, and
it imports neither JAX nor anything of ``mlapi_tpu``: it carries its own
copies of what it needs. The attention kernels that the JAX package
wrote in Pallas for the TPU (cache reads for serving, flash attention
for training) are CUDA C++ kernels for Hopper here (``csrc/``, bound
through ``ops/cuda``).

Every entry point runs on the CUDA device unless the caller asks for
the CPU (``device="cpu"``, ``--device cpu`` or
``MLAPI_TPU_PLATFORM=cpu``); see :mod:`mlapi_tpu_torch.utils.platform`.
"""

__version__ = "0.1.0"
