"""Model registry: ``get_model(name, **kwargs)`` builds a model by its
config name, the name a checkpoint's manifest records (``gpt_lm``,
``llama_lm``, ``bert_classifier``, ``linear``, ``mlp``,
``wide_deep``)."""

from __future__ import annotations

from mlapi_tpu_torch.utils.registry import Registry

_REGISTRY: Registry = Registry("model")
register_model = _REGISTRY.register


def get_model(name: str, **kwargs):
    """Build a model by registry name (e.g. ``gpt_lm``)."""
    return _REGISTRY.get(name)(**kwargs)


def model_registered(name: str) -> bool:
    return name in _REGISTRY.names()


# Import model modules for their registration side effects.
from mlapi_tpu_torch.models import gpt as _gpt  # noqa: E402,F401
from mlapi_tpu_torch.models.bert import BertClassifier  # noqa: E402,F401
from mlapi_tpu_torch.models.gpt import GptLM  # noqa: E402,F401
from mlapi_tpu_torch.models.linear import LinearClassifier  # noqa: E402,F401
from mlapi_tpu_torch.models.llama import LlamaLM  # noqa: E402,F401
from mlapi_tpu_torch.models.mlp import MLPClassifier  # noqa: E402,F401
from mlapi_tpu_torch.models.wide_deep import (  # noqa: E402,F401
    WideDeepClassifier,
)
