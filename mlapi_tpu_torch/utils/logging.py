"""Structured logging: one namespaced logger per subsystem, one format.

Loggers live under ``mlapi_tpu_torch`` (e.g. ``serving.engine``); the
level comes from ``MLAPI_TPU_LOG_LEVEL`` as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "mlapi_tpu_torch"


def _configure() -> None:
    root = logging.getLogger(_ROOT)
    if getattr(root, "_mlapi_configured", False):
        return
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        root.addHandler(handler)
    root.setLevel(os.environ.get("MLAPI_TPU_LOG_LEVEL", "INFO").upper())
    root.propagate = False
    root._mlapi_configured = True


def get_logger(name: str) -> logging.Logger:
    """Logger namespaced under the package root (e.g. ``serving.asgi``)."""
    _configure()
    return logging.getLogger(f"{_ROOT}.{name}")
