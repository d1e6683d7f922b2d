"""Generative serving: engine, batch lifecycle, HTTP app and server.

``python -m mlapi_tpu_torch.serving --checkpoint DIR`` serves a
``gpt_lm`` checkpoint; see ``serving/__main__.py``.
"""
