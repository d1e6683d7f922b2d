"""Serving: engines, the scoring path, the batch lifecycle, the HTTP
app and server.

``python -m mlapi_tpu_torch.serving --checkpoint DIR`` serves a
classifier (``/predict``, ``/files/``) or a ``gpt_lm`` / ``llama_lm``
checkpoint (``/generate``); see ``serving/__main__.py``.
"""
