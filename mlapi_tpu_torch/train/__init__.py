"""Training loop and CLI (counterpart of ``mlapi_tpu/train``)."""

from mlapi_tpu_torch.train.loop import (  # noqa: F401
    TrainResult,
    evaluate,
    evaluate_lm,
    fit,
    make_train_step,
)
