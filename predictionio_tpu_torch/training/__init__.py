"""Continuous-training tier: the supervised background trainer that
keeps the model store fresh beside — not inside — the serving path.

Counterpart of ``predictionio_tpu/training``."""

from predictionio_tpu_torch.training.trainer import (  # noqa: F401
    ContinuousTrainer,
    TrainerConfig,
    Watermark,
    read_watermark,
)
