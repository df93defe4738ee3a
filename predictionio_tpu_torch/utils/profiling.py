"""Step timing with a device barrier.

Counterpart of ``predictionio_tpu/utils/profiling.py`` (``sync``,
``StepTimer``). PyTorch returns before the card finishes, so a timed
step that should include device work ends in :func:`sync`.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from collections import defaultdict

import torch

logger = logging.getLogger(__name__)


def sync(value=None) -> None:
    """Device barrier: ``torch.cuda.synchronize`` for a CUDA tensor (or,
    with no argument, for the current CUDA device when there is one); a
    no-op on the CPU, where every op has finished when it returns."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
        return
    if value is None and torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Named per-step wall-clock records."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.records: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def step(self, name: str, sync_value=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                sync(sync_value)
            self.records[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        if self.enabled:
            self.records[name].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.records.items():
            out[name] = {
                "count": len(xs),
                "total_s": round(sum(xs), 6),
                "mean_s": round(sum(xs) / len(xs), 6),
                "max_s": round(max(xs), 6),
            }
        return out

    def to_json(self) -> str:
        return json.dumps(self.summary())

    def log_summary(self, prefix: str = "") -> None:
        for name, s in self.summary().items():
            logger.info(
                "%s%s: %d step(s), mean %.4fs, total %.2fs",
                prefix, name, s["count"], s["mean_s"], s["total_s"],
            )
