"""ComputeContext — the device every controller receives.

Counterpart of ``predictionio_tpu/parallel/mesh.py`` (``ComputeContext``,
``pad_to_multiple``, ``record_padded_rows``,
``assert_phantom_rows_zero``). The JAX context holds a device mesh; this
slice runs on one card, so the context holds one ``torch.device`` with
data and model parallelism 1, and sharding degenerates to ``.to(device)``.
The padding contracts stay so the multi-GPU slice can widen them.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any

import numpy as np
import torch

logger = logging.getLogger(__name__)


def pad_to_multiple(
    arr: np.ndarray, multiple: int, axis: int = 0, fill: Any = 0
) -> np.ndarray:
    """Pad ``axis`` up to the next multiple of ``multiple``."""
    size = arr.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - size)
    return np.pad(arr, widths, constant_values=fill)


def record_padded_rows(added: int, n_rows: int, parallelism: int) -> None:
    """Report phantom rows added by padding to a parallelism multiple;
    warns when the padding exceeds the real data."""
    logger.debug("padded %d phantom row(s) onto %d", added, n_rows)
    if n_rows < parallelism:
        logger.warning(
            "padding %d-row array to %d rows to shard over %d "
            "devices — padding exceeds the real data",
            n_rows, n_rows + added, parallelism,
        )


def assert_phantom_rows_zero(
    arr, n_real: int, what: str = "factors"
) -> None:
    """Rows past ``n_real`` exist only for padding and must be exact
    zeros; anything else would score into serving as a ghost entity."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    tail = np.asarray(arr)[n_real:]
    if tail.size and np.any(tail != 0):
        bad = int(np.count_nonzero(np.any(tail != 0, axis=-1)))
        raise AssertionError(
            f"phantom-row invariant violated: {bad} padded row(s) of "
            f"{what} past row {n_real} are nonzero"
        )


_linalg_lock = threading.Lock()
_linalg_loaded = False


def load_cuda_linalg(device: torch.device) -> None:
    """Make this process's first CUDA linear-algebra call, once, under a
    lock. torch loads its CUDA linalg library at that first call, and
    the load is not thread-safe: two threads making it together (the
    candidates of an evaluation, each training ALS) fail with "lazy
    wrapper should be called at most once". Callers of
    ``torch.linalg`` on the card call this first; on the CPU it does
    nothing."""
    global _linalg_loaded
    if _linalg_loaded or device.type != "cuda":
        return
    with _linalg_lock:
        if not _linalg_loaded:
            torch.linalg.cholesky_ex(torch.ones(1, 1, device=device))
            _linalg_loaded = True


class NoDeviceError(RuntimeError):
    """CUDA was asked for (or defaulted to) and there is no card. The
    console prints it as ``error: ...`` and exits 1, as the JAX console
    does its ``DeviceInitTimeout``."""


@dataclasses.dataclass
class ComputeContext:
    """The card (or, for tests, the CPU) controllers run on."""

    device: torch.device
    batch: str = ""  # run label

    @staticmethod
    def create(
        batch: str = "", device: str | torch.device | None = None
    ) -> "ComputeContext":
        """A context on ``device``; by default the current CUDA device.
        Without CUDA, asking for it (or the default) raises
        :class:`NoDeviceError`: the port never drops quietly to the CPU.
        Pass ``device="cpu"`` to run the plain versions there."""
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise NoDeviceError(
                "ComputeContext.create: no CUDA device is available; "
                "pass device='cpu' (--device cpu) to run on the host"
            )
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        logger.info("ComputeContext %r on %s", batch, device)
        return ComputeContext(device=device, batch=batch)

    @property
    def n_devices(self) -> int:
        return 1

    @property
    def data_parallelism(self) -> int:
        return 1

    @property
    def model_parallelism(self) -> int:
        return 1

    def shard_rows(self, arr, fill: Any = 0) -> torch.Tensor:
        """Pad rows to the data-axis multiple and place on the device."""
        multiple = max(self.data_parallelism, 1)
        arr = np.asarray(arr)
        padded = pad_to_multiple(arr, multiple, axis=0, fill=fill)
        if padded.shape[0] != arr.shape[0]:
            record_padded_rows(
                padded.shape[0] - arr.shape[0], arr.shape[0], multiple
            )
        return torch.as_tensor(padded).to(self.device)

    def replicate(self, arr) -> torch.Tensor:
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device)
        return torch.as_tensor(np.asarray(arr)).to(self.device)
