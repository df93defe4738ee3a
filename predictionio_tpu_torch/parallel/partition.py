"""Serving-side factor staging.

Counterpart of ``stage_factor_matrix`` in
``predictionio_tpu/parallel/partition.py``. The rule tables for sharded
ALS belong to the multi-GPU slice; on one card a factor matrix is
committed whole.
"""

from __future__ import annotations

import numpy as np
import torch

from predictionio_tpu_torch.parallel.mesh import (
    ComputeContext,
    pad_to_multiple,
    record_padded_rows,
)


def _as_factor_tensor(arr) -> torch.Tensor:
    """A host factor matrix as a tensor. float64 becomes float32, as a
    device put does in the JAX package (64-bit types are off there)."""
    if isinstance(arr, torch.Tensor):
        t = arr
    else:
        t = torch.as_tensor(np.asarray(arr))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t


def stage_factor_matrix(
    ctx: ComputeContext,
    arr,
    n_real: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Commit one factor matrix to ``ctx.device``; returns ``(factors,
    phantom_mask)``.

    Rows are padded to the model-axis multiple (1 on one card) with
    zeros. ``phantom_mask`` is an ``[rows]`` bool tensor on the device,
    True on rows past ``n_real`` (``None`` when there are none); serving
    passes it to the top-k kernel as its ``[I]`` mask, so a padded row
    never surfaces as a result. A tensor already on the device with a
    whole number of model-axis rows passes through without a copy."""
    n_rows = int(arr.shape[0])
    n_real = n_rows if n_real is None else int(n_real)
    multiple = max(ctx.model_parallelism, 1)
    if isinstance(arr, torch.Tensor) and arr.device == ctx.device:
        if n_rows % multiple:
            raise ValueError(
                f"device-resident factor matrix has {n_rows} rows, not "
                f"a multiple of model_parallelism {multiple}"
            )
        staged = _as_factor_tensor(arr).contiguous()
    else:
        host = _as_factor_tensor(arr).cpu().numpy()
        padded = pad_to_multiple(host, multiple, axis=0)
        if padded.shape[0] != n_rows:
            record_padded_rows(padded.shape[0] - n_rows, n_rows, multiple)
        staged = torch.as_tensor(padded).to(ctx.device).contiguous()
    if staged.shape[0] <= n_real:
        return staged, None
    mask = torch.arange(staged.shape[0], device=ctx.device) >= n_real
    return staged, mask
