"""Scoring for serving: dot-product and cosine top-k over a factor table.

Counterpart of ``predictionio_tpu/ops/similarity.py`` (``l2_normalize``,
``top_k_dot``, ``top_k_cosine``, ``stage_factors``, ``gather_top_k_dot``,
``gather_mean_top_k_cosine``).
Every top-k here goes through :func:`ops.fused_topk.fused_top_k_dot`: on
a CUDA tensor that launches the hand-written kernel at every size, with
no size threshold and no library path beside it; on a CPU tensor it runs
the kernel's plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from predictionio_tpu_torch.ops.fused_topk import fused_top_k_dot


def l2_normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def _quantized(x) -> bool:
    """True when ``x`` is an ``ops.quantize.QuantizedFactors`` table."""
    from predictionio_tpu_torch.ops import quantize

    return isinstance(x, quantize.QuantizedFactors)


def top_k_dot(
    queries: torch.Tensor,
    items,
    num: int,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``num`` items by dot product: ``(scores, indices)``, each
    ``[B, num]``. ``items`` may be a quantized table
    (:class:`ops.quantize.QuantizedFactors`); ``mask`` is ``[I]`` or
    ``[B, I]``, True = exclude."""
    if _quantized(items):
        from predictionio_tpu_torch.ops import quantize

        return quantize.top_k_dot_quantized(queries, items, num, mask)
    num = min(num, items.shape[0])
    return fused_top_k_dot(queries, items, num, mask)


def top_k_cosine(
    queries: torch.Tensor,
    items,
    num: int,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``num`` by cosine similarity. A quantized table stays
    quantized: its per-row scale is replaced by ``1/‖row‖``."""
    if _quantized(items):
        from predictionio_tpu_torch.ops import quantize

        return quantize.top_k_dot_quantized(
            l2_normalize(queries), quantize.normalized(items), num, mask
        )
    return top_k_dot(l2_normalize(queries), l2_normalize(items), num, mask)


def stage_factors(x, device: str | torch.device = "cuda") -> torch.Tensor:
    """A factor matrix on ``device``, copied once; a tensor already
    there is returned as it is."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        if x.device.type == device.type and (
            device.index is None or x.device == device
        ):
            return x
        return x.to(device)
    return torch.as_tensor(np.asarray(x)).to(device)


def gather_top_k_dot(
    factors, idx, items, num: int, mask=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row gather (``torch.index_select``, outside the kernel) + dot
    scores + top-``num``. Either table may be quantized: gathered user
    rows dequantize to float32, the item table stays int8/bf16. Staged
    serving passes tensors already on the card; host arrays are moved to
    the device of the other table (or the CUDA device)."""
    if _quantized(factors) or _quantized(items):
        from predictionio_tpu_torch.ops import quantize

        vecs = quantize.gather_rows(factors, idx)
        if _quantized(items):
            return quantize.top_k_dot_quantized(vecs, items, num, mask)
        return top_k_dot(vecs, stage_factors(items, vecs.device), num, mask)
    device = next(
        (t.device for t in (factors, items) if isinstance(t, torch.Tensor)),
        torch.device("cuda"),
    )
    factors = stage_factors(factors, device)
    items = stage_factors(items, device)
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=device)
    vecs = torch.index_select(factors, 0, idx)
    return fused_top_k_dot(vecs, items, min(num, items.shape[0]), mask)


def _basket_mean(rows: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """``[1, k]`` mean of the gathered rows whose ``idx`` is not ``-1``;
    the divisor is ``max(valid, 1)``."""
    w = torch.as_tensor(idx >= 0, device=rows.device).to(rows.dtype)[:, None]
    return (rows * w).sum(dim=0, keepdim=True) / torch.clamp(w.sum(), min=1.0)


def gather_mean_top_k_cosine(
    items_f, idx, num: int, mask=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Similar-product query: the mean of the gathered item rows of
    ``idx`` (``-1`` entries are padding), then cosine against the whole
    catalog and top-``num``. ``mask`` ([I] bool, True = exclude) drops
    rows from the ranking. The catalog's normalization is a plain torch
    pass before the kernel; a quantized table keeps its int8/bf16 data
    with a ``1/‖row‖`` scale instead. A host table is moved to the CUDA
    device. Returns ``([1, num] scores, [1, num] indices)``."""
    idx = np.asarray(idx, np.int64)
    num = min(num, items_f.shape[0])
    if _quantized(items_f):
        from predictionio_tpu_torch.ops import quantize

        q = _basket_mean(quantize.gather_rows(items_f, np.clip(idx, 0, None)),
                         idx)
        return quantize.top_k_dot_quantized(
            l2_normalize(q), quantize.normalized(items_f), num, mask
        )
    device = (items_f.device if isinstance(items_f, torch.Tensor)
              else torch.device("cuda"))
    items_f = stage_factors(items_f, device)
    rows = torch.index_select(
        items_f, 0, torch.as_tensor(np.clip(idx, 0, None), device=device)
    )
    return fused_top_k_dot(
        l2_normalize(_basket_mean(rows, idx)), l2_normalize(items_f), num,
        mask,
    )
