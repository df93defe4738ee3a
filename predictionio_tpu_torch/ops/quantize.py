"""Quantized factor tables: int8 with a per-row scale, or bf16.

Counterpart of ``predictionio_tpu/ops/quantize.py``. Rows are quantized
symmetrically (``scale[i] = max|row_i| / 127``), with the JAX package's
arithmetic kept to the bit: ``x / scale`` (not ``x * (1 / scale)``) and
round half to even (``torch.round``, as ``jnp.round``), so both
packages produce the same int8 table. The tables serve through the same
fused top-k kernel as float32: it converts each row to float32 on load
and multiplies each item's score by its scale after the dot.

Quantized and float32 rankings agree approximately; callers gate on
:func:`recall_at_k` against the float32 order.

Both quantizations are row-local, so a table sharded over the mesh's
``model`` axis (a ``ShardedTensor``) quantizes shard by shard, and
``quantize_factors`` of each slice equals the slice of
``quantize_factors`` of the whole table: the int8 data and its scale stay
sharded alike, and serve through ``fused_topk.sharded_top_k_dot``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from predictionio_tpu_torch.ops.fused_topk import fused_top_k_dot
from predictionio_tpu_torch.parallel.mesh import ShardedTensor

MODES = ("int8", "bf16")

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class QuantizedFactors:
    """``data`` ([N, k] int8 or bfloat16) plus an optional per-row
    float32 ``scale`` ([N]); row ``i`` dequantizes to
    ``data[i].float() * scale[i]`` (scale ``None`` means 1.0)."""

    data: "torch.Tensor | ShardedTensor"
    scale: "torch.Tensor | ShardedTensor | None"
    mode: str

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(t) for t in (self.data, self.scale)
                   if t is not None)


def _nbytes(t) -> int:
    if isinstance(t, ShardedTensor):
        return t.nbytes
    return t.numel() * t.element_size()


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x)
    )


def quantize_factors(x, mode: str = "int8") -> QuantizedFactors:
    """Quantize an ``[N, k]`` float factor matrix per row, on the device
    it lies on. ``int8``: symmetric absmax scaling (zero rows get scale
    1.0 so they stay exactly zero); ``bf16``: a plain cast, no scale."""
    if mode not in MODES:
        raise ValueError(f"unknown quantize mode {mode!r}")
    if isinstance(x, ShardedTensor):  # row-local: shard by shard
        return QuantizedFactors(
            data=x.map(lambda t: quantize_factors(t, mode).data),
            scale=None if mode == "bf16" else x.map(
                lambda t: quantize_factors(t, mode).scale),
            mode=mode,
        )
    x = _as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"expected [N, k] factors, got shape {tuple(x.shape)}")
    if mode == "bf16":
        return QuantizedFactors(
            data=x.to(torch.bfloat16).contiguous(), scale=None, mode="bf16"
        )
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(
        torch.int8
    )
    return QuantizedFactors(data=q.contiguous(), scale=scale, mode="int8")


def dequantize(qf: QuantizedFactors) -> torch.Tensor:
    """Full float32 reconstruction (tests and evaluation only)."""
    if isinstance(qf.data, ShardedTensor):
        qf = QuantizedFactors(
            data=qf.data.gather(),
            scale=None if qf.scale is None else qf.scale.gather(),
            mode=qf.mode)
    x = qf.data.to(torch.float32)
    if qf.scale is not None:
        x = x * qf.scale[:, None]
    return x


def stage_quantized(
    qf: QuantizedFactors, device: str | torch.device
) -> QuantizedFactors:
    """A copy of a quantized table on ``device`` (no copy when it is
    already there, or placed over a mesh)."""
    if isinstance(qf.data, ShardedTensor):
        return qf
    return QuantizedFactors(
        data=qf.data.to(device),
        scale=None if qf.scale is None else qf.scale.to(device),
        mode=qf.mode,
    )


def top_k_dot_quantized(
    queries: torch.Tensor,
    items: QuantizedFactors,
    num: int,
    mask=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized twin of :func:`ops.similarity.top_k_dot`: the int8 or
    bf16 table goes to the kernel as it is, with its scale."""
    queries = queries.to(torch.float32)
    num = min(num, items.shape[0])
    return fused_top_k_dot(queries, items.data, num, mask, scale=items.scale)


def gather_rows(qf: "QuantizedFactors | torch.Tensor", idx) -> torch.Tensor:
    """Dequantized float32 rows ``qf[idx]``; only the gathered rows are
    ever reconstructed, never the table."""
    data = qf.data if isinstance(qf, QuantizedFactors) else qf
    if isinstance(data, ShardedTensor):
        rows = data.take_rows(idx).to(torch.float32)
        if isinstance(qf, QuantizedFactors) and qf.scale is not None:
            rows = rows * qf.scale.take_rows(idx)[:, None]
        return rows
    data = _as_tensor(data)
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=data.device)
    rows = torch.index_select(data, 0, idx).to(torch.float32)
    if isinstance(qf, QuantizedFactors) and qf.scale is not None:
        rows = rows * torch.index_select(qf.scale, 0, idx)[:, None]
    return rows


def normalized(qf: QuantizedFactors) -> QuantizedFactors:
    """Row-normalized view for cosine scoring: the SAME int8/bf16 data
    with ``scale = 1/‖data_row‖``."""
    def inv_norm(t):
        return 1.0 / (torch.linalg.vector_norm(t.to(torch.float32), dim=1)
                      + _EPS)

    scale = (qf.data.map(inv_norm) if isinstance(qf.data, ShardedTensor)
             else inv_norm(qf.data))
    return QuantizedFactors(data=qf.data, scale=scale, mode=qf.mode)


def recall_at_k(ref_idx, got_idx) -> float:
    """Mean per-row overlap fraction between two ``[B, k]`` top-k index
    sets — the agreement metric quantized serving is gated on."""
    ref = np.asarray(ref_idx)
    got = np.asarray(got_idx)
    if ref.shape != got.shape:
        raise ValueError(f"shape mismatch {ref.shape} vs {got.shape}")
    k = ref.shape[-1]
    hits = [
        len(set(r.tolist()) & set(g.tolist()))
        for r, g in zip(ref.reshape(-1, k), got.reshape(-1, k))
    ]
    return float(np.mean(hits)) / k if hits else 1.0


def quantize_model_factors(model, mode: str = "int8"):
    """Quantize every 2-D float ``*_factors`` field of a dataclass model
    on the device it lies on, returning a replaced copy. Anything else
    passes through unchanged."""
    if not mode:
        return model
    if not dataclasses.is_dataclass(model) or isinstance(model, type):
        return model
    updates = {}
    for field in dataclasses.fields(model):
        if not field.name.endswith("_factors"):
            continue
        value = getattr(model, field.name, None)
        if value is None or isinstance(value, QuantizedFactors):
            continue
        arr = value if isinstance(value, ShardedTensor) else _as_tensor(
            value)
        if arr.ndim != 2 or not arr.is_floating_point():
            continue
        updates[field.name] = quantize_factors(arr, mode)
    if not updates:
        return model
    return dataclasses.replace(model, **updates)


def model_resident_bytes(model, _depth: int = 3) -> int:
    """Bytes a staged model holds: the sum of ``nbytes`` over tensor,
    array and :class:`QuantizedFactors` attributes (dataclass fields,
    else ``__dict__``), recursing into nested dataclasses a few levels."""
    if dataclasses.is_dataclass(model) and not isinstance(model, type):
        values = [
            getattr(model, f.name, None) for f in dataclasses.fields(model)
        ]
    elif hasattr(model, "__dict__"):
        values = list(vars(model).values())
    else:
        values = [model]
    total = 0
    for value in values:
        nbytes = getattr(value, "nbytes", None)
        if isinstance(nbytes, (int, np.integer)):
            total += int(nbytes)
        elif (
            _depth > 0
            and dataclasses.is_dataclass(value)
            and not isinstance(value, type)
        ):
            total += model_resident_bytes(value, _depth - 1)
    return total
