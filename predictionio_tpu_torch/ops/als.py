"""Alternating Least Squares on the device mesh.

Counterpart of ``predictionio_tpu/ops/als.py`` (implicit Hu-Koren-Volinsky
and explicit weighted-λ ALS), in PyTorch on ``ctx``'s devices:

* Host side, interactions are packed into **degree-bucketed slabs**
  (:func:`build_bucketed`, copied from the JAX package, numpy plus the
  native fill pass of ``native/alspack.cc``): every row of a bucket owns
  one dense ``[s * block_len]`` slot row; rows heavier than ``s_max``
  blocks are split into sub-rows.
* Device side, one half-iteration is, per slab: each row's normal
  equations from the opposite side's factors (:func:`_slab_stats`: on
  the card one launch of the hand-written kernel ``csrc/als_gramian.cu``,
  which gathers the factors on chip and never writes the ``[R, W, k]``
  slab; on the CPU the gather and ``torch.bmm``) → batched Cholesky
  solves (:func:`_solve`: on the card one launch of the hand-written
  kernel ``csrc/als_solve.cu``; on the CPU ``torch.linalg.cholesky_ex``
  + ``cholesky_solve``). Neither kernel allocates or waits. Heavy
  sub-rows add their partial stats into their owner's slot before that
  slot is solved, pairwise in a fixed order planned on the host
  (:class:`HeavyOrder`: no atomics), so a run repeats bit for bit: on
  the card one launch a group of ``csrc/als_heavy_add.cu``
  (:func:`_heavy_stats`), on the CPU gathers and strided adds.
* :func:`train_als` alternates the two sides for ``iterations`` epochs,
  with npz checkpoints in the JAX package's format, so a checkpoint
  written by either package resumes in the other.
* Under an open trace (:mod:`~predictionio_tpu_torch.obs.tracing`) the
  path records its stages as spans (``als/pack``, ``als/stage``,
  ``als/fetch``) and, per profiler range of a half-step, host seconds,
  calls, stream drains, the systems solved and the slab slots summed
  (:class:`RangeTotals`); with no trace open each site costs one
  contextvar read.
* On a mesh of more than one device the slab rows split over ``data``
  (replicated factors, the solved rows all-gathered), or, with
  ``factor_sharding="sharded"``, the factor matrices split over ``model``
  and the stats rows over every device (:func:`plan_shards`), each
  position solving its rows and the results gathered device-major.

The JAX package's k-major gather layout (``PIO_ALS_GATHER_LAYOUT``), a
TPU formulation of the same math, is not ported; its unrolled
Cholesky–Crout solve (``_chol_solve_batched``) is the CUDA kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import logging
import math
import os
import time
from typing import Callable

import numpy as np
import torch

from predictionio_tpu_torch.obs import get_registry, tracing
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.parallel import distributed, partition
from predictionio_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    ComputeContext,
    ShardedTensor,
    assert_phantom_rows_zero,
)
from predictionio_tpu_torch.utils.profiling import steps_on

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Host-side packing (copied from the JAX package; numpy only)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PaddedCSR:
    """Fixed-shape blocked interaction lists for one solve direction.

    Retained as the simple packing primitive (tests / external callers);
    :func:`train_als` itself uses the bucketed layout below.
    """

    idx: np.ndarray      # [R, L] int32 — column ids (0 where padded)
    weights: np.ndarray  # [R, L] float32 — interaction value
    valid: np.ndarray    # [R, L] float32 — 1.0 real nnz / 0.0 padding
    owner: np.ndarray    # [R] int32 — row entity of each block
    n_rows: int          # entity count (unpadded)
    n_rows_padded: int   # entity count padded for the mesh

    @property
    def n_blocks(self) -> int:
        return len(self.owner)


def build_padded_csr(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    block_len: int = 64,
    row_multiple: int = 1,
    block_multiple: int = 1,
) -> PaddedCSR:
    """Pack COO → blocked CSR (vectorized, no Python loop over nnz).

    ``row_multiple`` pads the entity count (so factor matrices shard
    evenly); ``block_multiple`` pads the block count (so blocks split
    evenly over devices × scan chunks).
    """
    rows = np.asarray(rows, np.int64)
    order = np.argsort(rows, kind="stable")
    r, c, v = rows[order], np.asarray(cols)[order], np.asarray(vals)[order]
    deg = np.bincount(r, minlength=n_rows)
    nseg = -(-deg // block_len)  # ceil; 0 for empty rows
    seg_base = np.concatenate([[0], np.cumsum(nseg)[:-1]])
    n_blocks = int(nseg.sum())
    row_start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    idx_in_row = np.arange(len(r)) - row_start[r]
    seg_of_nnz = seg_base[r] + idx_in_row // block_len
    pos_in_seg = idx_in_row % block_len

    blocks_padded = max(
        1, -(-n_blocks // block_multiple) * block_multiple
    )
    idx = np.zeros((blocks_padded, block_len), np.int32)
    weights = np.zeros((blocks_padded, block_len), np.float32)
    valid = np.zeros((blocks_padded, block_len), np.float32)
    owner = np.zeros(blocks_padded, np.int32)
    idx[seg_of_nnz, pos_in_seg] = c
    weights[seg_of_nnz, pos_in_seg] = v
    valid[seg_of_nnz, pos_in_seg] = 1.0
    owner[:n_blocks] = np.repeat(np.arange(n_rows), nseg)
    # padding blocks carry zero weights → zero contribution; owner 0 is safe
    n_rows_padded = max(
        row_multiple, -(-n_rows // row_multiple) * row_multiple
    )
    return PaddedCSR(
        idx=idx,
        weights=weights,
        valid=valid,
        owner=owner,
        n_rows=n_rows,
        n_rows_padded=n_rows_padded,
    )


@dataclasses.dataclass
class Slab:
    """One degree bucket: every row owns one dense slot row."""

    idx: np.ndarray      # [R, W] int32 — column ids (0 where padded)
    weights: np.ndarray  # [R, W] float32
    valid: np.ndarray    # [R, W] float32


@dataclasses.dataclass
class Bucketed:
    """Degree-bucketed interaction layout for one solve direction.

    ``slabs`` hold rows with ≤ ``s_max`` blocks (one slot row each,
    phantom rows appended so each slab splits evenly over the mesh).
    ``heavy`` holds the sub-row slab groups of rows heavier than
    ``s_max`` blocks; ``heavy_owner_pos[g]`` maps each sub-row of group
    ``g`` to its owner's position in the concatenated stats layout.
    ``inv_perm[row]`` is the row's position in that layout (heavy rows
    own one zero-initialized slot each, after all regular slab rows).

    Slabs (regular and heavy) are split so no single slab exceeds
    ``max_slab_slots`` slots: the plain version's per-slab factor gather
    materializes a ``[R·W, k]`` temp (256 MB in float32 at k = 32 and
    the default 2M slots; the card's kernel writes none, and there the
    split sets the launches a half-step makes). Splitting bounds the
    peak temp; the concatenated stats layout (and therefore
    ``inv_perm``) is unchanged by the split.
    """

    slabs: list[Slab]
    heavy: list[Slab]
    heavy_owner_pos: list[np.ndarray]   # per group: [R_sub] int32
    inv_perm: np.ndarray                # [n_rows_padded] int32
    n_stat_rows: int                    # rows in the concatenated layout
    n_rows: int
    n_rows_padded: int

    @property
    def padded_nnz(self) -> int:
        total = sum(s.idx.size for s in self.slabs)
        total += sum(h.idx.size for h in self.heavy)
        return total


def _load_alspack():
    """ctypes handle to the native fill pass, built on first use into
    ``build/native/`` by :mod:`~predictionio_tpu_torch.ops._build`
    (which raises when the build fails); None when ``PIO_NO_NATIVE=1``
    asks for the numpy path, which gives identical arrays."""
    if os.environ.get("PIO_NO_NATIVE", "").strip() in ("1", "true"):
        return None
    return _build.library("alspack")


def _fill_flat(rows, cols, vals, off_of_row, total_flat, deg):
    """Scatter every nnz into the combined flat slot buffer.

    ``dest(i) = off_of_row[rows[i]] + occurrence(rows[i])`` — rows keep
    their interactions contiguous in original input order (the same
    order the stable-argsort formulation produced). Native path: one
    sequential O(nnz) pass; numpy fallback: stable argsort to derive
    occurrence indices, then three vectorized scatters.
    """
    flat_idx = np.zeros(total_flat, np.int32)
    flat_w = np.zeros(total_flat, np.float32)
    flat_vd = np.zeros(total_flat, np.float32)
    if len(rows) == 0:
        return flat_idx, flat_w, flat_vd
    lib = _load_alspack()
    if lib is not None:
        c = ctypes
        cursor = np.zeros(len(off_of_row), np.int64)
        off64 = np.ascontiguousarray(off_of_row, np.int64)
        lib.pio_alspack_fill(
            rows.ctypes.data_as(c.POINTER(c.c_int32)),
            cols.ctypes.data_as(c.POINTER(c.c_int32)),
            vals.ctypes.data_as(c.POINTER(c.c_float)),
            c.c_int64(len(rows)),
            off64.ctypes.data_as(c.POINTER(c.c_int64)),
            cursor.ctypes.data_as(c.POINTER(c.c_int64)),
            flat_idx.ctypes.data_as(c.POINTER(c.c_int32)),
            flat_w.ctypes.data_as(c.POINTER(c.c_float)),
            flat_vd.ctypes.data_as(c.POINTER(c.c_float)),
        )
        return flat_idx, flat_w, flat_vd
    order = np.argsort(rows, kind="stable")
    r = rows[order]
    row_start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    occ = np.arange(len(r)) - row_start[r]
    dest = off_of_row[r] + occ
    flat_idx[dest] = cols[order]
    flat_w[dest] = vals[order]
    flat_vd[dest] = 1.0
    return flat_idx, flat_w, flat_vd


def _split_rows(arrays: tuple, rows_per_group: int) -> list[tuple]:
    """Split row-aligned arrays into groups of ≤ ``rows_per_group`` rows
    (host-side; slicing preserves global row order, so stats layouts are
    unaffected)."""
    n = arrays[0].shape[0]
    if n <= rows_per_group:
        return [arrays]
    return [
        tuple(a[i:i + rows_per_group] for a in arrays)
        for i in range(0, n, rows_per_group)
    ]


def build_bucketed(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    block_len: int = 64,
    row_multiple: int = 1,
    s_max: int = 16,
    max_slab_slots: int = 0,
) -> Bucketed:
    """Pack COO → degree-bucketed slabs (vectorized host preprocessing),
    in an ``als/pack`` span of the current trace (attributes: the side's
    ``rows``, ``nnz``, ``heavy_rows``).

    Rows are assigned to buckets of ``s`` blocks (``s`` a power of two,
    ``s ≤ s_max``); a bucket's slab is a dense ``[R_b, s·block_len]``
    array where row ``j`` holds that entity's entire interaction list
    (zero-padded). Rows needing more than ``s_max`` blocks are split
    into sub-rows of width ``s_max·block_len`` in the ``heavy`` slabs.
    No slab exceeds ``max_slab_slots`` (= R·W) slots — the HBM bound on
    the per-slab factor-gather temp (see :class:`Bucketed`).
    """
    with tracing.span("als/pack", rows=int(n_rows),
                      nnz=int(len(rows))) as sp:
        packed = _pack(rows, cols, vals, n_rows, block_len, row_multiple,
                       s_max, max_slab_slots)
        if sp is not None:
            sp.set("heavy_rows", packed.n_stat_rows - sum(
                s.idx.shape[0] for s in packed.slabs))
        return packed


def _pack(rows, cols, vals, n_rows, block_len, row_multiple, s_max,
          max_slab_slots) -> Bucketed:
    """:func:`build_bucketed`'s packing."""
    if block_len < 1 or s_max < 1:
        raise ValueError("block_len and s_max must be ≥ 1")
    max_slab_slots = _resolve_max_slab_slots(max_slab_slots)

    def rows_per_group(width: int) -> int:
        per = max(1, max_slab_slots // width) // row_multiple
        return max(1, per) * row_multiple
    n_rows_padded = max(
        row_multiple, -(-n_rows // row_multiple) * row_multiple
    )
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    deg = np.bincount(rows, minlength=n_rows_padded).astype(np.int64)

    nseg = np.maximum(-(-deg // block_len), 1)
    # bucket size: next power of two ≥ nseg, capped at s_max
    s_of_row = np.minimum(
        2 ** np.ceil(np.log2(nseg)).astype(np.int64), s_max
    )
    is_heavy = nseg > s_max

    bucket_sizes = sorted(int(s) for s in np.unique(s_of_row[~is_heavy]))
    if not bucket_sizes:
        bucket_sizes = [1]

    # Layout planning runs on n_rows-sized arrays (cheap); the only
    # O(nnz) work is ONE fill pass into a combined flat buffer whose
    # slices become the slab views. A row's nnz land contiguously from
    # its flat offset in original input order — for heavy rows too,
    # since their sub-rows are consecutive in the heavy region — so the
    # destination of every nnz is `off[row] + occurrence(row)`, which
    # the native kernel (native/alspack.cc) computes in a single
    # sequential pass (the numpy fallback derives occurrence via a
    # stable argsort).
    inv_perm = np.zeros(n_rows_padded, np.int64)
    row_ids = np.arange(n_rows_padded)
    sizes_arr = np.asarray(bucket_sizes, np.int64)
    widths = sizes_arr * block_len
    reg = ~is_heavy
    bucket_of_row = np.searchsorted(sizes_arr, s_of_row)  # valid where reg
    counts = np.bincount(
        bucket_of_row[reg], minlength=len(bucket_sizes)
    )
    rb_of = np.maximum(
        row_multiple, -(-counts // row_multiple) * row_multiple
    )
    slab_row_base = np.concatenate([[0], np.cumsum(rb_of)[:-1]])
    flat_base = np.concatenate([[0], np.cumsum(rb_of * widths)[:-1]])
    # local index of each member row within its bucket (row-id order —
    # stable sort over the per-row bucket ids preserves ascending ids)
    reg_rows = row_ids[reg]
    reg_buckets = bucket_of_row[reg]
    order = np.argsort(reg_buckets, kind="stable")
    local = np.empty(len(reg_rows), np.int64)
    bucket_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    local[order] = np.arange(len(reg_rows)) - np.repeat(
        bucket_start, counts
    )
    inv_perm[reg_rows] = slab_row_base[reg_buckets] + local
    off_of_row = np.zeros(n_rows_padded, np.int64)
    off_of_row[reg_rows] = (
        flat_base[reg_buckets] + local * widths[reg_buckets]
    )
    regular_flat = int((rb_of * widths).sum())
    offset = int(rb_of.sum())

    # heavy layout: one stats slot per heavy row after all regular rows;
    # sub-rows of width s_max·block_len appended after the regular flats
    heavy_rows = row_ids[is_heavy]
    width_h = s_max * block_len
    rb_h = 0
    n_sub = 0
    nsub_of = None
    if len(heavy_rows):
        inv_perm[heavy_rows] = offset + np.arange(len(heavy_rows))
        nsub_of = -(-deg[heavy_rows] // width_h)
        n_sub = int(nsub_of.sum())
        rb_h = max(
            row_multiple, -(-n_sub // row_multiple) * row_multiple
        )
        sub_base = np.concatenate([[0], np.cumsum(nsub_of)[:-1]])
        off_of_row[heavy_rows] = regular_flat + sub_base * width_h

    total_flat = regular_flat + rb_h * width_h
    flat_idx, flat_w, flat_vd = _fill_flat(
        rows, cols, vals, off_of_row, total_flat, deg
    )

    slabs: list[Slab] = []
    for b, s in enumerate(bucket_sizes):
        width = int(widths[b])
        n_b = int(rb_of[b])
        start = int(flat_base[b])
        end = start + n_b * width
        full = (
            flat_idx[start:end].reshape(n_b, width),
            flat_w[start:end].reshape(n_b, width),
            flat_vd[start:end].reshape(n_b, width),
        )
        for g_idx, g_wt, g_vd in _split_rows(full, rows_per_group(width)):
            slabs.append(Slab(idx=g_idx, weights=g_wt, valid=g_vd))

    heavy: list[Slab] = []
    heavy_owner_pos: list[np.ndarray] = []
    if len(heavy_rows):
        hs = (
            flat_idx[regular_flat:].reshape(rb_h, width_h),
            flat_w[regular_flat:].reshape(rb_h, width_h),
            flat_vd[regular_flat:].reshape(rb_h, width_h),
        )
        owner = np.zeros(rb_h, np.int32)
        owner[:n_sub] = np.repeat(
            inv_perm[heavy_rows], nsub_of
        ).astype(np.int32)
        # phantom sub-rows have zero valid/weights: owner 0 is harmless
        for g_idx, g_wt, g_vd, g_own in _split_rows(
            (*hs, owner), rows_per_group(width_h)
        ):
            heavy.append(Slab(idx=g_idx, weights=g_wt, valid=g_vd))
            heavy_owner_pos.append(g_own)
        offset += len(heavy_rows)

    return Bucketed(
        slabs=slabs,
        heavy=heavy,
        heavy_owner_pos=heavy_owner_pos,
        inv_perm=inv_perm.astype(np.int32),
        n_stat_rows=offset,
        n_rows=n_rows,
        n_rows_padded=n_rows_padded,
    )


# --------------------------------------------------------------------------
# Device-side solve
# --------------------------------------------------------------------------


def _resolve_compute(compute_dtype: str | None) -> torch.dtype | None:
    """Gather/Gramian compute dtype; None = the factors' own (float32).

    ``"bfloat16"``/``"bf16"`` gathers bf16 factors (half the bytes of
    the gather) and upcasts them before the products, so the Gramians
    still accumulate in float32 and the solve stays float32. Empty/None
    falls back to the ``PIO_ALS_COMPUTE_DTYPE`` env knob, then ``auto``,
    which is float32 here as on every backend but the TPU. No float16:
    its 65504 max overflows implicit-mode confidence weights (alpha ×
    counts). Unknown names fail at solver build with the supported list.
    """
    name = (compute_dtype or "").strip().lower()
    if not name:
        name = os.environ.get("PIO_ALS_COMPUTE_DTYPE", "").strip().lower()
    if name in ("", "auto", "float32", "f32"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(
        f"unsupported ALS compute_dtype {name!r}; supported: "
        "auto, float32/f32, bfloat16/bf16"
    )


#: default bound on the per-slab factor-gather temp (in R·W slots)
DEFAULT_MAX_SLAB_SLOTS = 2 << 20


def _resolve_max_slab_slots(value: int) -> int:
    """Slab-size cap: explicit value wins, then the
    ``PIO_ALS_MAX_SLAB_SLOTS`` env knob, then the default."""
    if value:
        if value < 0:
            raise ValueError(
                f"max_slab_slots must be positive, got {value}"
            )
        return value
    raw = os.environ.get("PIO_ALS_MAX_SLAB_SLOTS", "").strip()
    if raw:
        try:
            parsed = int(raw)
        except ValueError as e:
            raise ValueError(
                f"PIO_ALS_MAX_SLAB_SLOTS {raw!r} is not an integer"
            ) from e
        if parsed <= 0:
            raise ValueError(
                f"PIO_ALS_MAX_SLAB_SLOTS must be positive, got {parsed}"
            )
        return parsed
    return DEFAULT_MAX_SLAB_SLOTS


#: counts kept beside a range's host time, summed from shapes on the host:
#: the name in ``als.ranges`` -> its registry counter and help
RANGE_COUNTS = {
    "systems": ("pio_als_solve_systems_total",
                "Systems ALS's batched solve solved under an open trace"),
    "slots": ("pio_als_gramian_slots_total",
              "Slab slots ALS's gather-Gramian summed under an open trace"),
}


class RangeTotals:
    """Host seconds, calls and stream drains per profiler range of a
    half-step (``als/gather_gramian``, ``als/heavy_add``, ``als/solve``,
    never nested in one another), for one trace (kept by
    ``tracing.trace_state``), and the :data:`RANGE_COUNTS` a range
    takes: the systems ``als/solve`` solved and the slab slots
    ``als/gather_gramian`` summed. A *drain* is a range entered with its
    CUDA device's current stream already empty: the card had nothing
    queued and waited for the host. Nothing is counted as a drain on the
    CPU. When the trace's root closes, the totals become its
    ``als.ranges`` attribute (``GET /debug/traces.json``; calls are kept
    there alone) and go once into the process registry:
    ``pio_als_range_host_seconds_total{range}``,
    ``pio_als_solve_systems_total``, ``pio_als_gramian_slots_total``
    and, where a range ran on a CUDA device,
    ``pio_als_stream_drains_total{range}``."""

    def __init__(self):
        #: range -> [host seconds, calls, drains, {count name: total}]
        self.totals: dict[str, list] = {}
        self.cuda = False

    def close(self, root) -> None:
        reg = get_registry()
        host = reg.counter(
            "pio_als_range_host_seconds_total",
            "Host seconds inside ALS's profiler ranges under an open "
            "trace", ("range",))
        drains = reg.counter(
            "pio_als_stream_drains_total",
            "ALS range entries that found the card's stream empty "
            "(the card idle, waiting for the host), under an open trace",
            ("range",))
        out = {}
        for name, (host_s, n, n_drained, counts) in self.totals.items():
            host.labels(name).inc(host_s)
            out[name] = {"host_s": round(host_s, 6), "calls": n}
            if self.cuda:
                drains.labels(name).inc(n_drained)
                out[name]["drains"] = n_drained
            for key, total in counts.items():
                reg.counter(*RANGE_COUNTS[key]).inc(total)
                out[name][key] = total
        root.set("als.ranges", out)


class _CountedRange:
    """One entry of a range under an open trace: the profiler range as
    with none open, and its host seconds, call, drain and counts
    counted."""

    __slots__ = ("_rf", "_row", "_device", "_t0")

    def __init__(self, name: str, device: torch.device, totals: RangeTotals,
                 counts: dict):
        self._rf = torch.profiler.record_function(name)
        row = totals.totals.get(name)
        if row is None:
            row = totals.totals[name] = [0.0, 0, 0, {}]
        for key, n in counts.items():
            row[3][key] = row[3].get(key, 0) + n
        self._row = row
        self._device = device if device.type == "cuda" else None
        if self._device is not None:
            totals.cuda = True

    def __enter__(self):
        if self._device is not None and torch.cuda.current_stream(
                self._device).query():
            self._row[2] += 1
        self._rf.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        self._row[0] += time.perf_counter() - self._t0
        self._row[1] += 1
        return self._rf.__exit__(*exc)


def _range(name: str, device: torch.device, **counts: int):
    """The profiler range ``name`` (what ``torch.profiler`` and the
    benchmark's range metrics see, trace or not), counted in the current
    trace's :class:`RangeTotals` when a trace is open; ``counts``, of
    :data:`RANGE_COUNTS` (the rows a solve takes, the slots a
    gather-Gramian sums), summed from shapes on the host."""
    totals = tracing.trace_state("als.ranges", RangeTotals)
    if totals is None:
        return torch.profiler.record_function(name)
    return _CountedRange(name, device, totals, counts)


def _slab_stats(y, idx, weights, valid, implicit, alpha, compute=None):
    """Per-row normal-equation pieces ``(A [R,k,k], b [R,k], count [R])``
    for one dense slab, in the ``als/gather_gramian`` range (its
    ``slots``, ``R·W``, counted under an open trace). ``y`` arrives
    already cast to ``compute``. A CUDA ``y`` launches the kernel
    (:func:`_slab_stats_kernel`, or raises); a CPU ``y`` takes the plain
    version (:func:`_slab_stats_plain`)."""
    kernel = _build.on_card("_slab_stats", y.device)
    with _range("als/gather_gramian", y.device, slots=idx.numel()):
        if kernel:
            return _slab_stats_kernel(y, idx, weights, valid, implicit,
                                      alpha, compute)
        return _slab_stats_plain(y, idx, weights, valid, implicit, alpha,
                                 compute)


def _slab_stats_plain(y, idx, weights, valid, implicit, alpha,
                      compute=None):
    """The plain version: the k-minor gather ``y[idx]`` then two batched
    products. The gather moves ``compute``'s bytes; the gathered rows
    (and the weights, rounded to ``compute`` as the JAX package rounds
    them) are upcast to float32 before any product, where a product of
    two bf16 values is exact, so only the summation order differs from
    the JAX package."""
    mask = valid  # a real 0-valued explicit rating still counts
    if implicit:
        aw = alpha * weights * mask          # C − I (zero on padding)
        bw = mask + alpha * weights * mask   # c·p on observed
    else:
        aw = mask
        bw = weights * mask
    if compute is not None:
        aw = aw.to(compute).float()
        bw = bw.to(compute).float()
    r, w = idx.shape
    yg = y.index_select(0, idx.reshape(-1)).view(r, w, -1).float()
    a = torch.bmm((yg * aw.unsqueeze(-1)).transpose(1, 2), yg)
    b = torch.bmm(bw.unsqueeze(1), yg).squeeze(1)
    return a, b, mask.sum(dim=1)


def _slab_stats_kernel(y, idx, weights, valid, implicit, alpha, compute):
    """One launch of ``csrc/als_gramian.cu`` on the current stream: the
    three outputs are the only allocations, and nothing waits for the
    card. ``y``'s dtype picks the load (float32 or bf16), ``k`` the
    kernel's tile, ``implicit`` the weights; ``compute`` (bf16) rounds
    them as the plain version does."""
    dev = y.device
    if y.dim() != 2 or not 1 <= y.shape[1] <= SOLVE_MAX_K:
        raise ValueError(f"_slab_stats: rank {list(y.shape)[1:]} is outside "
                         f"the kernel's 1..{SOLVE_MAX_K}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"_slab_stats: y must be float32 or bfloat16, got "
                         f"{y.dtype}")
    if compute not in (None, torch.bfloat16):
        raise ValueError(f"_slab_stats: compute {compute} is neither None "
                         "nor bfloat16")
    if idx.dtype != torch.int32:
        raise ValueError(f"_slab_stats: idx must be int32, got {idx.dtype}")
    if (weights.dtype, valid.dtype) != (torch.float32, torch.float32):
        raise ValueError("_slab_stats: weights and valid must be float32, "
                         f"got {weights.dtype} and {valid.dtype}")
    if idx.dim() != 2 or weights.shape != idx.shape \
            or valid.shape != idx.shape:
        raise ValueError("_slab_stats: idx, weights and valid must share one "
                         f"[R, W] shape, got {list(idx.shape)}, "
                         f"{list(weights.shape)} and {list(valid.shape)}")
    for name, t in (("idx", idx), ("weights", weights), ("valid", valid)):
        if t.device != dev:
            raise ValueError(f"_slab_stats: {name} is on {t.device}, y on "
                             f"{dev}")
    sy = _build.lead_stride(y, "_slab_stats", "y")
    si = _build.lead_stride(idx, "_slab_stats", "idx")
    sw = _build.lead_stride(weights, "_slab_stats", "weights")
    sv = _build.lead_stride(valid, "_slab_stats", "valid")
    (r, w), k = idx.shape, y.shape[1]
    a = torch.empty((r, k, k), dtype=torch.float32, device=dev)
    b = torch.empty((r, k), dtype=torch.float32, device=dev)
    cnt = torch.empty((r,), dtype=torch.float32, device=dev)
    if r == 0:
        return a, b, cnt
    _build.launch(
        "als_gramian", "pio_als_gramian", dev,
        y.data_ptr(), sy, y.shape[0], int(y.dtype == torch.bfloat16),
        idx.data_ptr(), si, weights.data_ptr(), sw, valid.data_ptr(), sv,
        r, w, k, alpha, int(implicit), int(compute is not None),
        a.data_ptr(), b.data_ptr(), cnt.data_ptr(), dev.index)
    _build.count("als_gramian")
    return a, b, cnt


#: the largest rank the kernel solves (its tiles hold K = 32, 64 or 128)
SOLVE_MAX_K = 128


def _solve(a, b, cnt, yty, lam, implicit):
    """Regularize and solve the batch of ``k × k`` systems ``a [R, k,
    k]``, ``b [R, k]`` (implicit: ``(a + yty) + lam·I``; explicit: ``a +
    (lam·max(cnt, 1))·I``): ``x [R, k]`` float32. A system that is not
    positive definite (explicit mode with ``lam=0`` on an empty row,
    say) solves to zeros, as in the JAX package, and any non-finite
    element of ``x`` becomes zero. A CUDA tensor launches the kernel
    (:func:`_solve_kernel`, or raises); a CPU tensor takes the plain
    version (:func:`_solve_plain`)."""
    kernel = _build.on_card("_solve", a.device)
    with _range("als/solve", a.device, systems=a.shape[0]):
        if kernel:
            return _solve_kernel(a, b, cnt, yty, lam, implicit)
        return _solve_plain(a, b, cnt, yty, lam, implicit)


def _solve_plain(a, b, cnt, yty, lam, implicit):
    """The plain version: the regularized systems in memory, then
    ``cholesky_ex``; a system whose info is nonzero solves to zeros,
    whatever ``cholesky_solve`` made of it, as does any non-finite
    element."""
    k = a.shape[-1]
    eye = torch.eye(k, dtype=a.dtype, device=a.device)
    if implicit:
        a = a + yty + lam * eye
    else:
        # MLlib-style weighted-λ regularization: λ · n_u · I
        a = a + (lam * cnt.clamp(min=1.0))[:, None, None] * eye
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(b.unsqueeze(-1), chol).squeeze(-1)
    ok = (info == 0).unsqueeze(-1) & torch.isfinite(x)
    return torch.where(ok, x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _solve_kernel(a, b, cnt, yty, lam, implicit):
    """One launch of ``csrc/als_solve.cu`` on the current stream: the
    output is the one allocation, and nothing waits for the card. Each
    system must be float32 and contiguous (a heavy slot's view of its
    packed row is: only the stride between systems differs)."""
    dev = a.device
    r, k = a.shape[0], a.shape[-1]
    if not 1 <= k <= SOLVE_MAX_K:
        raise ValueError(f"_solve: rank {k} is outside the kernel's "
                         f"1..{SOLVE_MAX_K}")
    x = torch.empty((r, k), dtype=torch.float32, device=dev)
    if r == 0:
        return x
    for name, t, shape in (("a", a, (r, k, k)), ("b", b, (r, k)),
                           ("cnt", cnt, (r,))):
        if t.dtype != torch.float32 or t.shape != shape or t.device != dev:
            raise ValueError(
                f"_solve: {name} must be {list(shape)} float32 on {dev}, "
                f"got {list(t.shape)} {t.dtype} on {t.device}")
    sa = _build.lead_stride(a, "_solve", "a")
    sb = _build.lead_stride(b, "_solve", "b")
    sc = _build.lead_stride(cnt, "_solve", "cnt")
    if implicit and (yty.dtype != torch.float32 or yty.shape != (k, k)
                     or yty.device != dev or not yty.is_contiguous()):
        raise ValueError(f"_solve: yty must be a contiguous [{k}, {k}] "
                         f"float32 tensor on {dev}")
    _build.launch(
        "als_solve", "pio_als_solve", dev,
        a.data_ptr(), sa, b.data_ptr(), sb, cnt.data_ptr(), sc,
        yty.data_ptr() if implicit else None, lam, int(implicit),
        x.data_ptr(), r, k, dev.index)
    _build.count("als_solve")
    return x


def _prepare(y, compute, implicit):
    """``y`` cast once to ``compute`` (before any gather), its float32
    view, and ``YᵀY`` (implicit mode) in float32."""
    if compute is not None:
        y = y.to(compute)
    yf = y.float()
    return y, (yf.T @ yf if implicit else None)


#: the heavy-add kernel's split of a wide slot: one part per this many
#: members of a group's widest slot, at most HEAVY_MAX_PARTS (its blocks
#: of 32 columns × 32 parts)
HEAVY_PART_MEMBERS = 128
HEAVY_MAX_PARTS = 32


@dataclasses.dataclass
class HeavyOrder:
    """The fixed order in which one heavy group's sub-rows add into their
    owners' slots, planned on the host. An owner's sub-rows, in ascending
    row order and padded with zero rows to the next power of two, are
    added pairwise, level by level (``r0+r1``, ``r2+r3``, then those
    sums, ...), and the total is added into its slot. Owners whose
    padded widths are equal form one bucket: one gather of ``[owners,
    width]`` rows and ``log2(width)`` adds, all owners at once, with no
    atomics (the CPU's plain version). A chain ``((r0+r1)+r2)+...``
    would need one dependent add a sub-row: up to a group's whole row
    count, one launch each. The same plan laid flat (``plan``,
    ``members``, ``parts``) is what the card's kernel reads: one launch a
    group."""

    #: per bucket: (slots [S] int64, rows [S * width] int64, width); a
    #: padding row is the group's row count, the zero row appended there
    buckets: list[tuple[torch.Tensor, torch.Tensor, int]]
    #: [slots, 3] int32, one row a slot, bucket after bucket: (slot, padded
    #: width, offset of its members in ``members``)
    plan: torch.Tensor
    #: int32: the buckets' rows laid end to end, the zero row as in them
    members: torch.Tensor
    #: the aligned parts the kernel splits each slot's members into, summed
    #: side by side: one per 128 members of the widest slot, 1 to 32
    parts: int


def heavy_order(owner: np.ndarray, n_regular: int,
                device: torch.device) -> HeavyOrder:
    """Plan :class:`HeavyOrder` for a group whose sub-row ``r`` belongs to
    the stats position ``owner[r]``; positions from ``n_regular`` on are
    heavy slots. Phantom sub-rows (owner 0, below ``n_regular``: zero
    weights) are left out."""
    owner = np.asarray(owner, np.int64)
    local = owner - n_regular
    real = np.nonzero(local >= 0)[0]
    rows = real[np.argsort(local[real], kind="stable")]
    slots, start, count = np.unique(local[rows], return_index=True,
                                    return_counts=True)
    width = 1 << np.ceil(np.log2(np.maximum(count, 1))).astype(np.int64)
    pad = len(owner)
    buckets, sels, mats = [], [], []
    for w in np.unique(width).tolist():
        sel = np.nonzero(width == w)[0]
        mat = np.full((len(sel), w), pad, np.int64)
        for i, o in enumerate(sel.tolist()):
            mat[i, :count[o]] = rows[start[o]:start[o] + count[o]]
        buckets.append((torch.from_numpy(slots[sel]).to(device),
                        torch.from_numpy(mat.reshape(-1)).to(device), w))
        sels.append(sel)
        mats.append(mat.reshape(-1))
    sel = np.concatenate(sels) if sels else np.zeros(0, np.int64)
    plan = np.stack([slots[sel], width[sel],
                     np.cumsum(width[sel]) - width[sel]], axis=1)
    members = np.concatenate(mats) if mats else np.zeros(0, np.int64)
    widest = int(width.max()) if len(width) else 1
    return HeavyOrder(
        buckets=buckets,
        plan=torch.from_numpy(plan.astype(np.int32)).to(device),
        members=torch.from_numpy(members.astype(np.int32)).to(device),
        parts=min(HEAVY_MAX_PARTS, max(1, widest // HEAVY_PART_MEMBERS)))


def _heavy_stats(y, heavy_groups, n_heavy_slots, implicit, alpha, compute):
    """Heavy sub-rows' partial stats summed into their owners' slots:
    ``(A [n_heavy_slots,k,k], b, count)``, views of one packed ``[S, k*k
    + k + 1]`` float32 row a slot. ``heavy_groups`` are ``(idx, weights,
    valid, order)`` with a :class:`HeavyOrder`; each slot gets its
    sub-rows' pairwise sum group after group, with no float atomics, so
    the sums are the same each run. On a CUDA ``y`` each group's sum is
    one launch (:func:`_heavy_add_kernel`, or raises); on a CPU ``y`` the
    plain version (:func:`_heavy_add_plain`): the same adds in the same
    order, so the same bits."""
    k = y.shape[1]
    kernel = _build.on_card("_heavy_stats", y.device)
    acc = torch.zeros((n_heavy_slots, k * k + k + 1), device=y.device)
    for idx, weights, valid, order in heavy_groups:
        ga, gb, gcnt = _slab_stats(y, idx, weights, valid, implicit, alpha,
                                   compute)
        with _range("als/heavy_add", y.device):
            if kernel:
                _heavy_add_kernel(ga, gb, gcnt, order, acc)
            else:
                _heavy_add_plain(ga, gb, gcnt, order, acc)
    return (acc[:, :k * k].reshape(n_heavy_slots, k, k),
            acc[:, k * k:k * k + k], acc[:, -1])


def _heavy_add_plain(ga, gb, gcnt, order, acc):
    """The plain version, into ``acc`` in place: the group's packed stats
    rows and a zero row, then per bucket one gather, ``log2(width)``
    pairwise adds of all its owners at once, and the totals added into
    their slots."""
    g = torch.cat([ga.reshape(ga.shape[0], -1), gb, gcnt[:, None]], dim=1)
    g = torch.cat([g, g.new_zeros((1, g.shape[1]))])
    for slots, rows, width in order.buckets:
        t = g.index_select(0, rows).view(len(slots), width, -1)
        while t.shape[1] > 1:
            t = t[:, 0::2] + t[:, 1::2]
        acc[slots] = acc.index_select(0, slots) + t[:, 0]


def _heavy_add_kernel(ga, gb, gcnt, order, acc):
    """One launch of ``csrc/als_heavy_add.cu`` on the current stream, into
    ``acc`` in place: it reads the gather-Gramian's three outputs where
    they lie and ``order``'s flat plan, allocates nothing and waits for
    nothing. A group with no slot launches nothing."""
    dev = acc.device
    r, k = ga.shape[0], ga.shape[-1]
    if not 1 <= k <= SOLVE_MAX_K:
        raise ValueError(f"_heavy_stats: rank {k} is outside the kernel's "
                         f"1..{SOLVE_MAX_K}")
    for name, t, shape in (("ga", ga, (r, k, k)), ("gb", gb, (r, k)),
                           ("gcnt", gcnt, (r,)),
                           ("acc", acc, (acc.shape[0], k * k + k + 1))):
        if t.dtype != torch.float32 or t.shape != shape or t.device != dev:
            raise ValueError(
                f"_heavy_stats: {name} must be {list(shape)} float32 on "
                f"{dev}, got {list(t.shape)} {t.dtype} on {t.device}")
    plan, members = order.plan, order.members
    for name, t in (("plan", plan), ("members", members)):
        if t.dtype != torch.int32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"_heavy_stats: the order's {name} must be "
                             f"contiguous int32 on {dev}")
    if order.parts not in (1, 2, 4, 8, 16, HEAVY_MAX_PARTS):
        raise ValueError(f"_heavy_stats: the order's parts must be a power "
                         f"of two up to {HEAVY_MAX_PARTS}, got {order.parts}")
    if plan.shape[0] == 0:
        return
    _build.launch(
        "als_heavy_add", "pio_als_heavy_add", dev,
        ga.data_ptr(), _build.lead_stride(ga, "_heavy_stats", "ga"),
        gb.data_ptr(), _build.lead_stride(gb, "_heavy_stats", "gb"),
        gcnt.data_ptr(), _build.lead_stride(gcnt, "_heavy_stats", "gcnt"),
        r, k, plan.data_ptr(), plan.shape[0], members.data_ptr(),
        order.parts, acc.data_ptr(),
        _build.lead_stride(acc, "_heavy_stats", "acc"), dev.index)
    _build.count("als_heavy_add")


def _regular_solve(y, yty, slab_arrays, implicit, alpha, lam, compute):
    """Every slab's systems, each solved as soon as it is built; the
    solved rows concatenated in slab order."""
    parts = []
    for idx, weights, valid in slab_arrays:
        a, b, cnt = _slab_stats(y, idx, weights, valid, implicit, alpha,
                                compute)
        parts.append(_solve(a, b, cnt, yty, lam, implicit))
    return torch.cat(parts, dim=0)


def _assemble_and_solve(
    y, slab_arrays, heavy_groups, n_heavy_slots, implicit, alpha, lam,
    compute=None,
):
    """One direction's solve in the concatenated stats layout: each
    slab's systems are solved as soon as they are built (only ``[R, k]``
    rows survive, never the whole ``[n_stat_rows, k, k]``); heavy
    sub-rows add their partial stats into a small ``[n_heavy_slots, k,
    k]`` buffer in a fixed order, solved last. ``heavy_groups`` are
    ``(idx, weights, valid, order)`` with a :class:`HeavyOrder`."""
    y, yty = _prepare(y, compute, implicit)
    x = _regular_solve(y, yty, slab_arrays, implicit, alpha, lam, compute)
    if not n_heavy_slots:
        return x
    ha, hb, hcnt = _heavy_stats(y, heavy_groups, n_heavy_slots, implicit,
                                alpha, compute)
    return torch.cat([x, _solve(ha, hb, hcnt, yty, lam, implicit)], dim=0)


def make_solve_side(
    ctx: ComputeContext,
    packed: Bucketed,
    implicit: bool,
    alpha: float,
    compute_dtype: str | None = None,
) -> Callable[[torch.Tensor, float], torch.Tensor]:
    """Copy one direction's slabs to ``ctx.device`` once and return its
    half-step, ``(y [I_padded, k], lam) → x [n_rows_padded, k]`` on
    ``ctx.device``. Slab indices stay int32; owners and ``inv_perm``
    become int64. Nothing waits for the card: the caller synchronises
    where it needs the values. The copy is an ``als/stage`` span."""
    compute = _resolve_compute(compute_dtype)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)

    with tracing.span("als/stage", rows=packed.n_rows):
        slabs = [(put(s.idx), put(s.weights), put(s.valid))
                 for s in packed.slabs]
        n_regular = sum(s.idx.shape[0] for s in packed.slabs)
        heavy = [
            (put(h.idx), put(h.weights), put(h.valid),
             heavy_order(owner, n_regular, ctx.device))
            for h, owner in zip(packed.heavy, packed.heavy_owner_pos)
        ]
        n_heavy_slots = packed.n_stat_rows - n_regular
        inv_perm = put(packed.inv_perm.astype(np.int64))

    def solve(y: torch.Tensor, lam: float) -> torch.Tensor:
        x_stats = _assemble_and_solve(
            y, slabs, heavy, n_heavy_slots, implicit, alpha, lam, compute,
        )
        return x_stats.index_select(0, inv_perm)

    return solve


def make_train_step(solve_u, solve_i, timer=None):
    """The epoch loop: ``(x, y, lam, n_iters) → (x, y)``, a user
    half-step then an item half-step per epoch, all enqueued without a
    wait. With a ``timer`` each half-step is one of its steps,
    ``als/user_solve`` and ``als/item_solve``; a
    :class:`~predictionio_tpu_torch.utils.profiling.StepTimer` on a CUDA
    device times them with events and waits for nothing."""
    step = timer.step if timer is not None else contextlib.nullcontext

    def run(x, y, lam, n_iters):
        for _ in range(n_iters):
            with step("als/user_solve"):
                x = solve_u(y, lam)
            with step("als/item_solve"):
                y = solve_i(x, lam)
        return x, y

    return run


# --------------------------------------------------------------------------
# More than one device: the replicated layout over ``data`` and the
# model-sharded layout
# --------------------------------------------------------------------------
#
# Each mesh position solves its share of the stats rows through
# ``_assemble_and_solve`` (a plain loop over the positions: logical
# devices on one card take turns); the solved rows meet on the home
# device, across processes through ``distributed.all_gather_cat``.


def _slab_tree(slabs) -> list[dict]:
    """Slabs as a named tree: the leaf paths (``slabs/0/idx``) are what
    the partition-rule regexes match against."""
    return [{"idx": s.idx, "weights": s.weights, "valid": s.valid}
            for s in slabs]


def _slab_tuples(tree: list[dict]) -> tuple:
    return tuple((d["idx"], d["weights"], d["valid"]) for d in tree)


def _at(arrays, pos: int) -> tuple:
    return tuple(a.shards[pos] for a in arrays)


def _heavy_at(group, pos: int) -> tuple:
    """One heavy group's ``(idx, weights, valid, order)`` at ``pos``."""
    *arrays, orders = group
    return (*_at(arrays, pos), orders[pos])


def _orders_at(owner: ShardedTensor, host: np.ndarray,
               n_regular: int) -> dict:
    """Position → :class:`HeavyOrder` of the sub-rows it holds, planned
    from the host copy of the placed ``owner`` column."""
    out, made = {}, {}
    for pos in owner.mesh.local:
        rows = owner.sharding.block(pos, owner.shape)[0]
        dev = owner.mesh.device(pos)
        key = (rows.start, rows.stop, dev)
        if key not in made:
            made[key] = heavy_order(host[rows], n_regular, dev)
        out[pos] = made[key]
    return out


def _device_slabs(ctx: ComputeContext, packed: Bucketed):
    """Stage the replicated-factor geometry per the ALS rule table: slab
    rows (and the heavy owners with their sub-rows) split over
    ``data``; each heavy group carries its positions' summing orders."""
    owners = [owner.astype(np.int64) for owner in packed.heavy_owner_pos]
    placed = partition.shard_pytree(ctx, partition.ALS_REPLICATED_RULES, {
        "slabs": _slab_tree(packed.slabs),
        "heavy": [
            {"idx": h.idx, "weights": h.weights, "valid": h.valid,
             "owner": owner}
            for h, owner in zip(packed.heavy, owners)
        ],
    })
    n_regular = sum(s.idx.shape[0] for s in packed.slabs)
    heavy = tuple((d["idx"], d["weights"], d["valid"],
                   _orders_at(d["owner"], owner, n_regular))
                  for d, owner in zip(placed["heavy"], owners))
    return _slab_tuples(placed["slabs"]), heavy


def _split_layout(packed: Bucketed, n_shards: int):
    """Where each regular stats row lands when every slab's rows split
    into ``n_shards`` equal parts gathered shard-major: ``(c_slab, n
    slab rows, layout position of each regular entity, mask of regular
    entities)``."""
    rbs = [s.idx.shape[0] for s in packed.slabs]
    per = []
    for rb in rbs:
        if rb % n_shards:
            raise ValueError(
                "slab rows not divisible by n_shards; "
                "build_bucketed with row_multiple=n_shards"
            )
        per.append(rb // n_shards)
    c_slab = int(sum(per))
    n_slab_rows = int(sum(rbs))
    slab_ends = np.cumsum(rbs)
    offsets_global = np.concatenate([[0], slab_ends[:-1]])
    local_off = np.concatenate([[0], np.cumsum(per)[:-1]]).astype(np.int64)
    per_arr = np.asarray(per, np.int64)
    inv = packed.inv_perm.astype(np.int64)
    is_reg = inv < n_slab_rows
    pos = inv[is_reg]
    slab_of = np.searchsorted(slab_ends, pos, side="right")
    j = pos - offsets_global[slab_of]
    shard = j // per_arr[slab_of]
    local = local_off[slab_of] + (j % per_arr[slab_of])
    return c_slab, n_slab_rows, shard * c_slab + local, is_reg


def make_replicated_half_step(
    ctx: ComputeContext,
    packed: Bucketed,
    implicit: bool,
    alpha: float,
    compute_dtype: str | None = None,
) -> Callable[[torch.Tensor, float], torch.Tensor]:
    """The replicated layout over more than one device (or process):
    slab rows split over ``data``, each position solving its rows;
    heavy owners' partial stats summed over ``data`` in order and solved
    on the home device; the solved rows all-gathered into the factor
    matrix, ``(y [I_padded, k] on ctx.device, lam) → x`` there."""
    compute = _resolve_compute(compute_dtype)
    with tracing.span("als/stage", rows=packed.n_rows):
        slabs, heavy = _device_slabs(ctx, packed)
    d = max(ctx.data_parallelism, 1)
    c_slab, n_slab_rows, reg_pos, is_reg = _split_layout(packed, d)
    inv = packed.inv_perm.astype(np.int64).copy()
    inv[is_reg] = reg_pos
    inv[~is_reg] = d * c_slab + (inv[~is_reg] - n_slab_rows)
    home = ctx.device
    inv = torch.from_numpy(inv).to(home)
    n_heavy = packed.n_stat_rows - n_slab_rows
    mesh = ctx.mesh
    # one position per data index (model index 0), in data order: only
    # these solve; the other positions hold the same data slice and send
    # zeros, so every process gathers equal shapes
    leads = [p for p in range(mesh.size)
             if mesh.coords(p).get(MODEL_AXIS, 0) == 0]
    lead = torch.tensor(leads)
    solves = set(leads)

    def solve(y: torch.Tensor, lam: float) -> torch.Tensor:
        k = y.shape[1]
        ys = ctx.on_each(y)
        regs, parts = [], []
        for pos in mesh.local:
            if pos not in solves:
                regs.append(torch.zeros((c_slab, k), device=home))
                if n_heavy:
                    parts.append(torch.zeros((n_heavy, k * k + k + 1),
                                             device=home))
                continue
            yd, yty = _prepare(ys[mesh.device(pos)], compute, implicit)
            regs.append(_regular_solve(
                yd, yty, [_at(s, pos) for s in slabs], implicit, alpha,
                lam, compute).to(home))
            if n_heavy:
                ha, hb, hcnt = _heavy_stats(
                    yd, [_heavy_at(h, pos) for h in heavy], n_heavy,
                    implicit, alpha, compute)
                parts.append(torch.cat(
                    [ha.reshape(n_heavy, -1), hb, hcnt[:, None]],
                    dim=1).to(home))
        every = distributed.all_gather_cat(torch.stack(regs))
        x = [every.index_select(0, lead.to(home)).reshape(-1, k)]
        if n_heavy:
            summed = distributed.all_gather_cat(torch.stack(parts))
            summed = summed.index_select(0, lead.to(home))
            total = summed[0]
            for more in summed[1:]:
                total = total + more
            yh, yty = _prepare(y.to(home), compute, implicit)
            x.append(_solve(total[:, :k * k].reshape(n_heavy, k, k),
                            total[:, k * k:k * k + k], total[:, -1], yty,
                            lam, implicit))
        return torch.cat(x, dim=0).index_select(0, inv)

    return solve


@dataclasses.dataclass
class ShardPlan:
    """Device-major layout for one solve direction in sharded mode.

    Each slab is row-split over the combined (data, model) axes, so the
    gathered stats layout is device-major: device ``i`` holds rows
    ``[i*c_local, (i+1)*c_local)``. ``inv_perm_dm`` re-expresses
    :attr:`Bucketed.inv_perm` in that layout. Heavy sub-rows are
    regrouped so every sub-row's owner slot lives on the same device
    (``heavy_owner_local`` is a device-local stats position), which
    keeps the heavy sums device-local.
    """

    heavy: Slab | None                    # regrouped per-shard heavy slab
    heavy_owner_local: np.ndarray | None  # [rows] int32 — local stats pos
    inv_perm_dm: np.ndarray               # [n_rows_padded] int32
    c_local: int                          # stats rows per device
    n_heavy_slots_local: int              # heavy stat slots per device
    n_shards: int


def plan_shards(packed: Bucketed, n_shards: int) -> ShardPlan:
    """Host-side layout planning for the model-sharded solver (the JAX
    package's, to the row)."""
    c_slab, n_slab_rows, reg_pos, is_reg = _split_layout(packed, n_shards)

    heavy_out = None
    owner_local = None
    h_slots_per = 0
    slot_local: dict[int, tuple[int, int]] = {}
    heavy = None
    if packed.heavy:
        # regrouping is by owner anyway: merge the slot-capped groups
        # back into one host-side slab first
        heavy = Slab(
            idx=np.concatenate([h.idx for h in packed.heavy]),
            weights=np.concatenate([h.weights for h in packed.heavy]),
            valid=np.concatenate([h.valid for h in packed.heavy]),
        )
        owner_all = np.concatenate(packed.heavy_owner_pos)
    if heavy is not None:
        real = heavy.valid.any(axis=1)
        real_rows = np.nonzero(real)[0]
        owners_glob = owner_all[real_rows].astype(np.int64)
        slots, slot_counts = np.unique(owners_glob, return_counts=True)
        # greedy balance: heaviest slot first onto the lightest shard
        shard_sub = np.zeros(n_shards, np.int64)
        shard_slots: list[list[int]] = [[] for _ in range(n_shards)]
        for t in np.argsort(-slot_counts):
            i = int(np.argmin(shard_sub))
            shard_sub[i] += slot_counts[t]
            shard_slots[i].append(int(slots[t]))
        h_slots_per = max(len(s) for s in shard_slots)
        rb_h_per = int(shard_sub.max())
        width = heavy.idx.shape[1]
        h_idx = np.zeros((n_shards * rb_h_per, width), np.int32)
        h_wt = np.zeros((n_shards * rb_h_per, width), np.float32)
        h_vd = np.zeros((n_shards * rb_h_per, width), np.float32)
        owner_local = np.zeros(n_shards * rb_h_per, np.int32)
        for i in range(n_shards):
            fill = 0
            for t_local, slot in enumerate(shard_slots[i]):
                slot_local[slot] = (i, t_local)
                rows_sel = real_rows[owners_glob == slot]
                n = len(rows_sel)
                dst = i * rb_h_per + fill
                h_idx[dst:dst + n] = heavy.idx[rows_sel]
                h_wt[dst:dst + n] = heavy.weights[rows_sel]
                h_vd[dst:dst + n] = heavy.valid[rows_sel]
                owner_local[dst:dst + n] = c_slab + t_local
                fill += n
        heavy_out = Slab(idx=h_idx, weights=h_wt, valid=h_vd)
    c_local = c_slab + h_slots_per

    inv = packed.inv_perm.astype(np.int64)
    inv_dm = np.zeros_like(inv)
    # the regular rows' (shard, local) positions, rebased onto c_local
    shard, local = np.divmod(reg_pos, c_slab)
    inv_dm[is_reg] = shard * c_local + local
    for e in np.nonzero(~is_reg)[0]:
        i, t_local = slot_local[int(inv[e])]
        inv_dm[e] = i * c_local + c_slab + t_local
    return ShardPlan(
        heavy=heavy_out,
        heavy_owner_local=owner_local,
        inv_perm_dm=inv_dm.astype(np.int32),
        c_local=c_local,
        n_heavy_slots_local=h_slots_per,
        n_shards=n_shards,
    )


@dataclasses.dataclass
class ShardedSide:
    """Device-staged arrays for one solve direction (sharded mode)."""

    slabs: tuple            # ((idx, weights, valid), ...) — P((data,model))
    heavy: tuple            # () or (idx, weights, valid, {pos: order})
    inv: ShardedTensor      # [n_rows_padded] int64 — P(model)
    n_heavy_slots_local: int


def stage_sharded(
    ctx: ComputeContext, packed: Bucketed, plan: ShardPlan
) -> ShardedSide:
    """Stage one direction's sharded geometry per the ALS rule table
    (``partition.ALS_SHARDED_RULES``): slab rows split over the combined
    (data, model) axes, the heavy owner map with its slab, the
    device-major permutation over ``model``, in an ``als/stage`` span.
    The rules' axes are checked against the mesh here."""
    with tracing.span("als/stage", rows=packed.n_rows):
        return _stage_sharded(ctx, packed, plan)


def _stage_sharded(ctx, packed, plan) -> ShardedSide:
    tree: dict = {"slabs": _slab_tree(packed.slabs)}
    if plan.heavy is not None:
        tree["heavy"] = {
            "idx": plan.heavy.idx,
            "weights": plan.heavy.weights,
            "valid": plan.heavy.valid,
            "owner": plan.heavy_owner_local.astype(np.int64),
        }
    tree["inv_perm"] = plan.inv_perm_dm.astype(np.int64)
    placed = partition.shard_pytree(ctx, partition.ALS_SHARDED_RULES, tree)
    heavy: tuple = ()
    if plan.heavy is not None:
        h = placed["heavy"]
        heavy = (h["idx"], h["weights"], h["valid"], _orders_at(
            h["owner"], plan.heavy_owner_local.astype(np.int64),
            plan.c_local - plan.n_heavy_slots_local))
    return ShardedSide(
        slabs=_slab_tuples(placed["slabs"]),
        heavy=heavy,
        inv=placed["inv_perm"],
        n_heavy_slots_local=plan.n_heavy_slots_local,
    )


def _factor_sharding(ctx: ComputeContext):
    return ctx.sharding(*partition.match_partition_rule(
        partition.ALS_SHARDED_RULES, "user_factors"))


def _gather_full(ctx: ComputeContext, y: ShardedTensor, compute) -> dict:
    """The opposite side's model shards, cast to ``compute`` first (the
    all-gather then moves low-precision bytes), gathered whole onto
    every local device: device → ``[I_padded, k]``."""
    if compute is not None:
        y = y.map(lambda t: t.to(compute))
    return ctx.on_each(y.gather())


def _sharded_half(
    ctx: ComputeContext, y_full: dict, side: ShardedSide, implicit, alpha,
    lam, compute=None,
) -> ShardedTensor:
    """One solve direction, per mesh position: each solves its share of
    the (data×model)-split stats rows against the whole opposite side
    (``y_full``, device → tensor), heavy owners device-local by
    construction (:class:`ShardPlan`). The solved rows are gathered
    device-major — ``model`` minor, ``data`` major, the flat mesh order —
    and each position takes its model shard's rows through
    ``inv_perm_dm``."""
    mesh = ctx.mesh
    home = ctx.device
    stats = []
    for pos in mesh.local:
        heavy = [_heavy_at(side.heavy, pos)] if side.heavy else []
        stats.append(_assemble_and_solve(
            y_full[mesh.device(pos)], [_at(s, pos) for s in side.slabs],
            heavy, side.n_heavy_slots_local, implicit, alpha, lam, compute,
        ).to(home))
    k = stats[0].shape[1]
    xs = distributed.all_gather_cat(torch.stack(stats)).reshape(-1, k)
    shards: list = [None] * mesh.size
    made: dict = {}
    for pos in mesh.local:
        inv = side.inv.shards[pos]
        key = (id(inv), mesh.device(pos))
        if key not in made:
            made[key] = xs.index_select(0, inv.to(home)).to(key[1])
        shards[pos] = made[key]
    return ShardedTensor(_factor_sharding(ctx), (side.inv.shape[0], k),
                         shards)


def make_sharded_half_step(
    ctx: ComputeContext, side: ShardedSide, implicit: bool, alpha: float,
    compute_dtype: str | None = None,
):
    """Single-direction sharded solve: ``(y, lam) → x`` (both
    ``P(model)`` :class:`ShardedTensor`)."""
    compute = _resolve_compute(compute_dtype)

    def solve_once(y: ShardedTensor, lam: float) -> ShardedTensor:
        return _sharded_half(ctx, _gather_full(ctx, y, compute), side,
                             implicit, alpha, lam, compute)

    return solve_once


def make_sharded_train_step(
    ctx: ComputeContext,
    u_side: ShardedSide,
    i_side: ShardedSide,
    implicit: bool,
    alpha: float,
    compute_dtype: str | None = None,
):
    """The epoch loop with model-sharded factors: ``(x, y, lam, n_iters)
    → (x, y)``, each a ``P(model)`` :class:`ShardedTensor` whose
    positions hold a ``1/model_parallelism`` row slice."""
    solve_u = make_sharded_half_step(ctx, u_side, implicit, alpha,
                                     compute_dtype)
    solve_i = make_sharded_half_step(ctx, i_side, implicit, alpha,
                                     compute_dtype)
    return make_train_step(solve_u, solve_i)


def check_factor_sharding(
    ctx: ComputeContext,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_users: int,
    n_items: int,
    rank: int = 8,
    block_len: int = 8,
) -> None:
    """Validation probe: run one sharded training step and assert the
    factor matrices are genuinely split over the model axis — each
    position holds exactly a ``1/model_parallelism`` row slice, not a
    replicated copy."""
    n_dev = ctx.n_devices
    up = build_bucketed(rows, cols, vals, n_users, block_len=block_len,
                        row_multiple=n_dev)
    ip = build_bucketed(cols, rows, vals, n_items, block_len=block_len,
                        row_multiple=n_dev)
    u_side = stage_sharded(ctx, up, plan_shards(up, n_dev))
    i_side = stage_sharded(ctx, ip, plan_shards(ip, n_dev))
    run = make_sharded_train_step(ctx, u_side, i_side, True, 1.0)
    place = _factor_sharding(ctx)
    x = place.place(np.zeros((up.n_rows_padded, rank), np.float32))
    y = place.place(np.ones((ip.n_rows_padded, rank), np.float32))
    x, y = run(x, y, 0.1, 1)
    m_par = max(ctx.model_parallelism, 1)
    for arr, n_pad in ((x, up.n_rows_padded), (y, ip.n_rows_padded)):
        shard_rows = {s.shape[0] for s in arr.addressable_shards}
        if shard_rows != {n_pad // m_par}:
            raise AssertionError(
                f"factors not model-sharded: shard rows {shard_rows}, "
                f"expected {{{n_pad // m_par}}}"
            )


# --------------------------------------------------------------------------
# Training loop
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ALSFactors:
    """Trained factor matrices.

    Host layout (default): unpadded numpy, ``[n_users, k]`` /
    ``[n_items, k]``. Device layout (``train_als(...,
    return_layout="device")``): the padded tensors on ``ctx.device`` as
    the epoch loop left them; ``n_users`` / ``n_items`` give the real row
    counts, rows past them are exact-zero phantoms (asserted before
    return).
    """

    user_factors: np.ndarray | torch.Tensor
    item_factors: np.ndarray | torch.Tensor
    n_users: int = 0
    n_items: int = 0


def _train_chaos_sleep_s() -> float:
    """Training-side chaos knob: ``PIO_TRAIN_CHAOS=epoch_sleep:<seconds>``
    sleeps on the host before each epoch dispatch (each chunk of
    ``checkpoint_every`` epochs, or each timed epoch), so a kill in the
    middle of a training run has a deterministic window to land in. Parsed
    as the JAX package parses it; unset or garbage → 0."""
    raw = os.environ.get("PIO_TRAIN_CHAOS", "").strip()
    for part in raw.split(";"):
        key, _, value = part.partition(":")
        if key.strip() == "epoch_sleep":
            try:
                return max(0.0, float(value))
            except ValueError:
                return 0.0
    return 0.0


def _cold_init(n_items: int, rank: int, seed: int, dtype) -> np.ndarray:
    """Item factors before the first epoch: normal draws from a
    ``torch.Generator`` seeded with ``seed``, on the CPU (so the same on
    every card), scaled by ``1/sqrt(rank)``. The JAX package draws with
    ``jax.random``, which cannot be reproduced; start both from one
    checkpoint to compare them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    init = torch.randn((n_items, rank), generator=g, dtype=dtype)
    return (init * (1.0 / math.sqrt(rank))).numpy()


def train_als(
    ctx: ComputeContext | None,
    user_ids: np.ndarray,
    item_ids: np.ndarray,
    values: np.ndarray,
    n_users: int,
    n_items: int,
    rank: int = 32,
    iterations: int = 10,
    reg: float = 0.01,
    alpha: float = 1.0,
    implicit: bool = True,
    seed: int = 13,
    block_len: int = 64,
    row_chunk: int = 1024,
    s_max: int = 16,
    max_slab_slots: int = 0,
    compute_dtype: str | None = None,
    dtype=torch.float32,
    timer=None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    factor_sharding: str = "auto",
    return_layout: str = "host",
) -> ALSFactors:
    """Alternate user/item normal-equation solves on ``ctx``'s mesh.

    The signature and defaults are the JAX package's. ``ctx=None`` takes
    the CUDA cards and raises without one: training never drops quietly
    to the CPU (pass ``ComputeContext.create(device="cpu")`` for that).
    Epochs are enqueued without a wait, in one loop whether timed or
    not: a ``timer`` (anything with a ``step(name)`` context manager,
    such as :class:`~predictionio_tpu_torch.utils.profiling.StepTimer`)
    times each half-step, a StepTimer on a CUDA device between CUDA
    events that it reads (its ``resolve``) after the closing fetch. With
    ``checkpoint_dir`` + ``checkpoint_every`` the factors are written
    every N iterations (atomic npz: ``iteration``, ``item_factors``,
    ``user_factors``; the coordinator process writes), and
    ``resume=True`` continues from the latest checkpoint whose shapes
    match and whose iteration is at most ``iterations`` (across
    processes, the coordinator's view); a damaged checkpoint means a
    cold start. ``row_chunk`` is kept for call compatibility.

    ``compute_dtype`` ("bfloat16") gathers bf16 factors; products,
    sums and the solve stay float32. ``factor_sharding``: "replicated"
    keeps both factor matrices whole (slab rows split over ``data``
    when the mesh has more than one device); "sharded" splits them over
    ``model`` with the stats rows split over every device; "auto" picks
    "sharded" when the model axis is above 1. ``return_layout`` "host"
    returns unpadded numpy; "device" the padded factors as trained (a
    ``P(model)`` :class:`ShardedTensor` when sharded, else one tensor on
    ``ctx.device``), single-process only.
    """
    del row_chunk
    if factor_sharding not in ("auto", "sharded", "replicated"):
        raise ValueError(
            f"factor_sharding must be 'auto', 'sharded' or 'replicated', "
            f"got {factor_sharding!r}"
        )
    if return_layout not in ("host", "device"):
        raise ValueError(
            f"return_layout must be 'host' or 'device', "
            f"got {return_layout!r}"
        )
    if return_layout == "device" and distributed.process_count() > 1:
        raise NotImplementedError(
            "return_layout='device' is single-process only (other "
            "processes' shards are not addressable here); use the "
            "default host layout on multi-process meshes"
        )
    ctx = ctx or ComputeContext.create(batch="als")
    sharded = factor_sharding == "sharded" or (
        factor_sharding == "auto" and ctx.model_parallelism > 1
    )
    # one device, one process: the single-card path, no gathers
    alone = ctx.n_devices == 1 and not distributed.is_initialized()
    row_multiple = ctx.n_devices if sharded else ctx.data_parallelism

    user_packed = build_bucketed(
        user_ids, item_ids, values, n_users,
        block_len=block_len, row_multiple=row_multiple, s_max=s_max,
        max_slab_slots=max_slab_slots,
    )
    item_packed = build_bucketed(
        item_ids, user_ids, values, n_items,
        block_len=block_len, row_multiple=row_multiple, s_max=s_max,
        max_slab_slots=max_slab_slots,
    )

    init = _cold_init(n_items, rank, seed, dtype)
    start_iteration = 0
    ckpt_path = checkpoint_path(checkpoint_dir) if checkpoint_dir else None
    resumed_user_factors = None
    if resume and ckpt_path and os.path.exists(ckpt_path):
        try:
            with np.load(ckpt_path) as ckpt:
                if (
                    ckpt["item_factors"].shape == (n_items, rank)
                    and ckpt["user_factors"].shape == (n_users, rank)
                    and int(ckpt["iteration"]) <= iterations
                ):
                    init = ckpt["item_factors"]
                    start_iteration = int(ckpt["iteration"])
                    resumed_user_factors = ckpt["user_factors"]
                    logger.info(
                        "resuming ALS from checkpoint at iteration %d",
                        start_iteration,
                    )
        except Exception as e:  # noqa: BLE001 - damaged ckpt = cold start
            # np.load raises BadZipFile (not OSError) on a truncated npz
            logger.warning(
                "checkpoint %s unreadable (%s); training from scratch",
                ckpt_path, e,
            )
            start_iteration = 0
            resumed_user_factors = None
    if resume and ckpt_path and distributed.process_count() > 1:
        # the coordinator writes checkpoints; with a host-local
        # checkpoint_dir the others see no file. Its view is broadcast
        # and wins: divergent resume points would mean divergent
        # collective schedules (a deadlock)
        have = resumed_user_factors is not None
        state = distributed.broadcast_array(
            np.array([int(have), start_iteration], np.int64))
        if int(state[0]):
            base = np.asarray(init).dtype
            init = distributed.broadcast_array(
                np.asarray(init, base) if have
                else np.zeros((n_items, rank), base))
            resumed_user_factors = distributed.broadcast_array(
                np.asarray(resumed_user_factors, base) if have
                else np.zeros((n_users, rank), base))
            start_iteration = int(state[1])
        else:
            init = _cold_init(n_items, rank, seed, dtype)
            start_iteration = 0
            resumed_user_factors = None
    np_dtype = np.asarray(init).dtype
    # phantom rows start (and, with no interactions, stay) exactly zero
    item_host = np.zeros((item_packed.n_rows_padded, rank), np_dtype)
    item_host[:n_items] = init
    user_host = np.zeros((user_packed.n_rows_padded, rank), np_dtype)
    # the factors' placement comes from the rule table that stages the
    # geometry: P(model) row slices when sharded, else whole (one tensor
    # on the home device that every position reads)
    rules = partition.als_partition_rules(sharded)
    partition.validate_rules(rules, ctx.mesh)
    factor_place = ctx.sharding(
        *partition.match_partition_rule(rules, "item_factors"))

    def place(host: np.ndarray):
        if sharded:
            return factor_place.place(host)
        return torch.from_numpy(host).to(ctx.device)

    def fetch(arr) -> np.ndarray:
        """Host copy of the whole factor matrix (a collective when the
        process group is up: every process calls it)."""
        if isinstance(arr, ShardedTensor):
            arr = arr.gather()
        return arr.cpu().numpy()

    item_factors = place(item_host)
    user_factors = place(user_host)
    lam = float(reg)

    if sharded:
        u_side = stage_sharded(
            ctx, user_packed, plan_shards(user_packed, ctx.n_devices))
        i_side = stage_sharded(
            ctx, item_packed, plan_shards(item_packed, ctx.n_devices))
        solve_u = make_sharded_half_step(ctx, u_side, implicit, alpha,
                                         compute_dtype)
        solve_i = make_sharded_half_step(ctx, i_side, implicit, alpha,
                                         compute_dtype)
    else:
        make = make_solve_side if alone else make_replicated_half_step
        solve_u = make(ctx, user_packed, implicit, alpha, compute_dtype)
        solve_i = make(ctx, item_packed, implicit, alpha, compute_dtype)
    step = make_train_step(solve_u, solve_i, timer)

    ran_any = False
    # between epochs on the host, never inside a timed device window
    chaos_sleep = _train_chaos_sleep_s()
    checkpointing = bool(ckpt_path) and checkpoint_every > 0
    it = start_iteration
    with steps_on(ctx.device):
        while it < iterations:
            # chunk boundaries at absolute multiples of checkpoint_every,
            # so a resume from a foreign iteration count stays on schedule
            if checkpointing:
                n = min(checkpoint_every - it % checkpoint_every,
                        iterations - it)
            else:
                n = iterations - it
            if chaos_sleep:
                time.sleep(chaos_sleep)
            user_factors, item_factors = step(user_factors, item_factors,
                                              lam, n)
            it += n
            ran_any = True
            _maybe_checkpoint(
                ckpt_path, checkpoint_every, it, iterations,
                user_factors, item_factors, n_users, n_items, fetch,
            )

    if not ran_any:
        # the loop never ran (iterations == 0, or a resume at the full
        # count): the checkpointed user factors if any, else one solve
        if resumed_user_factors is not None:
            padded_u = np.zeros(
                (user_packed.n_rows_padded, rank),
                np.asarray(resumed_user_factors).dtype,
            )
            padded_u[:n_users] = resumed_user_factors[:n_users]
            user_factors = place(padded_u)
        else:
            user_factors = solve_u(item_factors, lam)
    with tracing.span("als/fetch"):
        if return_layout == "device":
            # one process holds every shard here: fetch only the padded
            # tails
            assert_phantom_rows_zero(
                _tail_rows(user_factors, n_users), 0, "user factors")
            assert_phantom_rows_zero(
                _tail_rows(item_factors, n_items), 0, "item factors")
        else:
            user_factors = fetch(user_factors)
            item_factors = fetch(item_factors)
            assert_phantom_rows_zero(user_factors, n_users, "user factors")
            assert_phantom_rows_zero(item_factors, n_items, "item factors")
            user_factors = user_factors[:n_users]
            item_factors = item_factors[:n_items]
    resolve = getattr(timer, "resolve", None)
    if resolve is not None:
        resolve()
    return ALSFactors(
        user_factors=user_factors,
        item_factors=item_factors,
        n_users=n_users,
        n_items=n_items,
    )


def _tail_rows(arr, n: int) -> torch.Tensor:
    """Rows ``n:`` of a factor matrix, taken only from the row blocks
    that hold them."""
    if not isinstance(arr, ShardedTensor):
        return arr[n:]
    home = arr.device
    parts = [block[max(0, n - start):].to(home)
             for start, block, _ in arr.row_shards()
             if start + block.shape[0] > n]
    return torch.cat(parts) if parts else arr.local_shards()[0][:0]


def _maybe_checkpoint(
    ckpt_path, checkpoint_every, iteration, total,
    user_factors, item_factors, n_users, n_items, fetch,
) -> None:
    if (
        ckpt_path
        and checkpoint_every > 0
        and iteration % checkpoint_every == 0
        and iteration < total
    ):
        # fetch is the collective (every process runs it); the write is
        # the coordinator's alone: N processes racing os.replace on one
        # shared path would corrupt the checkpoint
        items = fetch(item_factors)
        users = fetch(user_factors)
        if not distributed.is_coordinator():
            return
        # the checkpoint is a span of the training trace and a count in
        # the registry (the restore points a trainer has banked)
        with tracing.span(
            "als/checkpoint", iteration=iteration, total=total
        ):
            _write_checkpoint(
                ckpt_path,
                iteration=iteration,
                item_factors=items[:n_items],
                user_factors=users[:n_users],
            )
        get_registry().counter(
            "pio_train_checkpoints_total",
            "Mid-training factor checkpoints written (atomic npz; "
            "resume picks up the latest after a crash)",
        ).inc()


def _write_checkpoint(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"  # the .npz suffix keeps np.savez from renaming
    np.savez(tmp, **arrays)
    # fsync before the rename: a restore point lost on power loss is none
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)


def checkpoint_path(checkpoint_dir: str) -> str:
    """The checkpoint file :func:`train_als` writes and resumes under a
    given ``checkpoint_dir`` (the JAX package's name)."""
    return os.path.join(checkpoint_dir, "als_checkpoint.npz")


def peek_checkpoint_iteration(checkpoint_dir: str | None) -> int:
    """Iteration recorded in the latest checkpoint (0 = none or
    unreadable): what a ``resume=True`` run continues from."""
    if not checkpoint_dir:
        return 0
    try:
        with np.load(checkpoint_path(checkpoint_dir)) as ckpt:
            return int(ckpt["iteration"])
    except Exception:  # noqa: BLE001 - BadZipFile on a truncated npz
        return 0


# --------------------------------------------------------------------------
# Incremental fold-in (host numpy, copied from the JAX package)
# --------------------------------------------------------------------------


def fold_in_users(
    item_factors: np.ndarray,
    user_rows: np.ndarray,
    item_cols: np.ndarray,
    values: np.ndarray,
    n_new_users: int,
    reg: float = 0.01,
    alpha: float = 1.0,
    implicit: bool = True,
) -> np.ndarray:
    """Solve factors for NEW users against a FIXED item matrix.

    The continuous-training fast path (ROADMAP "continuous training"):
    a cold-start user needs one ``k×k`` normal-equation solve — exactly
    one ALS half-iteration restricted to their rows — not a full
    retrain. Same math as :func:`_slab_stats` + :func:`_solve`
    (implicit: ``A = YtY + Σ αw·y·yᵀ + λI``, ``b = Σ (1+αw)·y``;
    explicit: ``A = Σ y·yᵀ + λ·n·I``, ``b = Σ r·y``), run on host
    numpy — fold-ins touch a handful of rows, far below device
    dispatch overhead. ``user_rows`` index the new users ``[0,
    n_new_users)``; ``item_cols`` index into ``item_factors``. Users
    with no in-range interactions (all their items unseen) get zero
    factors. Non-finite solves degrade to zeros, never NaN factors.

    Symmetric item fold-in is the same call with roles swapped.
    """
    y = np.asarray(item_factors, np.float32)
    k = y.shape[1]
    out = np.zeros((n_new_users, k), np.float32)
    rows = np.asarray(user_rows, np.int64)
    cols = np.asarray(item_cols, np.int64)
    vals = np.asarray(values, np.float32)
    keep = (cols >= 0) & (cols < len(y)) & (rows >= 0) & (
        rows < n_new_users
    )
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if len(rows) == 0:
        return out
    yty = y.T @ y if implicit else None
    eye = np.eye(k, dtype=np.float32)
    for u in np.unique(rows):
        sel = rows == u
        yu = y[cols[sel]]                       # [n_u, k]
        w = vals[sel]
        if implicit:
            a = yty + (yu * (alpha * w)[:, None]).T @ yu + reg * eye
            b = ((1.0 + alpha * w)[:, None] * yu).sum(axis=0)
        else:
            a = yu.T @ yu + reg * max(len(w), 1) * eye
            b = (w[:, None] * yu).sum(axis=0)
        try:
            x = np.linalg.solve(a, b)
        except np.linalg.LinAlgError:
            continue
        if np.all(np.isfinite(x)):
            out[int(u)] = x
    return out
