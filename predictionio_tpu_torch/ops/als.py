"""Alternating Least Squares on one card.

Counterpart of ``predictionio_tpu/ops/als.py`` (implicit Hu-Koren-Volinsky
and explicit weighted-λ ALS), in PyTorch on ``ctx.device``:

* Host side, interactions are packed into **degree-bucketed slabs**
  (:func:`build_bucketed`, copied from the JAX package, numpy plus the
  native fill pass of ``native/alspack.cc``): every row of a bucket owns
  one dense ``[s * block_len]`` slot row; rows heavier than ``s_max``
  blocks are split into sub-rows.
* Device side, one half-iteration is, per slab: gather the opposite
  side's factors ``[R, W, k]`` → batched Gramians (``torch.bmm``) →
  batched Cholesky solves (``torch.linalg.cholesky_ex`` +
  ``cholesky_solve``). Heavy sub-rows add their partial stats into
  their owner's slot with ``index_add_`` before that slot is solved.
* :func:`train_als` alternates the two sides for ``iterations`` epochs,
  with npz checkpoints in the JAX package's format, so a checkpoint
  written by either package resumes in the other.

The JAX package's TPU formulations of the same math are not ported: the
k-major gather layout (``PIO_ALS_GATHER_LAYOUT``) and the unrolled
Cholesky–Crout solve. Model-sharded training (``factor_sharding=
"sharded"``) is multi-GPU work (ROADMAP.md, queue 1, item 9).
"""

from __future__ import annotations

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
from predictionio_tpu_torch.parallel.mesh import (
    ComputeContext,
    assert_phantom_rows_zero,
)
from predictionio_tpu_torch.utils import native
from predictionio_tpu_torch.utils.profiling import sync

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
    ``max_slab_slots`` slots: the per-slab factor gather materializes a
    ``[R·W, k]`` temp (256 MB in float32 at k = 32 and the default 2M
    slots). Splitting bounds the peak temp; the concatenated stats
    layout (and therefore ``inv_perm``) is unchanged by the split.
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
    ``build/native/`` by :mod:`predictionio_tpu_torch.utils.native`
    (which raises when the build fails); None when ``PIO_NO_NATIVE=1``
    asks for the numpy path, which gives identical arrays."""
    if os.environ.get("PIO_NO_NATIVE", "").strip() in ("1", "true"):
        return None
    lib = native.load("alspack")
    c = ctypes
    lib.pio_alspack_fill.restype = None
    lib.pio_alspack_fill.argtypes = [
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_float), c.c_int64, c.POINTER(c.c_int64),
        c.POINTER(c.c_int64), c.POINTER(c.c_int32),
        c.POINTER(c.c_float), c.POINTER(c.c_float),
    ]
    return lib


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
    """Pack COO → degree-bucketed slabs (vectorized host preprocessing).

    Rows are assigned to buckets of ``s`` blocks (``s`` a power of two,
    ``s ≤ s_max``); a bucket's slab is a dense ``[R_b, s·block_len]``
    array where row ``j`` holds that entity's entire interaction list
    (zero-padded). Rows needing more than ``s_max`` blocks are split
    into sub-rows of width ``s_max·block_len`` in the ``heavy`` slabs.
    No slab exceeds ``max_slab_slots`` (= R·W) slots — the HBM bound on
    the per-slab factor-gather temp (see :class:`Bucketed`).
    """
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


def _slab_stats(y, idx, weights, valid, implicit, alpha, compute=None):
    """Per-row normal-equation pieces ``(A [R,k,k], b [R,k], count [R])``
    for one dense slab: the k-minor gather ``y[idx]`` then two batched
    products. ``y`` arrives already cast to ``compute``, so the gather
    moves low-precision bytes; the gathered rows (and the weights,
    rounded to ``compute`` as the JAX package rounds them) are upcast
    to float32 before any product, where a product of two bf16 values is
    exact, so only the summation order differs from the JAX package."""
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
    with torch.profiler.record_function("als/gather_gramian"):
        yg = y.index_select(0, idx.reshape(-1)).view(r, w, -1).float()
        a = torch.bmm((yg * aw.unsqueeze(-1)).transpose(1, 2), yg)
        b = torch.bmm(bw.unsqueeze(1), yg).squeeze(1)
    return a, b, mask.sum(dim=1)


def _solve(a, b, cnt, yty, lam, implicit):
    """Regularize and solve the batch of ``k × k`` systems. A system
    that is not positive definite (explicit mode with ``lam=0`` on an
    empty row, say) solves to zeros, as in the JAX package: its
    ``cholesky_ex`` info is nonzero, and whatever ``cholesky_solve``
    made of it is dropped, as is any non-finite element."""
    k = a.shape[-1]
    eye = torch.eye(k, dtype=a.dtype, device=a.device)
    if implicit:
        a = a + yty + lam * eye
    else:
        # MLlib-style weighted-λ regularization: λ · n_u · I
        a = a + (lam * cnt.clamp(min=1.0))[:, None, None] * eye
    with torch.profiler.record_function("als/solve"):
        chol, info = torch.linalg.cholesky_ex(a)
        x = torch.cholesky_solve(b.unsqueeze(-1), chol).squeeze(-1)
        ok = (info == 0).unsqueeze(-1) & torch.isfinite(x)
        return torch.where(ok, x, torch.zeros((), dtype=x.dtype,
                                              device=x.device))


def _assemble_and_solve(
    y, slab_arrays, heavy_groups, n_heavy_slots, implicit, alpha, lam,
    compute=None,
):
    """One direction's solve in the concatenated stats layout: each
    slab's systems are solved as soon as they are built (only ``[R, k]``
    rows survive, never the whole ``[n_stat_rows, k, k]``); heavy
    sub-rows add their partial stats into a small ``[n_heavy_slots, k,
    k]`` buffer with ``index_add_``, solved last. ``heavy_groups`` are
    ``(idx, weights, valid, owner)`` with absolute stats positions."""
    k = y.shape[1]
    if compute is not None:
        y = y.to(compute)  # cast once, before any gather
    yf = y.float()
    yty = yf.T @ yf if implicit else None
    n_regular = 0
    parts = []
    for idx, weights, valid in slab_arrays:
        a, b, cnt = _slab_stats(y, idx, weights, valid, implicit, alpha,
                                compute)
        parts.append(_solve(a, b, cnt, yty, lam, implicit))
        n_regular += idx.shape[0]
    if n_heavy_slots:
        dev = yf.device
        ha = torch.zeros((n_heavy_slots, k, k), device=dev)
        hb = torch.zeros((n_heavy_slots, k), device=dev)
        hcnt = torch.zeros((n_heavy_slots,), device=dev)
        for idx, weights, valid, owner in heavy_groups:
            ga, gb, gcnt = _slab_stats(y, idx, weights, valid, implicit,
                                       alpha, compute)
            # phantom sub-rows carry owner 0 and zero weights: the clamp
            # keeps their (zero) contribution in range
            local = (owner - n_regular).clamp(0, n_heavy_slots - 1)
            with torch.profiler.record_function("als/heavy_add"):
                ha.index_add_(0, local, ga)
                hb.index_add_(0, local, gb)
                hcnt.index_add_(0, local, gcnt)
        parts.append(_solve(ha, hb, hcnt, yty, lam, implicit))
    return torch.cat(parts, dim=0)


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
    where it needs the values."""
    compute = _resolve_compute(compute_dtype)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)

    slabs = [(put(s.idx), put(s.weights), put(s.valid))
             for s in packed.slabs]
    heavy = [
        (put(h.idx), put(h.weights), put(h.valid),
         put(owner.astype(np.int64)))
        for h, owner in zip(packed.heavy, packed.heavy_owner_pos)
    ]
    n_heavy_slots = packed.n_stat_rows - sum(
        s.idx.shape[0] for s in packed.slabs
    )
    inv_perm = put(packed.inv_perm.astype(np.int64))

    def solve(y: torch.Tensor, lam: float) -> torch.Tensor:
        x_stats = _assemble_and_solve(
            y, slabs, heavy, n_heavy_slots, implicit, alpha, lam, compute,
        )
        return x_stats.index_select(0, inv_perm)

    return solve


def make_train_step(solve_u, solve_i):
    """The epoch loop: ``(x, y, lam, n_iters) → (x, y)``, a user
    half-step then an item half-step per epoch, all enqueued without a
    wait."""

    def run(x, y, lam, n_iters):
        for _ in range(n_iters):
            x = solve_u(y, lam)
            y = solve_i(x, lam)
        return x, y

    return run


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
    """Alternate user/item normal-equation solves on ``ctx.device``.

    The signature and defaults are the JAX package's. ``ctx=None`` takes
    the current CUDA device and raises without one: training never drops
    quietly to the CPU (pass ``ComputeContext.create(device="cpu")`` for
    that). Epochs are enqueued without a wait; a ``timer``
    (:class:`~predictionio_tpu_torch.utils.profiling.StepTimer`) instead
    times each half-step, synchronising after it. With
    ``checkpoint_dir`` + ``checkpoint_every`` the factors are written
    every N iterations (atomic npz: ``iteration``, ``item_factors``,
    ``user_factors``), and ``resume=True`` continues from the latest
    checkpoint whose shapes match and whose iteration is at most
    ``iterations``; a damaged checkpoint means a cold start.
    ``row_chunk`` is kept for call compatibility.

    ``compute_dtype`` ("bfloat16") gathers bf16 factors; products,
    sums and the solve stay float32. ``factor_sharding`` "auto" and
    "replicated" are one card's layout; "sharded" is multi-GPU work and
    raises. ``return_layout`` "host" returns unpadded numpy; "device"
    returns the padded tensors on ``ctx.device``.
    """
    del row_chunk
    if factor_sharding not in ("auto", "sharded", "replicated"):
        raise ValueError(
            f"factor_sharding must be 'auto', 'sharded' or 'replicated', "
            f"got {factor_sharding!r}"
        )
    if factor_sharding == "sharded":
        raise NotImplementedError(
            "factor_sharding='sharded' (model-sharded factors over "
            "several cards) is not ported yet: ROADMAP.md, queue 1, "
            "item 9 (multi-GPU)"
        )
    if return_layout not in ("host", "device"):
        raise ValueError(
            f"return_layout must be 'host' or 'device', "
            f"got {return_layout!r}"
        )
    ctx = ctx or ComputeContext.create(batch="als")
    row_multiple = ctx.data_parallelism

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
    np_dtype = np.asarray(init).dtype
    # phantom rows start (and, with no interactions, stay) exactly zero
    item_host = np.zeros((item_packed.n_rows_padded, rank), np_dtype)
    item_host[:n_items] = init
    item_factors = torch.from_numpy(item_host).to(ctx.device)
    user_factors = torch.zeros(
        (user_packed.n_rows_padded, rank), dtype=item_factors.dtype,
        device=ctx.device,
    )
    lam = float(reg)

    solve_u = make_solve_side(ctx, user_packed, implicit, alpha,
                              compute_dtype)
    solve_i = make_solve_side(ctx, item_packed, implicit, alpha,
                              compute_dtype)
    step = make_train_step(solve_u, solve_i)

    ran_any = False
    # between epochs on the host, never inside a timed device window
    chaos_sleep = _train_chaos_sleep_s()
    if timer is not None:
        # profiling mode: each half-iteration timed apart
        for it in range(start_iteration, iterations):
            if chaos_sleep:
                time.sleep(chaos_sleep)
            with timer.step("als/user_solve"):
                user_factors = solve_u(item_factors, lam)
                sync(user_factors)
            with timer.step("als/item_solve"):
                item_factors = solve_i(user_factors, lam)
                sync(item_factors)
            ran_any = True
            _maybe_checkpoint(
                ckpt_path, checkpoint_every, it + 1, iterations,
                user_factors, item_factors, n_users, n_items,
            )
    else:
        checkpointing = bool(ckpt_path) and checkpoint_every > 0
        it = start_iteration
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
                user_factors, item_factors, n_users, n_items,
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
            user_factors = torch.from_numpy(padded_u).to(ctx.device)
        else:
            user_factors = solve_u(item_factors, lam)
    if return_layout == "device":
        # fetch only the padded tails to check the phantom invariant
        assert_phantom_rows_zero(user_factors[n_users:], 0, "user factors")
        assert_phantom_rows_zero(item_factors[n_items:], 0, "item factors")
        return ALSFactors(
            user_factors=user_factors,
            item_factors=item_factors,
            n_users=n_users,
            n_items=n_items,
        )
    user_full = user_factors.cpu().numpy()
    item_full = item_factors.cpu().numpy()
    assert_phantom_rows_zero(user_full, n_users, "user factors")
    assert_phantom_rows_zero(item_full, n_items, "item factors")
    return ALSFactors(
        user_factors=user_full[:n_users],
        item_factors=item_full[:n_items],
        n_users=n_users,
        n_items=n_items,
    )


def _maybe_checkpoint(
    ckpt_path, checkpoint_every, iteration, total,
    user_factors, item_factors, n_users, n_items,
) -> None:
    if (
        ckpt_path
        and checkpoint_every > 0
        and iteration % checkpoint_every == 0
        and iteration < total
    ):
        # the checkpoint is a span of the training trace and a count in
        # the registry (the restore points a trainer has banked)
        with tracing.span(
            "als/checkpoint", iteration=iteration, total=total
        ):
            _write_checkpoint(
                ckpt_path,
                iteration=iteration,
                item_factors=item_factors[:n_items].cpu().numpy(),
                user_factors=user_factors[:n_users].cpu().numpy(),
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
