"""Fused dot-product scoring + top-k: the serving hot path's kernel.

Counterpart of ``predictionio_tpu/ops/pallas_topk.py``. For each query row
it returns the ``num`` items with the largest ``q . item`` and never writes
the ``[B, I]`` score matrix. On a CUDA tensor :func:`fused_top_k_dot`
launches the hand-written Hopper kernel in ``csrc/fused_topk.cu``; on a CPU
tensor it runs :func:`fused_top_k_dot_reference`, the plain version that
the tests hold against the JAX package and ``chip_smoke.py`` holds the
kernel against on the card.

Contract (both versions, pallas_topk.py:37-39, 110-137, 248-251):

* NaN scores and masked items rank as -inf;
* ``num`` is clamped to the catalog size;
* equal scores rank the lower item index first;
* a slot with no rankable item left holds score -inf and the lowest
  unrankable index not already listed, ascending (``lax.top_k``'s order);
* ``items`` is float32, bfloat16 or int8; ``scale`` ([I] float32) multiplies
  each item's score after the dot; ``mask`` ([I] or [B, I], nonzero =
  exclude) is taken as it is, with no widening to [B, I].

Bound on the card (the note in the CUDA source has the design): the table
read once plus ``2*B*I*k`` fp32 operations; at I = 1,048,576 and k = 32 that
is 128 MiB for float32 and 4.3 GFLOP at B = 64.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

#: per-form launch counts on the CUDA path: one per wrapper call that
#: launches the kernel, and nowhere else
LAUNCHES = {"f32": 0, "bf16": 0, "int8": 0}
_launches_lock = threading.Lock()

_FORMS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
_DTYPE_CODE = {"f32": 0, "bf16": 1, "int8": 2}
#: the most a kernel round ranks (its lists live in shared memory); a
#: larger ``num`` runs further rounds
NUM_CAP = 1024
_MAX_K = 256
_NEG = float("-inf")

# Mirrors of csrc/fused_topk.cu's constants (a CPU test reads them there).
_THREADS = 256      # kThreads: threads per block
MAX_QT = 64         # kMaxTile: most queries scored together in one block
_ROW_PAD = 16       # kRowPad: bytes that pad a shared-memory row
_CHUNK_BYTES = 128  # kChunkBytes: most bytes of an item row per chunk
#: (TQ, TI) per query tile QT: kMicroQ / kMicroI, indexed by log2(QT)
_MICRO = {1: (1, 1), 2: (2, 1), 4: (4, 1), 8: (4, 2), 16: (4, 2),
          32: (4, 2), 64: (4, 4)}
_INFLIGHT_BYTES = 40_960  # kInflightBytes: item-tile copies kept in flight
_MAX_STAGES = 16          # kMaxStages: most stages of the item-tile ring
_RANK_LIST = 32           # kRankList: lists this short fold by rank
#: most shared memory a block may take on Hopper (227 KB)
SMEM_LIMIT = 232_448
#: kSmemBudget: pass 1's dynamic shared memory, so that two blocks (plus
#: their static arrays) share one SM
SMEM_BUDGET = 112_640


def reset_launch_counts() -> None:
    with _launches_lock:
        for form in LAUNCHES:
            LAUNCHES[form] = 0


def _as_mask(mask: torch.Tensor | None) -> torch.Tensor | None:
    if mask is None or mask.dtype == torch.bool:
        return mask
    return mask != 0


def fused_top_k_dot_reference(
    queries: torch.Tensor,            # [B, k] float32
    items: torch.Tensor,              # [I, k] float32 | bfloat16 | int8
    num: int,
    mask: torch.Tensor | None = None,   # [I] or [B, I], nonzero = exclude
    scale: torch.Tensor | None = None,  # [I] float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the whole score matrix, then a stable sort,
    whose order puts the lower index first among equal scores."""
    num = min(int(num), items.shape[0])
    scores = queries.float() @ items.float().T
    if scale is not None:
        scores = scores * scale.float()[None, :]
    # -0.0 ranks as +0.0, then by index, as the kernel's key ranks it (a
    # radix sort on the card would put it below +0.0)
    scores = torch.where(scores == 0, 0.0, scores)
    scores = scores.masked_fill(torch.isnan(scores), _NEG)
    mask = _as_mask(mask)
    if mask is not None:
        scores = scores.masked_fill(mask, _NEG)
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    # unrankable items (-inf) follow the rankable ones, ascending by index
    top_s, top_i = top_s[:, :num], top_i[:, :num]
    return top_s.contiguous(), top_i.to(torch.int32).contiguous()


def fused_top_k_dot(
    queries: torch.Tensor,
    items: torch.Tensor,
    num: int,
    mask: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``num`` items per query row by dot product: ``(scores
    [B, num] float32, indices [B, num] int32)``. A CUDA tensor launches
    the kernel (or raises); a CPU tensor takes the plain version."""
    if queries.device.type == "cpu":
        return fused_top_k_dot_reference(queries, items, num, mask, scale)
    if queries.device.type != "cuda":
        raise ValueError(
            f"fused_top_k_dot runs on cuda or cpu, not {queries.device}"
        )
    return _launch(queries, items, num, mask, scale)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_top_k_dot: {msg}")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def item_tile(qt: int) -> int:
    """Items a pass-1 block scores per tile at query tile ``qt``: each of
    the block's threads owns a (TQ queries x TI items) micro-tile."""
    tq, ti = _MICRO[qt]
    return _THREADS * tq * ti // qt


def padded_row(nbytes: int) -> int:
    """A shared-memory row of ``nbytes`` (a multiple of 16) padded to an
    odd number of 16-byte units, so that eight rows read at one offset
    fall in different banks."""
    return nbytes + (_ROW_PAD if (nbytes // 16) % 2 == 0 else 0)


def item_chunk(k: int, itemsize: int) -> tuple[int, int]:
    """(elements, shared-memory row stride in bytes) of one item-tile
    chunk: rows are cut into chunks of at most ``_CHUNK_BYTES`` along k,
    padded to a whole 16-byte load."""
    kp = _round_up(k, 16 // itemsize)
    chunk = min(kp, _CHUNK_BYTES // itemsize)
    return chunk, padded_row(chunk * itemsize)


def tile_stages(stage_bytes: int, fixed: int) -> int:
    """Stages of pass 1's item-tile ring: enough that all but the one
    being read hold ``_INFLIGHT_BYTES`` of copies, as many as fit beside
    ``fixed`` bytes in ``SMEM_BUDGET``, at most 16, at least 2."""
    want = 1 + -(-_INFLIGHT_BYTES // stage_bytes)
    fit = (SMEM_BUDGET - fixed) // stage_bytes
    return max(2, min(want, fit, _MAX_STAGES))


def list_region(rn: int, it: int) -> int:
    """Slots per list: ``rn`` plus room for a whole tile of candidates
    (plus ``rn`` slots for a rank fold's result when ``rn`` is at most
    ``_RANK_LIST``), rounded up to a power of two (longer lists fold by
    bitonic sort)."""
    return _pow2_at_least((2 * rn if rn <= _RANK_LIST else rn) + it)


def _pass1_layout(qt, batch, region, k, itemsize):
    """(bytes of lists and queries, bytes of one ring stage, stages)."""
    _, stride = item_chunk(k, itemsize)
    kp = _round_up(k, 16 // itemsize)
    stage = item_tile(qt) * stride
    fixed = min(qt, batch) * region * 8 + qt * padded_row(kp * 4)
    return fixed, stage, tile_stages(stage, fixed)


def pass1_smem(qt: int, batch: int, region: int, k: int,
               itemsize: int) -> int:
    """Dynamic shared bytes of one pass-1 block: a list region per query
    of the tile, the tile's queries (padded rows), and the ring of item
    tiles. Mirrors ``pass1_smem`` in the CUDA source."""
    fixed, stage, stages = _pass1_layout(qt, batch, region, k, itemsize)
    return fixed + stages * stage


@dataclasses.dataclass(frozen=True)
class Pass1Plan:
    qt: int           # queries per block (its lists live in shared memory)
    item_tile: int    # items per tile streamed through shared memory
    region: int       # slots per list (list_region)
    stages: int       # item tiles in the shared-memory ring
    splits: int       # item splits (grid y)
    split_len: int    # items per split, a multiple of item_tile
    smem: int         # dynamic shared bytes per block


def plan_pass1(batch: int, n_items: int, rn: int, k: int, itemsize: int,
               n_sms: int) -> Pass1Plan:
    """Pass 1's launch: the widest query tile (a power of two up to 64,
    no wider than the batch needs) whose block fits ``SMEM_BUDGET``, so
    two blocks share an SM; then item splits giving about two blocks per
    SM over the grid, none shorter than two tiles or twice ``rn``."""
    qt = min(MAX_QT, _pow2_at_least(batch))
    while True:
        region = list_region(rn, item_tile(qt))
        smem = pass1_smem(qt, batch, region, k, itemsize)
        if smem <= SMEM_BUDGET or qt == 1:
            break
        qt //= 2
    it = item_tile(qt)
    tiles = -(-batch // qt)
    splits = max(1, -(-2 * n_sms // tiles))
    min_len = max(2 * it, 2 * rn)
    splits = min(splits, max(1, -(-n_items // min_len)), 65535)
    split_len = _round_up(-(-n_items // splits), it)
    stages = _pass1_layout(qt, batch, region, k, itemsize)[2]
    return Pass1Plan(qt, it, region, stages,
                     -(-n_items // split_len), split_len, smem)


def _launch(queries, items, num, mask, scale):
    dev = queries.device
    _check(queries.dim() == 2 and queries.dtype == torch.float32,
           f"queries must be [B, k] float32, got {tuple(queries.shape)} "
           f"{queries.dtype}")
    _check(items.dim() == 2 and items.dtype in _FORMS,
           f"items must be [I, k] float32/bfloat16/int8, got "
           f"{tuple(items.shape)} {items.dtype}")
    batch, k = queries.shape
    n_items = items.shape[0]
    _check(items.shape[1] == k, f"items have k={items.shape[1]}, queries {k}")
    _check(1 <= k <= _MAX_K, f"k={k} outside 1..{_MAX_K}")
    _check(n_items < 2**31 - 1, "catalog exceeds int32 indices")
    _check(items.device == dev, "items on another device than queries")
    _check(queries.is_contiguous() and items.is_contiguous(),
           "queries and items must be contiguous")
    form = _FORMS[items.dtype]
    if scale is not None:
        _check(scale.shape == (n_items,) and scale.dtype == torch.float32
               and scale.is_contiguous() and scale.device == dev,
               "scale must be a contiguous [I] float32 tensor on the "
               "queries' device")
    mask_kind = 0
    if mask is not None:
        _check(mask.dtype in (torch.bool, torch.uint8, torch.int8),
               f"mask dtype {mask.dtype} (bool, uint8 or int8)")
        _check(mask.device == dev and mask.is_contiguous(),
               "mask must be contiguous, on the queries' device")
        if mask.shape == (n_items,):
            mask_kind = 1
        elif mask.shape == (batch, n_items):
            mask_kind = 2
        else:
            raise ValueError(
                f"fused_top_k_dot: mask shape {tuple(mask.shape)} is "
                f"neither [I] nor [B, I] = [{batch}, {n_items}]"
            )
        mask = mask.view(torch.uint8)
    num = min(int(num), n_items)
    out_s = torch.empty((batch, max(num, 0)), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((batch, max(num, 0)), dtype=torch.int32, device=dev)
    if num <= 0 or batch == 0:
        return out_s, out_i

    from predictionio_tpu_torch.ops import _build

    lib = _build.library("fused_topk")
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    vec = int(
        (k * items.element_size()) % 16 == 0 and items.data_ptr() % 16 == 0
    )
    bound = (
        torch.empty((batch,), dtype=torch.int64, device=dev)
        if num > NUM_CAP else None
    )
    for off in range(0, num, NUM_CAP):
        rn = min(NUM_CAP, num - off)
        plan = plan_pass1(batch, n_items, rn, k, items.element_size(), n_sms)
        partial = torch.empty((batch, plan.splits, rn), dtype=torch.int64,
                              device=dev)
        rc = lib.pio_topk_pass1(
            plan.qt, queries.data_ptr(), items.data_ptr(),
            _DTYPE_CODE[form],
            scale.data_ptr() if scale is not None else None,
            mask.data_ptr() if mask is not None else None, mask_kind,
            bound.data_ptr() if off > 0 else None, partial.data_ptr(),
            batch, n_items, k, rn, plan.region, plan.split_len, plan.splits,
            vec, stream,
        )
        if rc != 0:
            raise RuntimeError(f"fused top-k pass 1 launch failed: CUDA "
                               f"error {rc}")
        # pass 2 offers one chunk of kThreads keys at a time
        rc = lib.pio_topk_pass2(
            partial.data_ptr(), batch, plan.splits, rn,
            _pow2_at_least(rn + _THREADS),
            out_s.data_ptr(), out_i.data_ptr(), num, off,
            bound.data_ptr() if bound is not None else None, stream,
        )
        if rc != 0:
            raise RuntimeError(f"fused top-k pass 2 launch failed: CUDA "
                               f"error {rc}")
    with _launches_lock:
        LAUNCHES[form] += 1
    return out_s, out_i
