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
* a slot with no rankable item left holds score -inf and index 0;
* ``items`` is float32, bfloat16 or int8; ``scale`` ([I] float32) multiplies
  each item's score after the dot; ``mask`` ([I] or [B, I], nonzero =
  exclude) is taken as it is, with no widening to [B, I].

Bound on the card (the note in the CUDA source has the design): the table
read once plus ``2*B*I*k`` fp32 operations; at I = 1,048,576 and k = 32 that
is 128 MiB for float32 and 4.3 GFLOP at B = 64.
"""

from __future__ import annotations

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
_THREADS = 256      # must match kThreads in csrc/fused_topk.cu
_MAX_K = 256
_NEG = float("-inf")


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
    scores = scores.masked_fill(torch.isnan(scores), _NEG)
    mask = _as_mask(mask)
    if mask is not None:
        scores = scores.masked_fill(mask, _NEG)
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :num], top_i[:, :num]
    # a slot no rankable item filled holds index 0, as the kernel leaves it
    top_i = torch.where(torch.isneginf(top_s), 0, top_i)
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


def _query_tile(batch: int) -> int:
    """Queries per pass-1 block: the smallest of 1, 2, 4, 8 covering the
    batch (8 for larger batches)."""
    return min(8, 1 << (batch - 1).bit_length())


def _plan_splits(batch: int, n_items: int, num: int, n_sms: int):
    """Item splits for pass 1: enough (query tile x split) blocks to fill
    the card four deep, none shorter than two chunks or twice ``num``."""
    tiles = -(-batch // _query_tile(batch))
    splits = max(1, -(-4 * n_sms // tiles))
    min_len = max(2 * _THREADS, 2 * num)
    splits = min(splits, max(1, -(-n_items // min_len)), 65535)
    split_len = -(-n_items // splits)
    return -(-n_items // split_len), split_len


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
        # a list plus room for one chunk of candidates, a power of two
        region = 1 << (rn + _THREADS - 1).bit_length()
        splits, split_len = _plan_splits(batch, n_items, rn, n_sms)
        partial = torch.empty((batch, splits, rn), dtype=torch.int64,
                              device=dev)
        rc = lib.pio_topk_pass1(
            _query_tile(batch), queries.data_ptr(), items.data_ptr(),
            _DTYPE_CODE[form],
            scale.data_ptr() if scale is not None else None,
            mask.data_ptr() if mask is not None else None, mask_kind,
            bound.data_ptr() if off > 0 else None, partial.data_ptr(),
            batch, n_items, k, rn, region, split_len, splits, vec, stream,
        )
        if rc != 0:
            raise RuntimeError(f"fused top-k pass 1 launch failed: CUDA "
                               f"error {rc}")
        rc = lib.pio_topk_pass2(
            partial.data_ptr(), batch, splits, rn, region,
            out_s.data_ptr(), out_i.data_ptr(), num, off,
            bound.data_ptr() if bound is not None else None, stream,
        )
        if rc != 0:
            raise RuntimeError(f"fused top-k pass 2 launch failed: CUDA "
                               f"error {rc}")
    with _launches_lock:
        LAUNCHES[form] += 1
    return out_s, out_i
