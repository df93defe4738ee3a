"""Pass 1's planner for the fused top-k kernel (pure Python, no CUDA).

The planner picks the query tile, item tile, list size and item splits
that ``csrc/fused_topk.cu`` launches with; the kernel refuses a plan it
cannot run. These tests hold every plan over the batch, ``num``, row
width and table type grid to what the kernel needs, and hold the
constants the planner mirrors to the CUDA source.
"""

import re
from pathlib import Path

import pytest

from predictionio_tpu_torch.ops import fused_topk

BATCHES = (1, 2, 3, 7, 8, 9, 31, 32, 33, 64, 65, 256, 1024)
NUMS = (1, 10, 16, 64, 128, 1024)
KS = (8, 32, 33, 256)
ITEMSIZES = {"f32": 4, "bf16": 2, "int8": 1}
CATALOGS = (1, 100, 20_011, 1_000_003, 1_048_576)
N_SMS = 132
SOURCE = (Path(fused_topk.__file__).resolve().parent.parent / "csrc"
          / "fused_topk.cu")


def _plans(form, rn):
    for b in BATCHES:
        for k in KS:
            yield b, k, fused_topk.plan_pass1(b, 1_048_576, rn, k,
                                              ITEMSIZES[form], N_SMS)


@pytest.mark.parametrize("form", ITEMSIZES)
@pytest.mark.parametrize("rn", NUMS)
def test_plan_fits_shared_memory(form, rn):
    for b, k, plan in _plans(form, rn):
        assert plan.smem == fused_topk.pass1_smem(
            plan.qt, b, plan.region, k, ITEMSIZES[form])
        assert 2 <= plan.stages <= fused_topk._MAX_STAGES
        assert plan.smem <= fused_topk.SMEM_LIMIT, (b, k, plan)
        assert plan.smem <= fused_topk.SMEM_BUDGET, (b, k, plan)


@pytest.mark.parametrize("form", ITEMSIZES)
@pytest.mark.parametrize("rn", NUMS)
def test_plan_query_tile_is_a_power_of_two(form, rn):
    for b, k, plan in _plans(form, rn):
        assert plan.qt & (plan.qt - 1) == 0, (b, k, plan)
        assert 1 <= plan.qt <= fused_topk.MAX_QT
        # no wider than the batch needs
        assert plan.qt < 2 * b or plan.qt == 1
        assert plan.item_tile == fused_topk.item_tile(plan.qt)


@pytest.mark.parametrize("form", ITEMSIZES)
@pytest.mark.parametrize("rn", NUMS)
def test_plan_splits_cover_the_catalog(form, rn):
    for n_items in CATALOGS:
        for b in BATCHES:
            plan = fused_topk.plan_pass1(b, n_items, min(rn, n_items), 32,
                                         ITEMSIZES[form], N_SMS)
            # split s holds items [s * split_len, (s + 1) * split_len):
            # contiguous and disjoint, so every item lies in exactly one
            # split and no split starts past the catalog
            assert plan.splits * plan.split_len >= n_items
            assert (plan.splits - 1) * plan.split_len < n_items
            assert plan.split_len % plan.item_tile == 0
            assert 1 <= plan.splits <= 65535


@pytest.mark.parametrize("form", ITEMSIZES)
@pytest.mark.parametrize("rn", NUMS)
def test_plan_buffer_holds_a_whole_tile(form, rn):
    for b, k, plan in _plans(form, rn):
        # a rank fold also needs rn slots for its result
        extra = rn if rn <= fused_topk._RANK_LIST else 0
        assert plan.region >= rn + extra + plan.item_tile, (b, k, plan)
        # bitonic folds need a power of two
        assert plan.region & (plan.region - 1) == 0, (b, k, plan)


def test_served_shapes_get_the_widest_tile():
    """The served path: B a power of two up to 64, num 16, rank 32."""
    for form, size in ITEMSIZES.items():
        for b in (1, 2, 4, 8, 16, 32, 64):
            plan = fused_topk.plan_pass1(b, 1_048_576, 16, 32, size, N_SMS)
            assert plan.qt == b, (form, b, plan)


def test_item_chunk_rows_fall_in_distinct_banks():
    """A row's stride is an odd number of 16-byte units, so eight
    consecutive rows read at one offset cover all 32 banks once."""
    for size in ITEMSIZES.values():
        for k in range(1, 257):
            chunk, stride = fused_topk.item_chunk(k, size)
            assert (chunk * size) % 16 == 0
            assert chunk * size <= fused_topk._CHUNK_BYTES
            assert stride % 16 == 0 and (stride // 16) % 2 == 1
            banks = {(r * stride // 4 + w) % 32 for r in range(8)
                     for w in range(4)}
            assert len(banks) == 32


def _constant(text, name):
    m = re.search(rf"constexpr int {name}\s*=\s*(\d+);", text)
    assert m, name
    return int(m.group(1))


def _array(text, name):
    m = re.search(rf"constexpr int {name}\[\d+\]\s*=\s*\{{([^}}]*)\}};", text)
    assert m, name
    return [int(v) for v in m.group(1).split(",")]


def test_planner_constants_match_the_cuda_source():
    text = SOURCE.read_text()
    assert _constant(text, "kThreads") == fused_topk._THREADS
    assert _constant(text, "kMaxTile") == fused_topk.MAX_QT
    assert _constant(text, "kRowPad") == fused_topk._ROW_PAD
    assert _constant(text, "kChunkBytes") == fused_topk._CHUNK_BYTES
    assert _constant(text, "kSmemLimit") == fused_topk.SMEM_LIMIT
    assert _constant(text, "kInflightBytes") == fused_topk._INFLIGHT_BYTES
    assert _constant(text, "kMaxStages") == fused_topk._MAX_STAGES
    assert _constant(text, "kSmemBudget") == fused_topk.SMEM_BUDGET
    assert _constant(text, "kRankList") == fused_topk._RANK_LIST
    tiles = sorted(fused_topk._MICRO)
    assert tiles == [1 << i for i in range(len(tiles))]
    assert tiles[-1] == fused_topk.MAX_QT
    assert _array(text, "kMicroQ") == [fused_topk._MICRO[t][0] for t in tiles]
    assert _array(text, "kMicroI") == [fused_topk._MICRO[t][1] for t in tiles]
