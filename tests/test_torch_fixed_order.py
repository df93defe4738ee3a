"""Sums that repeat run to run: the port's ALS heavy sub-rows and the
helloworld means add in a fixed order, with no float atomics.

* ``_heavy_stats`` equals, bit for bit, a Python loop over each owner's
  sub-rows in ascending row order, added pairwise (padded with zeros to
  a power of two), group after group: on the one-device layout (groups
  small enough that an owner's sub-rows span two of them), on the
  model-sharded layout of every shard (``plan_shards``) and on the
  replicated layout's data blocks;
* ``heavy_order``'s plan: phantom sub-rows left out, owners bucketed by
  padded width, every real sub-row once;
* two ``train_als`` runs on a CPU mesh give equal factors, and they stay
  within rtol 1e-4 / atol 1e-5 of the JAX package's;
* ``segment_mean`` against a per-segment numpy mean, and run twice;
* the port's ALS and helloworld sources hold no ``index_add_``,
  ``scatter_add`` or accumulating ``index_put_`` (comments and
  docstrings aside).
"""

import io
import pathlib
import tokenize

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu_torch.models import helloworld
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.parallel.mesh import ComputeContext

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _problem(seed=3, n_rows=30, n_cols=50):
    """A few heavy rows (degree 30-60 at block_len 4, s_max 2: 4-8
    sub-rows of width 8) among light ones."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(n_rows):
        deg = int(rng.integers(30, 61)) if r % 7 == 3 else int(
            rng.integers(1, 8))
        rows += [r] * deg
        cols += rng.integers(0, n_cols, deg).tolist()
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    vals = rng.integers(1, 6, len(rows)).astype(np.float32)
    y = torch.from_numpy(rng.standard_normal((n_cols, 6)).astype(np.float32))
    return rows, cols, vals, n_rows, y


def _loop_reference(y, groups, n_regular, n_slots, implicit, alpha):
    """The order pinned, one row at a time: for each group in turn, each
    owner's sub-rows in ascending order, padded with zero rows to the
    next power of two, are added pairwise level by level, and the total
    is added into the owner's slot."""
    k = y.shape[1]
    ref = torch.zeros((n_slots, k * k + k + 1))
    for idx, weights, valid, owner in groups:
        ga, gb, gc = als._slab_stats(y, idx, weights, valid, implicit, alpha)
        g = torch.cat([ga.reshape(ga.shape[0], -1), gb, gc[:, None]], dim=1)
        owner = np.asarray(owner).tolist()
        for o in sorted(set(owner)):
            if o < n_regular:
                continue  # a phantom sub-row
            vals = [g[r] for r in range(len(owner)) if owner[r] == o]
            while len(vals) & (len(vals) - 1):
                vals.append(torch.zeros_like(vals[0]))
            while len(vals) > 1:
                vals = [vals[i] + vals[i + 1] for i in range(0, len(vals), 2)]
            ref[o - n_regular] = ref[o - n_regular] + vals[0]
    return ref


def _ours(y, groups, n_regular, n_slots, implicit, alpha):
    planned = [(i, w, v, als.heavy_order(np.asarray(o), n_regular, CPU))
               for i, w, v, o in groups]
    ha, hb, hc = als._heavy_stats(y, planned, n_slots, implicit, alpha, None)
    return torch.cat([ha.reshape(n_slots, -1), hb, hc[:, None]], dim=1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("implicit", [True, False])
def test_heavy_sum_is_a_loop_in_row_order_on_one_device(implicit):
    rows, cols, vals, n_rows, y = _problem()
    packed = als.build_bucketed(rows, cols, vals, n_rows, block_len=4,
                                s_max=2, max_slab_slots=24, row_multiple=2)
    assert len(packed.heavy) > 2  # the groups split owners' sub-rows
    n_regular = sum(s.idx.shape[0] for s in packed.slabs)
    n_slots = packed.n_stat_rows - n_regular
    groups = [(_t(h.idx), _t(h.weights), _t(h.valid), owner)
              for h, owner in zip(packed.heavy, packed.heavy_owner_pos)]
    spans = [set(np.asarray(o).tolist()) for o in packed.heavy_owner_pos]
    assert any(a & b for a, b in zip(spans, spans[1:]))
    got = _ours(y, groups, n_regular, n_slots, implicit, 2.0)
    want = _loop_reference(y, groups, n_regular, n_slots, implicit, 2.0)
    assert torch.equal(got, want)
    assert got.abs().sum() > 0


@pytest.mark.parametrize("n_shards", [2, 4])
def test_heavy_sum_is_a_loop_in_row_order_on_each_shard(n_shards):
    rows, cols, vals, n_rows, y = _problem(seed=5)
    packed = als.build_bucketed(rows, cols, vals, n_rows, block_len=4,
                                s_max=2, row_multiple=n_shards)
    plan = als.plan_shards(packed, n_shards)
    per = plan.heavy.idx.shape[0] // n_shards
    c_slab = plan.c_local - plan.n_heavy_slots_local
    for i in range(n_shards):
        sl = slice(i * per, (i + 1) * per)
        group = (_t(plan.heavy.idx[sl]), _t(plan.heavy.weights[sl]),
                 _t(plan.heavy.valid[sl]), plan.heavy_owner_local[sl])
        got = _ours(y, [group], c_slab, plan.n_heavy_slots_local, True, 1.0)
        want = _loop_reference(y, [group], c_slab, plan.n_heavy_slots_local,
                               True, 1.0)
        assert torch.equal(got, want)


def test_heavy_sum_is_a_loop_in_row_order_on_each_data_block():
    rows, cols, vals, n_rows, y = _problem(seed=8)
    ctx = ComputeContext.create(device="cpu", mesh_shape=(2, 1))
    packed = als.build_bucketed(rows, cols, vals, n_rows, block_len=4,
                                s_max=2, max_slab_slots=40, row_multiple=2)
    n_regular = sum(s.idx.shape[0] for s in packed.slabs)
    n_slots = packed.n_stat_rows - n_regular
    _slabs, heavy = als._device_slabs(ctx, packed)
    for pos in ctx.mesh.local:
        mine = [als._heavy_at(h, pos) for h in heavy]
        got = als._heavy_stats(y, mine, n_slots, True, 1.0, None)
        got = torch.cat([got[0].reshape(n_slots, -1), got[1],
                         got[2][:, None]], dim=1)
        groups = []
        for h, owner in zip(heavy, packed.heavy_owner_pos):
            sl = h[0].sharding.block(pos, h[0].shape)[0]
            groups.append((*als._at(h[:3], pos), owner[sl]))
        want = _loop_reference(y, groups, n_regular, n_slots, True, 1.0)
        assert torch.equal(got, want)


def test_heavy_order_plan():
    n_regular = 10
    # owners 12 (3 sub-rows), 10 (1), 11 (2); two phantoms (owner 0)
    owner = np.asarray([12, 12, 10, 11, 12, 11, 0, 0])
    order = als.heavy_order(owner, n_regular, CPU)
    got = [(s.tolist(), r.tolist(), w) for s, r, w in order.buckets]
    # widths 1, 2 and 4: rows ascending, padded with the zero row (8)
    assert got == [([0], [2], 1), ([1], [3, 5], 2), ([2], [0, 1, 4, 8], 4)]
    empty = als.heavy_order(np.zeros(4, np.int64), n_regular, CPU)
    assert empty.buckets == []


@pytest.mark.parametrize("mesh_shape, sharding", [
    ((1, 1), "replicated"), ((2, 1), "replicated"), ((2, 2), "sharded"),
])
def test_train_als_repeats_and_matches_jax(tmp_path, mesh_shape, sharding):
    """From one shared iteration-0 checkpoint: two port runs equal, and
    within the JAX package's tolerance between meshes of its run."""
    import jax

    rows, cols, vals, n_rows, _y = _problem(seed=11, n_cols=40)
    rng = np.random.default_rng(6)
    als._write_checkpoint(
        als.checkpoint_path(str(tmp_path)), iteration=0,
        item_factors=(rng.standard_normal((40, 6)) / 3).astype(np.float32),
        user_factors=np.zeros((n_rows, 6), np.float32))
    kw = dict(n_users=n_rows, n_items=40, rank=6, iterations=3, reg=0.05,
              block_len=4, s_max=2, factor_sharding=sharding,
              checkpoint_dir=str(tmp_path), resume=True)
    ctx = ComputeContext.create(device="cpu", mesh_shape=mesh_shape)
    a = als.train_als(ctx, rows, cols, vals, **kw)
    b = als.train_als(ctx, rows, cols, vals, **kw)
    assert np.array_equal(a.user_factors, b.user_factors)
    assert np.array_equal(a.item_factors, b.item_factors)
    jctx = JaxContext.create(
        mesh_shape=mesh_shape,
        devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    want = jals.train_als(jctx, rows, cols, vals, **kw)
    np.testing.assert_allclose(a.user_factors, want.user_factors,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a.item_factors, want.item_factors,
                               rtol=1e-4, atol=1e-5)


def test_segment_mean_repeats_and_matches_numpy():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 7, 500)
    codes[codes == 5] = 6  # segment 5 empty
    vals = rng.random(500).astype(np.float32) * 100
    got = helloworld.segment_mean(torch.from_numpy(codes),
                                  torch.from_numpy(vals), 8)
    again = helloworld.segment_mean(torch.from_numpy(codes),
                                    torch.from_numpy(vals), 8)
    assert torch.equal(got, again)
    want = [vals[codes == s].mean() if (codes == s).any() else 0.0
            for s in range(8)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got[5] == 0 and got[7] == 0


def _code_tokens(path: pathlib.Path) -> str:
    """The source with its comments and strings (docstrings too) taken
    out."""
    toks = tokenize.generate_tokens(io.StringIO(path.read_text()).readline)
    return " ".join(t.string for t in toks
                    if t.type not in (tokenize.COMMENT, tokenize.STRING))


@pytest.mark.parametrize("module", ["ops/als.py", "models/helloworld.py"])
def test_no_atomic_adds_in_the_sources(module):
    code = _code_tokens(ROOT / "predictionio_tpu_torch" / module)
    for name in ("index_add_", "index_add", "scatter_add", "scatter_add_",
                 "scatter_reduce", "accumulate"):
        assert name not in code.split(), (module, name)
