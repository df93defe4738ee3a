"""Model-sharded ALS: the port's ``ops/als.py`` on CPU meshes against the
JAX package's on its 8 virtual devices (JAX ``tests/test_als.py``
``TestShardedFactors`` and the mesh cases of ``TestSolveCorrectness``).

The same numpy interactions go through both packages; the port's mesh is
logical CPU devices (``ComputeContext.create(device="cpu",
mesh_shape=...)``). Tolerances, stated per check:

* ``plan_shards``: identical arrays and counts (host numpy in both);
* three epochs from one shared iteration-0 checkpoint (``jax.random``
  cannot be reproduced), port (4, 2) / (8, 1) / (1, 8) / (2, 2) against
  JAX's 8-device run of the same layout: rtol 1e-4 / atol 1e-5 (the JAX
  package's own 8-device-vs-1-device tolerance; the packages sum the
  Gramians in different orders);
* port mesh against the port on one device: the same tolerance (the
  heavy owners' partial stats are summed over ``data`` in another
  order), and the sharded factors genuinely split
  (``check_factor_sharding``);
* the device layout: a ``P(model)`` ShardedTensor whose phantom rows are
  exactly zero, staged for serving with no copy.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.parallel import partition
from predictionio_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    ComputeContext,
    ShardedTensor,
)

TOL = dict(rtol=1e-4, atol=1e-5)
N_USERS, N_ITEMS, RANK = 24, 18, 4


def _data(heavy=False):
    """JAX ``TestShardedFactors._data``: 600 interactions, deduplicated;
    ``heavy`` adds rows far above ``s_max · block_len`` on both sides."""
    rng = np.random.default_rng(21)
    nnz = 600
    rows = rng.integers(0, N_USERS, nnz).astype(np.int32)
    cols = rng.integers(0, N_ITEMS, nnz).astype(np.int32)
    vals = rng.integers(1, 5, nnz).astype(np.float32)
    if heavy:
        hr = np.concatenate([np.zeros(60, np.int32), np.ones(60, np.int32)])
        hc = np.concatenate([np.arange(60, dtype=np.int32) % N_ITEMS,
                             np.zeros(60, np.int32)])
        rows = np.concatenate([rows, hr])
        cols = np.concatenate([cols, hc])
        vals = np.concatenate([vals, np.ones(120, np.float32)])
    _, keep = np.unique(rows.astype(np.int64) * 1000 + cols,
                        return_index=True)
    return rows[keep], cols[keep], vals[keep]


@pytest.fixture(scope="module")
def jctx42():
    return JaxContext.create(batch="als-2d", mesh_shape=(4, 2))


@pytest.fixture(scope="module")
def jctx8():
    return JaxContext.create(batch="als-1d")


def _mesh(shape):
    return ComputeContext.create(batch="als", device="cpu", mesh_shape=shape)


def _start(path, seed=5):
    rng = np.random.default_rng(seed)
    als._write_checkpoint(
        als.checkpoint_path(str(path)), iteration=0,
        item_factors=(rng.standard_normal((N_ITEMS, RANK)) / 3).astype(
            np.float32),
        user_factors=np.zeros((N_USERS, RANK), np.float32),
    )


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("max_slab_slots", [0, 64], ids=["whole", "split"])
@pytest.mark.parametrize("side", ["users", "items"])
def test_plan_shards_identical(side, max_slab_slots, n_shards):
    rows, cols, vals = _data(heavy=True)
    n = N_USERS
    if side == "items":
        rows, cols, n = cols, rows, N_ITEMS
    kw = dict(block_len=4, row_multiple=n_shards, s_max=2,
              max_slab_slots=max_slab_slots)
    want = jals.plan_shards(jals.build_bucketed(rows, cols, vals, n, **kw),
                            n_shards)
    packed = als.build_bucketed(rows, cols, vals, n, **kw)
    got = als.plan_shards(packed, n_shards)
    assert want.heavy is not None
    for field in ("inv_perm_dm", "heavy_owner_local"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    for field in ("idx", "weights", "valid"):
        np.testing.assert_array_equal(getattr(got.heavy, field),
                                      getattr(want.heavy, field))
    assert (got.c_local, got.n_heavy_slots_local, got.n_shards) == (
        want.c_local, want.n_heavy_slots_local, want.n_shards)
    # every interaction lands once; inv_perm_dm is a permutation into
    # the device-major layout
    total = sum(s.weights.sum() for s in packed.slabs) + got.heavy.weights.sum()
    np.testing.assert_allclose(total, vals.sum(), rtol=1e-5)
    assert got.inv_perm_dm.max() < n_shards * got.c_local
    assert len(np.unique(got.inv_perm_dm)) == packed.n_rows_padded


_CASES = {
    # name: (port mesh, JAX mesh, factor_sharding, extra train kwargs)
    "2d-implicit": ((4, 2), (4, 2), "auto", dict(alpha=2.0)),
    "2d-heavy": ((4, 2), (4, 2), "auto", dict(s_max=2, heavy=True)),
    "2d-explicit": ((4, 2), (4, 2), "auto", dict(implicit=False)),
    "data-mesh-forced-sharded": ((8, 1), (8, 1), "sharded", {}),
    "model-8": ((1, 8), (1, 8), "auto", dict(s_max=2, heavy=True)),
    "split-slabs": ((4, 2), (4, 2), "sharded",
                    dict(s_max=2, max_slab_slots=512, heavy=True)),
    "replicated-data-8": ((8, 1), (8, 1), "auto", dict(s_max=2, heavy=True)),
    "replicated-on-2x2": ((2, 2), (4, 2), "replicated", {}),
    "replicated-heavy-on-2x2": ((2, 2), (4, 2), "replicated",
                                dict(s_max=2, heavy=True)),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_mesh_factors_match_jax(case, tmp_path):
    shape, jshape, sharding, extra = _CASES[case]
    extra = dict(extra)
    rows, cols, vals = _data(heavy=extra.pop("heavy", False))
    _start(tmp_path)
    kw = dict(n_users=N_USERS, n_items=N_ITEMS, rank=RANK, iterations=3,
              reg=0.1, block_len=4, factor_sharding=sharding,
              checkpoint_dir=str(tmp_path), resume=True, **extra)
    want = jals.train_als(JaxContext.create(mesh_shape=jshape), rows, cols,
                          vals, **kw)
    got = als.train_als(_mesh(shape), rows, cols, vals, **kw)
    np.testing.assert_allclose(got.user_factors, want.user_factors, **TOL)
    np.testing.assert_allclose(got.item_factors, want.item_factors, **TOL)


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (1, 4), (8, 1)], ids=str)
@pytest.mark.parametrize("heavy", [False, True], ids=["light", "heavy"])
def test_mesh_matches_one_device(shape, heavy):
    rows, cols, vals = _data(heavy)
    kw = dict(n_users=N_USERS, n_items=N_ITEMS, rank=RANK, iterations=3,
              reg=0.1, alpha=1.0, block_len=4, s_max=2)
    one = als.train_als(ComputeContext.create(device="cpu"), rows, cols,
                        vals, **kw)
    got = als.train_als(_mesh(shape), rows, cols, vals, **kw)
    np.testing.assert_allclose(got.user_factors, one.user_factors, **TOL)
    np.testing.assert_allclose(got.item_factors, one.item_factors, **TOL)


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)], ids=str)
def test_factors_actually_sharded(jctx42, shape):
    rows, cols, vals = _data()
    als.check_factor_sharding(_mesh(shape), rows, cols, vals, N_USERS,
                              N_ITEMS, rank=RANK, block_len=4)
    jals.check_factor_sharding(jctx42, rows, cols, vals, N_USERS, N_ITEMS,
                               rank=RANK, block_len=4)
    # a replicated copy fails the probe
    one = ComputeContext.create(device="cpu", mesh_shape=(1, 2))
    place = one.sharding()

    def replicated(ctx, side, *a, **k):
        run = make(ctx, side, *a, **k)

        def solve(y, lam):
            x = run(y, lam)
            return place.place(x.gather())
        return solve

    make = als.make_sharded_half_step
    try:
        als.make_sharded_half_step = replicated
        with pytest.raises(AssertionError, match="not model-sharded"):
            als.check_factor_sharding(one, rows, cols, vals, N_USERS,
                                      N_ITEMS, rank=RANK, block_len=4)
    finally:
        als.make_sharded_half_step = make


def test_device_layout_stages_without_a_copy(tmp_path):
    rows, cols, vals = _data()
    ctx = _mesh((2, 2))
    kw = dict(n_users=N_USERS + 1, n_items=N_ITEMS + 3, rank=RANK,
              iterations=2, reg=0.1, block_len=4)
    dev = als.train_als(ctx, rows, cols, vals, return_layout="device", **kw)
    host = als.train_als(ctx, rows, cols, vals, **kw)
    assert isinstance(dev.item_factors, ShardedTensor)
    assert dev.item_factors.shape[0] % 4 == 0
    items = dev.item_factors.gather().numpy()
    np.testing.assert_array_equal(items[:N_ITEMS + 3], host.item_factors)
    assert not items[N_ITEMS:].any()  # cold and phantom rows: zeros
    staged, mask = partition.stage_factor_matrix(ctx, dev.item_factors,
                                                 n_real=N_ITEMS + 3)
    assert staged is dev.item_factors
    assert int(mask.gather().sum()) == items.shape[0] - (N_ITEMS + 3)


@pytest.mark.parametrize("n", [0, 5, 16, 23, 24])
def test_tail_rows_reads_only_the_padded_tail(n):
    ctx = _mesh((2, 2))
    full = torch.arange(24 * 3, dtype=torch.float32).reshape(24, 3)
    placed = ctx.sharding(MODEL_AXIS).place(full)
    np.testing.assert_array_equal(als._tail_rows(placed, n).numpy(),
                                  full[n:].numpy())
    np.testing.assert_array_equal(als._tail_rows(full, n).numpy(),
                                  full[n:].numpy())


def test_sharded_checkpoints_resume(tmp_path):
    """A sharded run checkpointing every epoch, resumed on another mesh,
    lands where the uninterrupted one-device run does."""
    rows, cols, vals = _data(heavy=True)
    _start(tmp_path / "a")
    _start(tmp_path / "b")
    kw = dict(n_users=N_USERS, n_items=N_ITEMS, rank=RANK, reg=0.1,
              block_len=4, s_max=2, resume=True)
    als.train_als(_mesh((4, 2)), rows, cols, vals, iterations=2,
                  checkpoint_dir=str(tmp_path / "a"), checkpoint_every=1,
                  **kw)
    assert als.peek_checkpoint_iteration(str(tmp_path / "a")) == 1
    resumed = als.train_als(_mesh((1, 2)), rows, cols, vals, iterations=3,
                            checkpoint_dir=str(tmp_path / "a"), **kw)
    whole = als.train_als(ComputeContext.create(device="cpu"), rows, cols,
                          vals, iterations=3,
                          checkpoint_dir=str(tmp_path / "b"), **kw)
    np.testing.assert_allclose(resumed.user_factors, whole.user_factors,
                               **TOL)


def test_timer_and_one_solve_paths():
    from predictionio_tpu_torch.utils.profiling import StepTimer

    rows, cols, vals = _data()
    kw = dict(n_users=N_USERS, n_items=N_ITEMS, rank=RANK, reg=0.1,
              block_len=4)
    timer = StepTimer()
    timed = als.train_als(_mesh((2, 2)), rows, cols, vals, iterations=2,
                          timer=timer, **kw)
    fused = als.train_als(_mesh((2, 2)), rows, cols, vals, iterations=2,
                          **kw)
    assert timer.summary()["als/user_solve"]["count"] == 2
    np.testing.assert_array_equal(timed.user_factors, fused.user_factors)
    zero = als.train_als(_mesh((2, 2)), rows, cols, vals, iterations=0, **kw)
    one = als.train_als(ComputeContext.create(device="cpu"), rows, cols,
                        vals, iterations=0, **kw)
    assert zero.user_factors.any()
    assert torch.isfinite(torch.from_numpy(zero.user_factors)).all()
    # the cold init is the port's seeded draw on every mesh
    np.testing.assert_allclose(zero.item_factors, one.item_factors)
    np.testing.assert_allclose(zero.user_factors, one.user_factors, **TOL)
