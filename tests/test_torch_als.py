"""ALS: the port's ``ops/als.py`` against the JAX package's.

The same numpy interactions (300 users × 120 items, ratings 1..5, item
popularity zipf 1.3 so a few items are heavy rows, duplicates kept) go
through both packages on the CPU. Tolerances, stated per check:

* packing (``build_bucketed``, ``build_padded_csr``): arrays identical,
  on the port's native and numpy paths, for ``row_multiple`` 1 and 8
  and a slab cap small enough to split slabs;
* ``_solve`` on non-positive-definite and empty systems: identical zeros,
  and the positive-definite rows within rtol 1e-5 / atol 1e-6;
* one half-step, float32: rtol 1e-4 / atol 1e-5 (XLA and torch sum the
  Gramians in different orders); bf16: the same tolerance, since both
  packages round the same inputs to bf16 and form exact products in
  float32 before summing;
* three epochs of ``train_als`` from one shared iteration-0 checkpoint
  (``jax.random`` cannot be reproduced), and a checkpoint of either
  package resumed by the other: rtol 1e-3 / atol 1e-4 (the half-step
  differences pass through three more solves; explicit mode with
  λ·n regularization is the less well conditioned of the two);
* ``fold_in_users``: host numpy in both, rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.parallel.mesh import ComputeContext

N_USERS, N_ITEMS, RANK, NNZ = 300, 120, 8, 6000
HALF = dict(rtol=1e-4, atol=1e-5)
EPOCHS = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def coo():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, N_USERS, NNZ).astype(np.int32)
    cols = (rng.zipf(1.3, NNZ) % N_ITEMS).astype(np.int32)
    vals = rng.integers(1, 6, NNZ).astype(np.float32)
    return rows, cols, vals


@pytest.fixture(scope="module")
def jctx1():
    import jax

    return JaxContext.create(batch="port-als", devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def jctx8():
    return JaxContext.create(batch="port-als-8")


@pytest.fixture()
def cpu():
    return ComputeContext.create(device="cpu")


def _slabs(packed):
    return [*packed.slabs, *packed.heavy]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("row_multiple", [1, 8])
@pytest.mark.parametrize("max_slab_slots", [0, 512], ids=["uncapped", "split"])
@pytest.mark.parametrize("side", ["items", "users"])
def test_build_bucketed_identical(coo, monkeypatch, native, row_multiple,
                                  max_slab_slots, side):
    rows, cols, vals = coo
    if side == "items":
        rows, cols, n = cols, rows, N_ITEMS
    else:
        n = N_USERS
    if not native:
        monkeypatch.setenv("PIO_NO_NATIVE", "1")
    assert (als._load_alspack() is not None) == native
    want = jals.build_bucketed(rows, cols, vals, n, row_multiple=row_multiple,
                               max_slab_slots=max_slab_slots)
    got = als.build_bucketed(rows, cols, vals, n, row_multiple=row_multiple,
                             max_slab_slots=max_slab_slots)
    if side == "items":
        assert got.heavy, "the zipf head must make heavy rows"
    if max_slab_slots:
        assert len(got.slabs) > len(set(s.idx.shape[1] for s in got.slabs))
    assert len(got.slabs) == len(want.slabs)
    assert len(got.heavy) == len(want.heavy)
    for g, w in zip(_slabs(got), _slabs(want)):
        for field in ("idx", "weights", "valid"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
    for g, w in zip(got.heavy_owner_pos, want.heavy_owner_pos):
        assert np.array_equal(g, w)
    assert np.array_equal(got.inv_perm, want.inv_perm)
    assert (got.n_stat_rows, got.n_rows, got.n_rows_padded) == (
        want.n_stat_rows, want.n_rows, want.n_rows_padded)
    assert got.padded_nnz == want.padded_nnz


@pytest.mark.parametrize("row_multiple,block_multiple", [(1, 1), (8, 4)])
def test_build_padded_csr_identical(coo, row_multiple, block_multiple):
    rows, cols, vals = coo
    want = jals.build_padded_csr(rows, cols, vals, N_USERS, block_len=16,
                                 row_multiple=row_multiple,
                                 block_multiple=block_multiple)
    got = als.build_padded_csr(rows, cols, vals, N_USERS, block_len=16,
                               row_multiple=row_multiple,
                               block_multiple=block_multiple)
    for field in ("idx", "weights", "valid", "owner"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
    assert (got.n_rows, got.n_rows_padded) == (want.n_rows,
                                               want.n_rows_padded)


def test_solve_zeroes_non_pd_and_empty_systems():
    """[I, diag(1,-1,1), 0] with b = 1 (explicit, λ = 0: nothing makes
    them positive definite) and one ordinary SPD system."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    m = rng.standard_normal((3, 3)).astype(np.float32)
    a = np.stack([np.eye(3), np.diag([1.0, -1.0, 1.0]), np.zeros((3, 3)),
                  m @ m.T + np.eye(3)]).astype(np.float32)
    b = np.ones((4, 3), np.float32)
    cnt = np.array([3.0, 3.0, 0.0, 3.0], np.float32)
    want = np.asarray(jals._solve(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(cnt), None, 0.0, False, 3,
                                  jnp.float32))
    got = als._solve(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(cnt), None, 0.0, False).numpy()
    assert np.array_equal(got[:3], want[:3])
    np.testing.assert_array_equal(got[1:3], 0.0)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("compute", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("implicit", [True, False],
                         ids=["implicit", "explicit"])
def test_half_step_matches_make_solve_side(coo, jctx1, cpu, implicit,
                                           compute):
    rows, cols, vals = coo
    # the item side (heavy rows present), slabs split by a small cap
    packed = jals.build_bucketed(cols, rows, vals, N_ITEMS,
                                 max_slab_slots=512)
    assert packed.heavy
    y = np.random.default_rng(1).standard_normal(
        (N_USERS, RANK)).astype(np.float32)
    slabs, heavy = jals._device_slabs(jctx1, packed)
    want = np.asarray(jals.make_solve_side(jctx1, packed, implicit, 1.0,
                                           compute)(y, slabs, heavy, 0.05))
    solve = als.make_solve_side(
        cpu, als.build_bucketed(cols, rows, vals, N_ITEMS,
                                max_slab_slots=512),
        implicit, 1.0, compute,
    )
    got = solve(torch.from_numpy(y), 0.05)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **HALF)


def _shared_checkpoint(path, seed=5):
    rng = np.random.default_rng(seed)
    als._write_checkpoint(
        als.checkpoint_path(str(path)),
        iteration=0,
        item_factors=(rng.standard_normal((N_ITEMS, RANK)) / 3).astype(
            np.float32),
        user_factors=np.zeros((N_USERS, RANK), np.float32),
    )


@pytest.mark.parametrize("implicit", [True, False],
                         ids=["implicit", "explicit"])
def test_train_als_three_epochs_from_shared_checkpoint(coo, jctx8, cpu,
                                                       tmp_path, implicit):
    rows, cols, vals = coo
    _shared_checkpoint(tmp_path)
    kw = dict(rank=RANK, iterations=3, reg=0.05, implicit=implicit,
              checkpoint_dir=str(tmp_path), resume=True,
              max_slab_slots=512)
    want = jals.train_als(jctx8, rows, cols, vals, N_USERS, N_ITEMS, **kw)
    got = als.train_als(cpu, rows, cols, vals, N_USERS, N_ITEMS, **kw)
    assert got.user_factors.shape == (N_USERS, RANK)
    assert got.item_factors.shape == (N_ITEMS, RANK)
    np.testing.assert_allclose(got.user_factors, want.user_factors,
                               **EPOCHS)
    np.testing.assert_allclose(got.item_factors, want.item_factors,
                               **EPOCHS)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(coo, jctx8, cpu, tmp_path,
                                            writer):
    """One package trains 4 epochs from the shared start, writing a
    checkpoint at epoch 2; the other resumes from that file and must
    land where the writer did."""
    rows, cols, vals = coo
    _shared_checkpoint(tmp_path / "start")
    start = als.checkpoint_path(str(tmp_path / "start"))
    mid = tmp_path / "mid"
    mid.mkdir()
    import shutil

    shutil.copy(start, als.checkpoint_path(str(mid)))
    kw = dict(rank=RANK, iterations=4, reg=0.05, checkpoint_dir=str(mid),
              checkpoint_every=2, resume=True)
    train_w, train_r = (
        (lambda: jals.train_als(jctx8, rows, cols, vals, N_USERS, N_ITEMS,
                                **kw),
         lambda: als.train_als(cpu, rows, cols, vals, N_USERS, N_ITEMS,
                               **kw))
        if writer == "jax" else
        (lambda: als.train_als(cpu, rows, cols, vals, N_USERS, N_ITEMS,
                               **kw),
         lambda: jals.train_als(jctx8, rows, cols, vals, N_USERS, N_ITEMS,
                                **kw))
    )
    full = train_w()
    assert als.peek_checkpoint_iteration(str(mid)) == 2
    assert jals.peek_checkpoint_iteration(str(mid)) == 2
    resumed = train_r()
    np.testing.assert_allclose(resumed.user_factors, full.user_factors,
                               **EPOCHS)
    np.testing.assert_allclose(resumed.item_factors, full.item_factors,
                               **EPOCHS)


@pytest.mark.parametrize("implicit", [True, False],
                         ids=["implicit", "explicit"])
def test_fold_in_users_matches(implicit):
    rng = np.random.default_rng(9)
    items = rng.standard_normal((40, RANK)).astype(np.float32)
    u = rng.integers(0, 6, 50)
    c = rng.integers(-2, 44, 50)  # some out of range: dropped
    v = rng.integers(1, 6, 50).astype(np.float32)
    kw = dict(reg=0.1, alpha=2.0, implicit=implicit)
    want = jals.fold_in_users(items, u, c, v, 7, **kw)
    got = als.fold_in_users(items, u, c, v, 7, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not got[6].any()  # no interactions: zero factors


def test_cold_init_is_seeded_and_phantoms_stay_zero(coo, cpu):
    rows, cols, vals = coo
    kw = dict(rank=RANK, iterations=2, seed=7)
    a = als.train_als(cpu, rows, cols, vals, N_USERS + 5, N_ITEMS + 3,
                      **kw)
    b = als.train_als(cpu, rows, cols, vals, N_USERS + 5, N_ITEMS + 3,
                      **kw)
    assert np.array_equal(a.item_factors, b.item_factors)
    # entities never seen solve to zero factors
    assert not a.user_factors[N_USERS:].any()
    assert not a.item_factors[N_ITEMS:].any()
    assert np.isfinite(a.user_factors).all()


def test_device_layout_and_timer(coo, cpu):
    from predictionio_tpu_torch.utils.profiling import StepTimer

    rows, cols, vals = coo
    timer = StepTimer()
    host = als.train_als(cpu, rows, cols, vals, N_USERS, N_ITEMS,
                         rank=RANK, iterations=2, timer=timer)
    assert timer.summary()["als/user_solve"]["count"] == 2
    dev = als.train_als(cpu, rows, cols, vals, N_USERS, N_ITEMS, rank=RANK,
                        iterations=2, return_layout="device")
    assert isinstance(dev.item_factors, torch.Tensor)
    assert dev.item_factors.shape[0] >= N_ITEMS
    np.testing.assert_allclose(dev.item_factors[:N_ITEMS].numpy(),
                               host.item_factors, rtol=1e-5, atol=1e-6)


def test_refused_options(coo, jctx8, tmp_path, monkeypatch):
    """``factor_sharding="sharded"`` (refused until the mesh was ported)
    now trains on a (2, 2) CPU mesh, to the JAX package's sharded
    factors on its 8 devices from one shared start (rtol 1e-3 / atol
    1e-4, as three epochs above); float16 stays refused."""
    rows, cols, vals = coo
    _shared_checkpoint(tmp_path)
    kw = dict(rank=RANK, iterations=3, reg=0.05, factor_sharding="sharded",
              checkpoint_dir=str(tmp_path), resume=True)
    want = jals.train_als(jctx8, rows, cols, vals, N_USERS, N_ITEMS, **kw)
    mesh = ComputeContext.create(device="cpu", mesh_shape=(2, 2))
    got = als.train_als(mesh, rows, cols, vals, N_USERS, N_ITEMS, **kw)
    np.testing.assert_allclose(got.user_factors, want.user_factors,
                               **EPOCHS)
    np.testing.assert_allclose(got.item_factors, want.item_factors,
                               **EPOCHS)
    with pytest.raises(ValueError, match="compute_dtype"):
        als._resolve_compute("float16")
    monkeypatch.setenv("PIO_ALS_COMPUTE_DTYPE", "bf16")
    assert als._resolve_compute(None) is torch.bfloat16
    assert als._resolve_compute("auto") is None
