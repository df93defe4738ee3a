"""The rule engine: the port's ``parallel/partition.py`` against the JAX
package's (JAX ``tests/test_partition.py``), on the same trees.

Every case runs both packages, each with its own spec type, and compares
the specs as tuples and the placed blocks exactly (placements copy, no
arithmetic): rule matching (first wins, scalar leaves never
partitioned, an unmatched leaf an error, leaf names), validation against
a mesh, the ALS rule tables' placements on a (4, 2) and an (8, 1) mesh,
topology shapes, ``stage_factor_matrix`` (pad, phantom mask, the
pass-through of a value already placed, the refusal of a device tensor
that is not a whole number of model-axis rows), and the phantom-row
invariant.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as JP

from predictionio_tpu.parallel import partition as jpart
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu.parallel.mesh import (
    assert_phantom_rows_zero as jax_phantom,
)
from predictionio_tpu_torch.parallel import partition
from predictionio_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ComputeContext,
    P,
    ShardedTensor,
    assert_phantom_rows_zero,
)


@pytest.fixture(scope="module")
def ctxs42():
    return (JaxContext.create(batch="pt-2d", mesh_shape=(4, 2)),
            ComputeContext.create(batch="pt-2d", device="cpu",
                                  mesh_shape=(4, 2)))


@pytest.fixture(scope="module")
def ctxs8():
    return (JaxContext.create(batch="pt-1d", mesh_shape=(8, 1)),
            ComputeContext.create(batch="pt-1d", device="cpu",
                                  mesh_shape=(8, 1)))


def _rules(spec_type, table):
    return tuple((pattern, spec_type(*spec)) for pattern, spec in table)


_TABLE = (
    (r"(^|/)(user|item)_factors$", (MODEL_AXIS, None)),
    (r"(^|/)idx$", (DATA_AXIS,)),
    (r".*", ()),
)


def _both(fn_name, table, *args):
    """``partition.<fn_name>`` in both packages, specs as plain tuples."""
    got = getattr(partition, fn_name)(_rules(P, table), *args)
    want = getattr(jpart, fn_name)(_rules(JP, table), *args)
    return got, want


@pytest.mark.parametrize("tree, name", [
    (None, "item_factors"),
    ({"user_factors": np.zeros((8, 4)),
      "slabs": [{"idx": np.zeros((8, 2), np.int32)}],
      "other": np.zeros((4, 4))}, None),
    ({"user_factors": np.float32(3.0), "idx": np.zeros((1,))}, None),
], ids=["first-wins", "tree-paths", "scalars"])
def test_matching_like_jax(tree, name):
    if name is not None:
        table = ((r"factors", (MODEL_AXIS, None)),
                 (r"item_factors", (DATA_AXIS, None)))
        got, want = _both("match_partition_rule", table, name)
        assert tuple(got) == tuple(want) == (MODEL_AXIS, None)
        return
    got, want = _both("match_partition_rules", _TABLE, tree)
    flat_got = [tuple(s) for s in _leaves(got)]
    flat_want = [tuple(s) for s in jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, JP))]
    assert flat_got == flat_want


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def test_unmatched_leaf_and_names_like_jax():
    table = ((r"^only_this$", ()),)
    for pkg, spec in ((partition, P), (jpart, JP)):
        with pytest.raises(ValueError, match="no partition rule"):
            pkg.match_partition_rules(_rules(spec, table),
                                      {"something_else": np.zeros((4, 4))})
    tree = {"a": [np.zeros(2), {"b": np.zeros(2)}], "c": (np.zeros(3),)}
    assert partition.tree_leaf_names(tree) == jpart.tree_leaf_names(tree)
    assert partition.tree_leaf_names(tree) == ["a/0", "a/1/b", "c/0"]


@pytest.mark.parametrize("table, bad", [
    (((r"x", ("modle",)),), "modle"),
    (((r"x", ((DATA_AXIS, "replica"), None)),), "replica"),
], ids=["typo", "inside-tuple"])
def test_validation_like_jax(ctxs42, table, bad):
    jctx, ctx = ctxs42
    for pkg, spec, c in ((partition, P, ctx), (jpart, JP, jctx)):
        with pytest.raises(ValueError, match=bad):
            pkg.validate_rules(_rules(spec, table), c.mesh)
        with pytest.raises(ValueError, match=bad):
            pkg.shard_pytree(c, _rules(spec, table), {"x": np.zeros((8, 2))})
    partition.validate_rules(partition.ALS_SHARDED_RULES, ctx.mesh)
    partition.validate_rules(partition.ALS_REPLICATED_RULES, ctx.mesh)


def test_als_tables_are_the_jax_tables():
    for got, want in ((partition.ALS_SHARDED_RULES, jpart.ALS_SHARDED_RULES),
                      (partition.ALS_REPLICATED_RULES,
                       jpart.ALS_REPLICATED_RULES)):
        assert [(p, tuple(s)) for p, s in got] == [
            (p, tuple(s)) for p, s in want]
    for sharded in (True, False):
        assert [tuple(s) for _, s in partition.als_partition_rules(
            sharded)] == [tuple(s) for _, s in jpart.als_partition_rules(
                sharded)]


def _als_tree():
    rng = np.random.default_rng(3)
    return {
        "user_factors": rng.normal(size=(16, 4)).astype(np.float32),
        "slabs": [{
            "idx": rng.integers(0, 9, (8, 4)).astype(np.int32),
            "weights": rng.normal(size=(8, 4)).astype(np.float32),
            "valid": np.ones((8, 4), np.float32),
        }],
        "heavy": {"owner": np.arange(8, dtype=np.int32)},
        "inv_perm": np.arange(16, dtype=np.int32),
    }


@pytest.mark.parametrize("sharded", [True, False],
                         ids=["sharded-4x2", "replicated-8x1"])
def test_als_placements_hold_the_jax_blocks(ctxs42, ctxs8, sharded):
    jctx, ctx = ctxs42 if sharded else ctxs8
    tree = _als_tree()
    if not sharded:
        tree = {"user_factors": tree["user_factors"],
                "idx": tree["slabs"][0]["idx"]}
    got = partition.shard_pytree(ctx, partition.als_partition_rules(sharded),
                                 tree)
    want = jpart.shard_pytree(jctx, jpart.als_partition_rules(sharded), tree)
    for g, w in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
        assert isinstance(g, ShardedTensor)
        assert tuple(g.sharding.spec) == tuple(w.sharding.spec)
        by_dev = {s.device: np.asarray(s.data)
                  for s in w.addressable_shards}
        for pos, jdev in enumerate(jctx.mesh.devices.flat):
            np.testing.assert_array_equal(g.shards[pos].numpy(),
                                          by_dev[jdev])


@pytest.mark.parametrize("args, want", [
    ((8,), (4, 2)), ((2,), (1, 2)), ((1,), (1, 1)), ((3,), (3, 1)),
    ((8, 4), (2, 4)),
], ids=["even", "two", "one", "odd", "explicit"])
def test_topology_shapes_like_jax(args, want):
    assert partition.topology_mesh_shape(*args) == want
    assert jpart.topology_mesh_shape(*args) == want


def test_topology_refusals_and_mesh_counts():
    for pkg in (partition, jpart):
        with pytest.raises(ValueError, match="does not divide"):
            pkg.topology_mesh_shape(8, 3)
    ctx = partition.mesh_from_topology(4, batch="pt-topo",
                                       devices=["cpu"] * 8)
    jctx = jpart.mesh_from_topology(4, batch="pt-topo")
    assert (ctx.n_devices, ctx.model_parallelism) == (
        jctx.n_devices, jctx.model_parallelism) == (4, 2)
    with pytest.raises(ValueError, match="have"):
        partition.mesh_from_topology(99, devices=["cpu"] * 8)


@pytest.mark.parametrize("n_rows, n_real", [(9, 9), (8, 8), (8, 6)],
                         ids=["pads", "whole", "phantoms"])
def test_stage_factor_matrix_like_jax(ctxs42, n_rows, n_real):
    jctx, ctx = ctxs42
    arr = np.random.default_rng(0).normal(size=(n_rows, 4)).astype(
        np.float32)
    got, mask = partition.stage_factor_matrix(ctx, arr, n_real=n_real)
    want, jmask = jpart.stage_factor_matrix(jctx, arr, n_real=n_real)
    assert got.shape == want.shape
    assert tuple(got.sharding.spec) == tuple(want.sharding.spec)
    np.testing.assert_array_equal(got.gather().numpy(), np.asarray(want))
    assert (mask is None) == (jmask is None)
    if mask is not None:
        np.testing.assert_array_equal(mask.gather().numpy(),
                                      np.asarray(jmask))
        assert tuple(mask.sharding.spec) == tuple(jmask.sharding.spec)


def test_staged_values_pass_through_and_refusals(ctxs42):
    jctx, ctx = ctxs42
    placed = ctx.sharding(MODEL_AXIS, None).place(
        np.zeros((8, 4), np.float32))
    staged, mask = partition.stage_factor_matrix(ctx, placed, n_real=6)
    assert staged is placed  # no copy
    assert int(mask.gather().sum()) == 2
    jplaced = jax.device_put(np.zeros((8, 4), np.float32),
                             NamedSharding(jctx.mesh, JP(MODEL_AXIS, None)))
    assert jpart.stage_factor_matrix(jctx, jplaced, n_real=6)[0] is jplaced
    # a device tensor that is not a whole number of model-axis rows
    with pytest.raises(ValueError, match="not a multiple"):
        partition.stage_factor_matrix(ctx, torch.zeros(9, 4))
    with pytest.raises(ValueError, match="not a multiple"):
        jpart.stage_factor_matrix(jctx, jax.device_put(
            np.zeros((9, 4), np.float32)))
    # one device: one tensor on it, the mask a plain [rows] tensor
    one = ComputeContext.create(device="cpu")
    t, m = partition.stage_factor_matrix(one, np.ones((5, 2)), n_real=4)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    assert m.tolist() == [False] * 4 + [True]


@pytest.mark.parametrize("tail, raises", [(0.0, False), (1e-8, True)],
                         ids=["zero-tail", "nonzero-phantom"])
def test_phantom_invariant_like_jax(tail, raises):
    arr = np.zeros((6, 3), np.float32)
    arr[:4] = 1.0
    arr[5, 1] = tail
    ctx = ComputeContext.create(device="cpu", mesh_shape=(1, 2))
    for check, value in ((jax_phantom, arr), (assert_phantom_rows_zero, arr),
                         (assert_phantom_rows_zero, torch.from_numpy(arr)),
                         (assert_phantom_rows_zero,
                          ctx.model_sharded.place(arr))):
        if raises:
            with pytest.raises(AssertionError, match="phantom-row"):
                check(value, 4, "item factors")
        else:
            check(value, 4)
