"""The mesh: the port's ``parallel/mesh.py`` against the JAX package's.

The JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``);
the port builds the same shapes from logical CPU devices
(``ComputeContext.create(device="cpu", mesh_shape=...)``). Checked, all
exactly (placements are copies, no arithmetic):

* mesh facts (``n_devices``, ``data_parallelism``, ``model_parallelism``,
  the axis sizes) of the default and explicit shapes, and the refusal of
  a shape that does not cover the devices (JAX ``tests/test_mesh.py``);
* ``shard_rows``: the padded global array, one block per data index,
  and the ``pio_mesh_pad_rows_total`` counter registered with the JAX
  package's name and help text and counting the same phantom rows;
* placements of every spec kind against the JAX package's
  ``NamedSharding`` blocks (``addressable_shards`` per device);
* ``ShardedTensor.take_rows`` / ``gather`` / ``map``, and the CUDA
  context's refusals when there is no card.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as JP

from predictionio_tpu.obs import get_registry as jax_registry
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ComputeContext,
    NoDeviceError,
    P,
    ShardedTensor,
)

PAD_HELP = ("Phantom rows added when padding arrays to a mesh-axis "
            "multiple (shard_rows / sharded factor staging)")
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]


def _pair(shape):
    return (JaxContext.create(batch="t", mesh_shape=shape),
            ComputeContext.create(batch="t", device="cpu", mesh_shape=shape))


def test_default_mesh_all_data():
    jctx = JaxContext.create(batch="t")
    ctx = ComputeContext.create(batch="t", device="cpu")
    assert jctx.data_parallelism == len(jax.devices())
    assert (ctx.n_devices, ctx.data_parallelism, ctx.model_parallelism) == (
        1, 1, 1)
    # an explicit list of logical devices takes the same default shape
    logical = ComputeContext.create(devices=["cpu"] * 8)
    assert (logical.data_parallelism, logical.model_parallelism) == (
        jctx.data_parallelism, jctx.model_parallelism)
    assert logical.device == torch.device("cpu")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mesh_facts_match(shape):
    jctx, ctx = _pair(shape)
    assert ctx.mesh.shape == dict(jctx.mesh.shape)
    assert (ctx.n_devices, ctx.data_parallelism, ctx.model_parallelism) == (
        jctx.n_devices, jctx.data_parallelism, jctx.model_parallelism)
    assert ctx.mesh.axis_names == tuple(jctx.mesh.axis_names)


def test_bad_shape_rejected():
    with pytest.raises(ValueError, match="does not cover"):
        JaxContext.create(mesh_shape=(3, 5))
    with pytest.raises(ValueError, match="does not cover"):
        ComputeContext.create(devices=["cpu"] * 8, mesh_shape=(3, 5))


def test_cuda_mesh_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kwargs in ({}, {"mesh_shape": (1, 4)},
                   {"devices": ["cuda:0"] * 4, "mesh_shape": (1, 4)}):
        with pytest.raises(NoDeviceError, match="no CUDA device"):
            ComputeContext.create(**kwargs)
    # a CUDA mesh wider than the visible cards raises; an explicit list
    # of one card repeated is the way to logical devices on it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        ComputeContext.create(mesh_shape=(1, 4))
    ctx = ComputeContext.create(devices=["cuda:0"] * 4, mesh_shape=(1, 4))
    assert ctx.model_parallelism == 4
    assert set(ctx.mesh.devices.flat) == {torch.device("cuda", 0)}
    assert ctx.local_devices == [torch.device("cuda", 0)]


@pytest.mark.parametrize("n_rows", [3, 16], ids=["padded", "whole"])
def test_shard_rows_counts_padding_like_jax(n_rows):
    jctx, ctx = _pair((8, 1))
    # the same counter, with the JAX package's name and help text
    counter = get_registry().counter("pio_mesh_pad_rows_total", PAD_HELP)
    jcounter = jax_registry().counter("pio_mesh_pad_rows_total", PAD_HELP)
    before, jbefore = counter.value, jcounter.value
    arr = np.arange(2 * n_rows, dtype=np.float32).reshape(n_rows, 2)
    want = jctx.shard_rows(arr)
    got = ctx.shard_rows(arr)
    assert isinstance(got, ShardedTensor) and got.shape == want.shape
    np.testing.assert_array_equal(got.gather().numpy(), np.asarray(want))
    assert sorted(s.shape[0] for s in got.addressable_shards) == sorted(
        s.data.shape[0] for s in want.addressable_shards)
    assert counter.value - before == jcounter.value - jbefore
    assert counter.value - before == (5 if n_rows == 3 else 0)
    assert "pio_mesh_pad_rows_total" in get_registry().render_prometheus()
    # pad_rows: the same rows as one tensor on the home device
    np.testing.assert_array_equal(ctx.pad_rows(arr).numpy(),
                                  np.asarray(want))


_SPECS = [P(), P(DATA_AXIS), P(MODEL_AXIS, None), P((DATA_AXIS, MODEL_AXIS)),
          P((DATA_AXIS, MODEL_AXIS), None), P(None, MODEL_AXIS)]


@pytest.mark.parametrize("spec", _SPECS, ids=repr)
@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=str)
def test_placements_hold_the_jax_blocks(shape, spec):
    jctx, ctx = _pair(shape)
    arr = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    want = jax.device_put(arr, NamedSharding(jctx.mesh, JP(*spec)))
    got = ctx.sharding(*spec).place(arr)
    # JAX's devices in mesh order against the port's positions
    by_dev = {s.device: np.asarray(s.data) for s in want.addressable_shards}
    for pos, jdev in enumerate(jctx.mesh.devices.flat):
        np.testing.assert_array_equal(got.shards[pos].numpy(), by_dev[jdev])
    np.testing.assert_array_equal(got.gather().numpy(), arr)


def test_take_rows_map_and_replicate():
    ctx = ComputeContext.create(device="cpu", mesh_shape=(2, 4))
    arr = np.random.default_rng(0).normal(size=(12, 3)).astype(np.float32)
    st = ctx.model_sharded.place(arr)
    idx = np.array([11, 0, 3, 3, 7, 8])
    np.testing.assert_array_equal(st.take_rows(idx).numpy(), arr[idx])
    doubled = st.map(lambda t: 2 * t)
    np.testing.assert_array_equal(doubled.gather().numpy(), 2 * arr)
    norms = st.map(lambda t: t.norm(dim=1))
    np.testing.assert_allclose(norms.gather().numpy(),
                               np.linalg.norm(arr, axis=1), rtol=1e-6)
    assert norms.shape == (12,)
    # the data-axis replicas share one tensor on a shared device
    assert st.shards[0] is st.shards[4]
    assert st.nbytes == arr.nbytes
    assert torch.equal(ctx.replicate(st), torch.from_numpy(arr))
    assert not distributed.is_initialized()
