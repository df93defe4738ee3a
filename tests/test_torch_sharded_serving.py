"""Serving from a catalog sharded over ``model``: the port against the JAX
package, whose GSPMD shards the same computation over its 8 virtual CPU
devices.

* ``top_k_dot`` / ``top_k_cosine`` over a catalog staged with
  ``stage_factor_matrix`` on (1, 2), (2, 4), (4, 2) and (1, 8) meshes, in
  float32, bf16 and int8 (each shard quantized alone, which equals the
  slice of the whole table's quantization), with the phantom mask and
  with a ``[B, I]`` mask that leaves some rows fewer rankable items than
  ``num``: indices exactly equal, scores within 1e-5 absolute + 1e-5
  relative (the packages sum the k products in different orders);
* ``gather_top_k_dot`` from a sharded user table, and the similar-product
  ``gather_mean_top_k_cosine``, the same way;
* the slice as a whole: both packages' ``run_train`` on a (2, 4) mesh
  from one iteration-0 checkpoint, then each package's engine server on
  that mesh: ``GET /`` reports ``"mesh": {"data": 2, "model": 4}`` and
  ``"modelSharded": true`` in both, and the ``/queries.json`` answers
  name the same items (ties within 1e-4 aside) with scores within rtol
  1e-3 / atol 1e-4 (``test_torch_train.py`` states why).

On the CPU each shard runs the kernel's plain version; on the card each
shard launches the kernel (``chip_smoke.py`` phase 19).
"""

import json
import urllib.request

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from predictionio_tpu.ops import quantize as jq
from predictionio_tpu.ops import similarity as jsim
from predictionio_tpu.parallel import partition as jpart
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu_torch.ops import quantize, similarity
from predictionio_tpu_torch.parallel import partition
from predictionio_tpu_torch.parallel.mesh import ComputeContext, ShardedTensor

TOL = dict(rtol=1e-5, atol=1e-5)
N_ITEMS, N_USERS, K, B = 1001, 37, 8, 7
FORMS = ("f32", "bf16", "int8")
SHAPES = [(1, 2), (2, 4), (4, 2), (1, 8)]


def _ctxs(shape):
    import jax

    n = shape[0] * shape[1]
    return (JaxContext.create(batch="serve", mesh_shape=shape,
                              devices=jax.devices()[:n]),
            ComputeContext.create(batch="serve", device="cpu",
                                  mesh_shape=shape))


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    items = rng.standard_normal((N_ITEMS, K)).astype(np.float32)
    items[[10, 600, 999]] = items[3] * 4.0  # exact ties across shards
    users = rng.standard_normal((N_USERS, K)).astype(np.float32)
    q = rng.standard_normal((B, K)).astype(np.float32)
    return q, items, users


def _form(pkg_quantize, staged, form):
    if form == "f32":
        return staged
    return pkg_quantize.quantize_factors(staged, form)


def _close(got, want):
    gs, gi = (t.numpy() for t in got)
    ws, wi = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, **TOL)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_sharded_top_k_matches_jax(shape, form):
    jctx, ctx = _ctxs(shape)
    q, items, _ = _tables()
    staged, mask = partition.stage_factor_matrix(ctx, items, n_real=N_ITEMS)
    jstaged, jmask = jpart.stage_factor_matrix(jctx, items, n_real=N_ITEMS)
    assert isinstance(staged, ShardedTensor)
    table, jtable = _form(quantize, staged, form), _form(jq, jstaged, form)
    if form == "int8":
        # per-row quantization is row-local: the shards' tables are the
        # slices of the whole table's
        whole = quantize.quantize_factors(staged.gather(), "int8")
        assert torch.equal(table.data.gather(), whole.data)
        assert torch.equal(table.scale.gather(), whole.scale)
    # a [B, I] mask: row 0 keeps 3 items, row 1 none, the rest most
    rng = np.random.default_rng(1)
    rows = rng.uniform(size=(B, staged.shape[0])) < 0.2
    rows[0] = True
    rows[0, [5, 700, 20]] = False
    rows[1] = True
    rows[:, N_ITEMS:] = True  # the phantom rows too
    qt = torch.from_numpy(q)
    for num in (1, 10, 64, N_ITEMS):
        _close(similarity.top_k_dot(qt, table, num, mask),
               jsim.top_k_dot(jnp.asarray(q), jtable, num, jmask))
        _close(similarity.top_k_dot(qt, table, num, torch.from_numpy(rows)),
               jsim.top_k_dot(jnp.asarray(q), jtable, num, jnp.asarray(rows)))
        _close(similarity.top_k_dot(qt[:1], table, num, mask),
               jsim.top_k_dot(jnp.asarray(q[:1]), jtable, num, jmask))
    got = similarity.top_k_cosine(qt, table, 10, mask)
    want = jsim.top_k_cosine(jnp.asarray(q), jtable, 10, jmask)
    _close(got, want)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", [(2, 4), (1, 8)], ids=str)
def test_sharded_gathers_match_jax(shape, form):
    jctx, ctx = _ctxs(shape)
    _, items, users = _tables(3)
    st_i, mask = partition.stage_factor_matrix(ctx, items, n_real=N_ITEMS)
    st_u, _ = partition.stage_factor_matrix(ctx, users, n_real=N_USERS)
    j_i, jmask = jpart.stage_factor_matrix(jctx, items, n_real=N_ITEMS)
    j_u, _ = jpart.stage_factor_matrix(jctx, users, n_real=N_USERS)
    table, jtable = _form(quantize, st_i, form), _form(jq, j_i, form)
    idx = np.array([0, 36, 5, 5, 17, 30, 1, 2], np.int32)
    _close(similarity.gather_top_k_dot(st_u, idx, table, 16, mask),
           jsim.gather_top_k_dot(j_u, jnp.asarray(idx), jtable, 16, jmask))
    basket = np.array([3, 999, 40, -1], np.int32)
    _close(similarity.gather_mean_top_k_cosine(table, basket, 12, mask),
           jsim.gather_mean_top_k_cosine(jtable, jnp.asarray(basket), 12,
                                         jmask))


def test_one_device_is_one_launch_and_no_merge():
    ctx = ComputeContext.create(device="cpu")
    _, items, _ = _tables()
    staged, mask = partition.stage_factor_matrix(ctx, items)
    assert isinstance(staged, torch.Tensor) and mask is None
    assert similarity.stage_factors(staged, "cpu") is staged


# -- the slice as a whole -----------------------------------------------------


def test_train_and_serve_on_a_mesh_like_jax(tmp_path):
    from test_torch_train import (
        N_EVENTS,
        VARIANT,
        _events,
        _post,
        _start_checkpoint,
        _storage,
    )

    from predictionio_tpu.core.persistence import (
        deserialize_models as jax_deserialize,
        load_generation as jax_load_generation,
    )
    from predictionio_tpu.core.workflow import run_train as jax_run_train
    from predictionio_tpu.data.event import Event as JaxEvent
    from predictionio_tpu.data.storage import (
        App as JaxApp,
        Storage as JaxStorage,
        set_storage as jax_set_storage,
    )
    from predictionio_tpu.models.recommendation import (
        recommendation_engine as jax_engine,
    )
    from predictionio_tpu.serving.engine_server import (
        EngineServer as JaxServer,
    )
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import (
        App,
        Storage,
        set_storage,
    )
    from predictionio_tpu_torch.models.recommendation import (
        recommendation_engine,
    )
    from predictionio_tpu_torch.serving.engine_server import (
        create_engine_server,
    )

    jctx, ctx = _ctxs((2, 4))
    events = _events(Event)
    users = sorted({e.entity_id for e in events})
    n_items = len({e.target_entity_id for e in events})
    _start_checkpoint(tmp_path / "ckpt", len(users), n_items)
    kw = dict(checkpoint_dir=str(tmp_path / "ckpt"), resume=True)
    jax_storage = _storage(JaxStorage, JaxApp, JaxEvent, tmp_path / "jax")
    engine = jax_engine()
    jax_set_storage(jax_storage)
    try:
        jax_id = jax_run_train(engine, engine.params_from_variant(VARIANT),
                               "rec", storage=jax_storage, ctx=jctx, **kw)
    finally:
        jax_set_storage(None)
    storage = _storage(Storage, App, Event, tmp_path / "port")
    engine = recommendation_engine()
    set_storage(storage)
    try:
        run_train(engine, engine.params_from_variant(VARIANT), "rec",
                  ctx=ctx, storage=storage, watermark={"events": N_EVENTS},
                  **kw)
    finally:
        set_storage(None)

    queries = ([{"user": u, "num": n}
                for u, n in zip(users, [1, 3, 5, 10, 40] * 20)]
               + [{"user": "nobody", "num": 4}])
    engine = jax_engine()
    jax_es = JaxServer(engine, engine.params_from_variant(VARIANT), "rec",
                       storage=jax_storage, ctx=jctx)
    jax_http = jax_es.serve(host="127.0.0.1", port=0)
    jax_http.start()
    engine = recommendation_engine()
    es, http = create_engine_server(
        engine, engine.params_from_variant(VARIANT), "rec",
        host="127.0.0.1", port=0, storage=storage, ctx=ctx,
        max_batch=8, max_wait_ms=1.0,
    )
    http.start()
    try:
        bases = {"jax": f"http://127.0.0.1:{jax_http.port}",
                 "port": f"http://127.0.0.1:{http.port}"}
        answers = {pkg: [_post(base, q) for q in queries]
                   for pkg, base in bases.items()}
        status = {}
        for pkg, base in bases.items():
            with urllib.request.urlopen(base + "/", timeout=30) as resp:
                status[pkg] = json.loads(resp.read())
    finally:
        jax_http.shutdown()
        jax_es.close()
        es.close()
    for pkg in ("jax", "port"):
        assert status[pkg]["mesh"] == {"data": 2, "model": 4}
        assert status[pkg]["modelSharded"] is True
    assert status["port"]["device"] == "cpu"
    got, want = answers["port"], answers["jax"]
    assert got[-1] == want[-1] == {"itemScores": []}
    (jax_model,) = [m for _tag, m in jax_deserialize(jax_load_generation(
        jax_storage.get_model_data_models(), jax_id))]
    scores = np.asarray(jax_model.user_factors, np.float64) @ np.asarray(
        jax_model.item_factors, np.float64).T
    swaps = 0
    for q, g, w in zip(queries[:-1], got, want):
        g_items = [e["item"] for e in g["itemScores"]]
        w_items = [e["item"] for e in w["itemScores"]]
        assert len(g_items) == len(set(g_items)) == min(q["num"], n_items)
        row = scores[jax_model.user_map(q["user"])]
        for gi, wi in zip(g_items, w_items):
            if gi != wi:
                swaps += 1
                gap = abs(row[jax_model.item_map(gi)]
                          - row[jax_model.item_map(wi)])
                assert gap <= 1e-4, (q, gi, wi, gap)
        np.testing.assert_allclose(
            [e["score"] for e in g["itemScores"]],
            [e["score"] for e in w["itemScores"]], rtol=1e-3, atol=1e-4)
    assert swaps <= len(queries) // 10
