"""The serving slice end to end: the port against the JAX package.

The same numpy ALS model answers through the JAX package's
``ALSAlgorithm.stage_model`` + ``batch_predict`` and through the port's.
Item lists must be identical and scores within 1e-5 absolute / 1e-5
relative: XLA-CPU and torch-CPU sum the k products in different orders,
and the factors are drawn so neighbouring scores differ by far more. On
the CPU the JAX package serves through its XLA path (its Pallas kernel
only auto-selects on a TPU) and the port through the kernel's plain
version; the kernel contract itself is held in ``test_torch_topk.py``.

Then a generation the JAX package published deploys through the port's
``load_deployment``, a corrupt or disallowed blob is quarantined with
fallback to the last good one, and the port's ``EngineServer`` answers
over real HTTP.
"""

import datetime as dt
import json
import os
import pickle
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.core.persistence import (
    publish_generation as jax_publish,
    serialize_models as jax_serialize,
)
from predictionio_tpu.data.storage.localfs import LocalFSModels as JaxFS
from predictionio_tpu.models.recommendation import (
    ALSAlgorithm as JaxALS,
    ALSRecModel as JaxModel,
)
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.convert import als_model_from_numpy, from_jax_model
from predictionio_tpu_torch.core.persistence import (
    ModelIntegrityError,
    publish_generation,
    serialize_models,
)
from predictionio_tpu_torch.core.workflow import load_deployment
from predictionio_tpu_torch.data.storage import EngineInstance, Storage
from predictionio_tpu_torch.models.recommendation import (
    ALSAlgorithm,
    recommendation_engine,
)
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.utils.bimap import BiMap
from predictionio_tpu_torch.serving.engine_server import (
    EngineServer,
    create_engine_server,
)

N_USERS, N_ITEMS, RANK = 48, 2500, 8
QUERIES = (
    [{"user": f"u{i}", "num": n} for i, n in
     zip(range(0, 48, 3), [1, 3, 10, 17, 64, 5, 2, 8] * 2)]
    + [{"user": "u5"}, {"user": "nobody", "num": 4},
       {"user": "u7", "num": 4000}]
)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(42)
    users = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    items = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    return users, items


@pytest.fixture(scope="module")
def jax_model(factors):
    users, items = factors
    return JaxModel(
        user_factors=users,
        item_factors=items,
        user_map=JaxBiMap([f"u{i}" for i in range(N_USERS)]),
        item_map=JaxBiMap([f"i{i}" for i in range(N_ITEMS)]),
    )


@pytest.fixture(scope="module")
def jax_answers(jax_model):
    algo = JaxALS()
    staged = algo.stage_model(JaxContext.create(), jax_model)
    return algo.batch_predict(staged, list(QUERIES))


@pytest.fixture()
def cpu():
    return ComputeContext.create(device="cpu")


def _assert_same_answers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [e["item"] for e in g["itemScores"]] == [
            e["item"] for e in w["itemScores"]
        ]
        np.testing.assert_allclose(
            [e["score"] for e in g["itemScores"]],
            [e["score"] for e in w["itemScores"]],
            **TOL,
        )


def _storage(tmp_path):
    return Storage(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    })


def _instance(storage, minutes_ago=0):
    t = dt.datetime.now(dt.timezone.utc) - dt.timedelta(minutes=minutes_ago)
    return storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=t, end_time=t,
        engine_id="rec", engine_version="1", engine_variant="default",
        engine_factory="recommendation",
    ))


def _params():
    engine = recommendation_engine()
    return engine, engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]}
    )


def test_batch_predict_matches_jax(jax_model, jax_answers, cpu):
    algo = ALSAlgorithm()
    staged = algo.stage_model(cpu, from_jax_model(jax_model))
    assert staged.user_factors.device.type == "cpu"
    assert staged.item_phantom_mask is None
    got = algo.batch_predict(staged, list(QUERIES))
    _assert_same_answers(got, jax_answers)
    assert got[-2] == {"itemScores": []}  # unknown user
    assert len(got[-1]["itemScores"]) == N_ITEMS  # num clamps to catalog
    _assert_same_answers([algo.predict(staged, QUERIES[2])], [got[2]])


def test_phantom_rows_never_served(factors, cpu):
    users, items = factors
    model = als_model_from_numpy(
        users, np.vstack([items, np.full((3, RANK), 50.0, np.float32)]),
        [f"u{i}" for i in range(N_USERS)],
        [f"i{i}" for i in range(N_ITEMS)] + ["x0", "x1", "x2"],
    )
    # the id map knows fewer rows than the table holds
    model.item_map = BiMap([f"i{i}" for i in range(N_ITEMS)])
    staged = ALSAlgorithm().stage_model(cpu, model)
    assert staged.item_phantom_mask.shape == (N_ITEMS + 3,)
    out = ALSAlgorithm().batch_predict(staged, [{"user": "u1", "num": 20}])
    assert all(e["item"].startswith("i") for e in out[0]["itemScores"])


def test_jax_published_generation_deploys(tmp_path, jax_model, jax_answers,
                                          cpu):
    storage = _storage(tmp_path)
    iid = _instance(storage)
    blob = jax_serialize(iid, [JaxALS()], [jax_model])
    jax_publish(JaxFS({"PATH": str(tmp_path)}), iid, blob)
    engine, params = _params()
    instance, algos, models, serving = load_deployment(
        engine, params, "rec", ctx=cpu, storage=storage
    )
    assert instance.id == iid
    assert isinstance(models[0].item_factors, torch.Tensor)
    got = [
        serving.serve(q, [p])
        for q, p in zip(QUERIES, algos[0].batch_predict(models[0],
                                                        list(QUERIES)))
    ]
    _assert_same_answers(got, jax_answers)


def test_corrupt_generation_quarantined_with_fallback(tmp_path, jax_model,
                                                     cpu):
    storage = _storage(tmp_path)
    models_store = storage.get_model_data_models()
    port_model = from_jax_model(jax_model)
    good = _instance(storage, minutes_ago=10)
    publish_generation(
        models_store, good, serialize_models(good, [ALSAlgorithm()],
                                             [port_model])
    )
    bad = _instance(storage, minutes_ago=5)
    blob = bytearray(serialize_models(bad, [ALSAlgorithm()], [port_model]))
    publish_generation(models_store, bad, bytes(blob))
    blob[len(blob) // 2] ^= 0xFF  # a flipped byte after publish
    (tmp_path / f"pio_model_{bad}.bin").write_bytes(bytes(blob))
    engine, params = _params()
    instance, *_ = load_deployment(engine, params, "rec", ctx=cpu,
                                   storage=storage)
    assert instance.id == good
    assert models_store.get(bad) is None
    assert any(".quarantined." in n for n in os.listdir(tmp_path))
    # an explicit instance id never falls back: it raises
    publish_generation(models_store, bad, bytes(blob))
    (tmp_path / f"pio_model_{bad}.bin").write_bytes(b"torn")
    with pytest.raises(ModelIntegrityError):
        load_deployment(engine, params, "rec", instance_id=bad, ctx=cpu,
                        storage=storage)


def test_disallowed_class_in_blob_refused(tmp_path, jax_model, cpu):
    storage = _storage(tmp_path)
    models_store = storage.get_model_data_models()
    good = _instance(storage, minutes_ago=10)
    publish_generation(
        models_store, good,
        serialize_models(good, [ALSAlgorithm()], [from_jax_model(jax_model)]),
    )
    evil = _instance(storage, minutes_ago=1)
    blob = pickle.dumps(
        {"version": 1, "entries": [("auto", os.system)]}
    )
    publish_generation(models_store, evil, blob)
    engine, params = _params()
    instance, *_ = load_deployment(engine, params, "rec", ctx=cpu,
                                   storage=storage)
    assert instance.id == good
    assert models_store.get(evil) is None


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def served(tmp_path, jax_model, cpu):
    storage = _storage(tmp_path)
    iid = _instance(storage)
    jax_publish(JaxFS({"PATH": str(tmp_path)}), iid,
                jax_serialize(iid, [JaxALS()], [jax_model]))
    engine, params = _params()
    es, http = create_engine_server(
        engine, params, "rec", host="127.0.0.1", port=0, storage=storage,
        ctx=cpu, max_batch=8, max_wait_ms=1.0,
    )
    http.start()
    yield f"http://127.0.0.1:{http.port}", es
    es.close()


def test_engine_server_answers_over_http(served, jax_answers):
    base, es = served
    status, data = _call(base + "/")
    assert status == 200 and data["warmed"] is True
    got = []
    for q in QUERIES:
        status, out = _call(base + "/queries.json", q)
        assert status == 200
        got.append(out)
    _assert_same_answers(got, jax_answers)
    status, out = _call(base + "/batch/queries.json", list(QUERIES) + [7])
    assert status == 200
    assert [r["status"] for r in out] == [200] * len(QUERIES) + [400]
    _assert_same_answers([r["prediction"] for r in out[:-1]], jax_answers)
    assert _call(base + "/queries.json", [1])[0] == 400
    assert _call(base + "/nowhere")[0] == 404
    status, data = _call(base + "/")
    assert data["requestCount"] == 2 * len(QUERIES) + 1


@pytest.mark.parametrize("option, needle", [
    ({"quantize": "int4"}, "quantize mode"),
    ({"log_url": "collector.internal/log"}, "log-url"),
    ({"tenants": {"a": "v"}, "canary": True}, "mutually exclusive"),
])
def test_engine_server_refuses_bad_options(tmp_path, cpu, option, needle):
    """Refused before anything loads, with the JAX package's messages."""
    engine, params = _params()
    with pytest.raises(ValueError, match=needle):
        EngineServer(engine, params, "rec", storage=_storage(tmp_path),
                     ctx=cpu, **option)


@pytest.mark.parametrize("depth", [0, 2])
def test_micro_batcher_coalesces_sheds_and_drains(depth):
    from predictionio_tpu_torch.serving.batching import (
        BatcherOverloaded,
        MicroBatcher,
        TwoPhaseBatchFn,
    )
    import threading

    gate = threading.Event()
    batches = []

    def dispatch(items):
        gate.wait(10)
        batches.append(list(items))
        return [x * 2 for x in items]

    b = MicroBatcher(
        TwoPhaseBatchFn(dispatch, lambda handle: handle),
        max_batch=4, max_wait_ms=50.0, max_queue=6, pipeline_depth=depth,
    )
    try:
        first = b.submit(0)  # the collector takes it and blocks in dispatch
        deadline = dt.datetime.now() + dt.timedelta(seconds=5)
        while not first.running() and dt.datetime.now() < deadline:
            pass
        futs = [b.submit(i) for i in range(1, 7)]
        with pytest.raises(BatcherOverloaded):
            b.submit(99)
        assert futs[0].cancel()  # cancelled before launch: dropped
        gate.set()
        assert first.result(10) == 0
        assert [f.result(10) for f in futs[1:]] == [4, 6, 8, 10, 12]
    finally:
        gate.set()
        b.close()
    assert batches[0] == [0]
    assert all(len(x) <= 4 for x in batches) and 1 not in sum(batches, [])
    with pytest.raises(RuntimeError):
        b.submit(1)
