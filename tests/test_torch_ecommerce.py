"""The e-commerce template: the port against the JAX package.

* ``ECommAlgorithm.predict`` on shared factors, each package reading its
  own memory store filled with the same events: known and unknown
  (popularity fallback) users, seen items, the live ``unavailableItems``
  constraint (a second ``$set`` changes the next answer), categories,
  whiteList and blackList. Equal item lists; scores within 1e-5
  absolute + 1e-5 relative (XLA-CPU and torch-CPU sum the rank products
  in other orders).
* A user whose factor row is NaN scores -inf everywhere: both packages
  answer the catalog's first items by index with score -inf
  (``lax.top_k``'s order, which the port's top-k now keeps).
* Both packages' ``run_train`` on the same events: equal interactions,
  popularity, id maps and categories.
* A generation the JAX package trained (sqlite + local model files)
  answers alike from both packages' engine servers.
"""

import datetime as dt
import json
import math
import pathlib
import urllib.request

import numpy as np
import pytest

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
from predictionio_tpu.models.ecommerce import (
    ECommAlgorithm as JaxECommAlgorithm,
    ECommAlgorithmParams as JaxECommParams,
    ECommDataSource as JaxECommDataSource,
    ECommDataSourceParams as JaxECommDSParams,
    ECommModel as JaxECommModel,
    ecommerce_engine as jax_engine,
)
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.convert import from_jax_template_model
from predictionio_tpu_torch.core.persistence import (
    deserialize_models,
    load_generation,
)
from predictionio_tpu_torch.core.registry import resolve_engine_factory
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage, set_storage
from predictionio_tpu_torch.models.ecommerce import (
    ECommAlgorithm,
    ECommAlgorithmParams,
    ECommDataSource,
    ECommDataSourceParams,
    ECommModel,
    ecommerce_engine,
)
from predictionio_tpu_torch.parallel.mesh import ComputeContext

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE_JSON = json.loads(
    (ROOT / "examples" / "ecommerce" / "engine.json").read_text()
)
APP = ENGINE_JSON["datasource"]["params"]["app_name"]
N_USERS, N_ITEMS, RANK = 30, 80, 8
TOL = dict(rtol=1e-5, atol=1e-5)
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)


@pytest.fixture()
def cpu():
    return ComputeContext.create(device="cpu")


def _events(event_cls, unavailable=("i3", "i5", "i8")):
    """Views and buys (zipf items), 1-3 of 5 categories an item (every
    7th item none), popularity ties among the cold-start candidates, and
    one ``unavailableItems`` constraint."""
    rng = np.random.default_rng(11)
    out = []
    for name, n in (("view", 600), ("buy", 90)):
        users = rng.integers(0, N_USERS, n)
        items = rng.zipf(1.3, n) % N_ITEMS
        out += [
            event_cls(event=name, entity_type="user", entity_id=f"u{u}",
                      target_entity_type="item", target_entity_id=f"i{i}",
                      event_time=T0 + dt.timedelta(seconds=j))
            for j, (u, i) in enumerate(zip(users, items))
        ]
    for i in range(N_ITEMS):
        if i % 7:
            cats = rng.choice(5, int(rng.integers(1, 4)), replace=False)
            out.append(event_cls(
                event="$set", entity_type="item", entity_id=f"i{i}",
                properties={"categories": [f"c{c}" for c in cats]},
                event_time=T0 + dt.timedelta(hours=1)))
    out.append(_constraint(event_cls, unavailable, minutes=90))
    return out


def _constraint(event_cls, items, minutes):
    return event_cls(event="$set", entity_type="constraint",
                     entity_id="unavailableItems",
                     properties={"items": list(items)},
                     event_time=T0 + dt.timedelta(minutes=minutes))


def _memory_env():
    return {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}


def _filled(storage_cls, app_cls, event_cls, env, events):
    storage = storage_cls(env=env)
    app_id = storage.get_meta_data_apps().insert(app_cls(0, APP))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(events, app_id)
    return storage


@pytest.fixture()
def stores():
    """Each package's memory store with the same events, set as its
    process default (the rules read the default store)."""
    jax_storage = _filled(JaxStorage, JaxApp, JaxEvent, _memory_env(),
                          _events(JaxEvent))
    port_storage = _filled(Storage, App, Event, _memory_env(),
                           _events(Event))
    jax_set_storage(jax_storage)
    set_storage(port_storage)
    yield jax_storage, port_storage
    jax_set_storage(None)
    set_storage(None)


def _models(seed=3, nan_user=None):
    rng = np.random.default_rng(seed)
    uf = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    itf = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    if nan_user is not None:
        uf[nan_user] = np.nan
    pop = rng.integers(0, 6, N_ITEMS).astype(np.float32)
    cats = {f"i{i}": [f"c{i % 5}"] for i in range(N_ITEMS) if i % 7}
    jax_model = JaxECommModel(
        user_factors=uf, item_factors=itf,
        user_map=JaxBiMap([f"u{u}" for u in range(N_USERS)]),
        item_map=JaxBiMap([f"i{i}" for i in range(N_ITEMS)]),
        item_categories=cats, popularity=pop,
    )
    return jax_model, from_jax_template_model(jax_model)


def _algos(**kw):
    return (JaxECommAlgorithm(JaxECommParams(app_name=APP, **kw)),
            ECommAlgorithm(ECommAlgorithmParams(app_name=APP, **kw)))


def _staged(models, cpu, jax_algo, port_algo):
    jax_model, port_model = models
    return (jax_algo.stage_model(JaxContext.create(), jax_model),
            port_algo.stage_model(cpu, port_model))


def _assert_same(got, want):
    assert [e["item"] for e in got["itemScores"]] == [
        e["item"] for e in want["itemScores"]]
    gs = [e["score"] for e in got["itemScores"]]
    ws = [e["score"] for e in want["itemScores"]]
    np.testing.assert_allclose(gs, ws, **TOL)


QUERIES = [
    {"user": "u1", "num": 5},
    {"user": "u2", "num": 10},
    {"user": "u3", "num": 4, "categories": ["c1"]},
    {"user": "u4", "num": 6, "categories": ["c0", "c3"]},
    {"user": "u5", "num": 5, "whiteList": [f"i{i}" for i in range(20, 50)]},
    {"user": "u6", "num": 8, "blackList": [f"i{i}" for i in range(0, 80, 2)]},
    {"user": "u7", "num": 5, "categories": ["c2"], "blackList": ["i12"],
     "whiteList": [f"i{i}" for i in range(40)]},
    {"user": "u8", "num": 100},
    {"user": "nobody", "num": 7},
    {"user": "nobody", "num": 5, "categories": ["c4"]},
    {"num": 3},
]


def test_engine_json_resolves_to_the_port_template():
    assert ENGINE_JSON["engineFactory"] == "ecommerce"
    engine = resolve_engine_factory("ecommerce")()
    params = engine.params_from_variant(ENGINE_JSON)
    (name, algo_params), = params.algorithms
    assert name == "ecomm" and isinstance(algo_params, ECommAlgorithmParams)
    assert (algo_params.rank, algo_params.unseen_only,
            list(algo_params.seen_events)) == (16, True, ["view", "buy"])


@pytest.mark.parametrize("unseen_only", [True, False])
@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_predict_matches_jax(qi, unseen_only, stores, cpu):
    jax_algo, port_algo = _algos(unseen_only=unseen_only)
    jax_model, port_model = _staged(_models(), cpu, jax_algo, port_algo)
    query = QUERIES[qi]
    want = jax_algo.predict(jax_model, query)
    got = port_algo.predict(port_model, query)
    _assert_same(got, want)
    items = [e["item"] for e in got["itemScores"]]
    assert not {"i3", "i5", "i8"} & set(items)
    if query.get("user") == "nobody":
        # the cold-start fallback ranks popularity; ties keep numpy's order
        assert items


def test_second_unavailable_set_changes_the_next_answer(stores, cpu):
    jax_storage, port_storage = stores
    jax_algo, port_algo = _algos()
    jax_model, port_model = _staged(_models(), cpu, jax_algo, port_algo)
    query = {"user": "u2", "num": 10}
    before = port_algo.predict(port_model, query)
    _assert_same(before, jax_algo.predict(jax_model, query))
    first = [e["item"] for e in before["itemScores"]][:4]
    for storage, event_cls in ((jax_storage, JaxEvent),
                               (port_storage, Event)):
        storage.get_events().insert(_constraint(event_cls, first, 120), 1)
    after = port_algo.predict(port_model, query)
    _assert_same(after, jax_algo.predict(jax_model, query))
    items = [e["item"] for e in after["itemScores"]]
    assert not set(first) & set(items)
    # the earlier constraint no longer holds: the latest $set wins
    assert items != [e["item"] for e in before["itemScores"]]


def test_store_error_serves_without_the_rules(cpu):
    """With no app of that name, each rule's read raises and the answer
    goes out without the rule, as in the JAX package."""
    set_storage(Storage(env=_memory_env()))
    jax_set_storage(JaxStorage(env=_memory_env()))
    try:
        jax_algo, port_algo = _algos()
        jax_model, port_model = _staged(_models(), cpu, jax_algo, port_algo)
        query = {"user": "u1", "num": 6}
        got = port_algo.predict(port_model, query)
        _assert_same(got, jax_algo.predict(jax_model, query))
        assert len(got["itemScores"]) == 6
    finally:
        set_storage(None)
        jax_set_storage(None)


@pytest.mark.parametrize("num", [3, 30])
def test_nan_user_row_answers_items_by_index(num, stores, cpu):
    jax_algo, port_algo = _algos(unseen_only=False)
    jax_model, port_model = _staged(_models(nan_user=4), cpu, jax_algo,
                                    port_algo)
    query = {"user": "u4", "num": num}
    want = jax_algo.predict(jax_model, query)
    got = port_algo.predict(port_model, query)
    items = [e["item"] for e in got["itemScores"]]
    assert items == [e["item"] for e in want["itemScores"]]
    assert all(math.isinf(e["score"]) and e["score"] < 0
               for e in got["itemScores"])
    # the catalog's first items in order, less the unavailable ones
    assert items == [f"i{i}" for i in range(N_ITEMS)
                     if i not in (3, 5, 8)][:num]


# -- events → run_train → deploy -----------------------------------------------


def test_run_train_reads_and_counts_alike(cpu):
    jax_storage = _filled(JaxStorage, JaxApp, JaxEvent, _memory_env(),
                          _events(JaxEvent))
    port_storage = _filled(Storage, App, Event, _memory_env(),
                           _events(Event))
    variant = {
        "datasource": ENGINE_JSON["datasource"],
        "algorithms": [{"name": "ecomm", "params": {
            **ENGINE_JSON["algorithms"][0]["params"],
            "num_iterations": 2}}],
    }
    jax_set_storage(jax_storage)
    try:
        want_td = JaxECommDataSource(JaxECommDSParams(
            app_name=APP)).read_training(JaxContext.create())
        engine = jax_engine()
        jax_iid = jax_run_train(engine, engine.params_from_variant(variant),
                                "ecomm", storage=jax_storage)
    finally:
        jax_set_storage(None)
    set_storage(port_storage)
    try:
        got_td = ECommDataSource(ECommDataSourceParams(
            app_name=APP)).read_training(cpu)
        engine = ecommerce_engine()
        iid = run_train(engine, engine.params_from_variant(variant),
                        "ecomm", ctx=cpu, storage=port_storage)
    finally:
        set_storage(None)
    assert got_td.item_categories == want_td.item_categories
    g, w = got_td.interactions, want_td.interactions
    for col in ("rows", "cols", "values", "times"):
        np.testing.assert_array_equal(getattr(g, col), getattr(w, col))
    (_, port_model), = deserialize_models(load_generation(
        port_storage.get_model_data_models(), iid))
    (_, jax_model), = jax_deserialize(jax_load_generation(
        jax_storage.get_model_data_models(), jax_iid))
    assert type(port_model) is ECommModel
    np.testing.assert_array_equal(port_model.popularity, jax_model.popularity)
    assert port_model.popularity.dtype == np.float32
    assert (port_model.user_map.keys().tolist()
            == jax_model.user_map.keys().tolist())
    assert (port_model.item_map.keys().tolist()
            == jax_model.item_map.keys().tolist())
    assert port_model.item_categories == jax_model.item_categories
    assert port_model.item_factors.shape == (w.n_cols, 16)
    assert np.isfinite(port_model.user_factors).all()


def _shared_env(base):
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(base / "pio.sqlite"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(base / "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }


def _post(base, body):
    req = urllib.request.Request(
        base + "/queries.json", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_engine_servers_answer_alike_from_one_jax_generation(tmp_path, cpu):
    env = _shared_env(tmp_path)
    storage = _filled(JaxStorage, JaxApp, JaxEvent, env, _events(JaxEvent))
    engine = jax_engine()
    params = engine.params_from_variant(ENGINE_JSON)
    jax_set_storage(storage)
    try:
        iid = jax_run_train(engine, params, "ecomm", storage=storage)
        blob = jax_load_generation(storage.get_model_data_models(), iid)
        (_, port_model), = deserialize_models(blob)
        assert type(port_model) is ECommModel
        jax_es = JaxServer(engine, params, "ecomm", storage=storage)
        jax_http = jax_es.serve(host="127.0.0.1", port=0)
        jax_http.start()
        port_storage = Storage(env=env)
        set_storage(port_storage)
        port_engine = ecommerce_engine()
        from predictionio_tpu_torch.serving.engine_server import (
            create_engine_server,
        )

        es, http = create_engine_server(
            port_engine, port_engine.params_from_variant(ENGINE_JSON),
            "ecomm", host="127.0.0.1", port=0, storage=port_storage,
            ctx=cpu, max_batch=8, max_wait_ms=1.0,
        )
        http.start()
        try:
            assert es._status_data()["engineInstanceId"] == iid
            want = [_post(f"http://127.0.0.1:{jax_http.port}", q)
                    for q in QUERIES]
            got = [_post(f"http://127.0.0.1:{http.port}", q)
                   for q in QUERIES]
        finally:
            jax_http.shutdown()
            jax_es.close()
            es.close()
    finally:
        jax_set_storage(None)
        set_storage(None)
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert any(g["itemScores"] for g in got)
