"""The similar-product template: the port against the JAX package.

* ``similarity.gather_mean_top_k_cosine`` on the same numpy table, in
  float32, int8 and bf16 (both packages quantize to the same bits), with
  a ``-1``-padded basket, an ``[I]`` mask, ``num`` above the catalog and
  a basket of padding only: the finite scores agree within 1e-5 (XLA-CPU
  and torch-CPU normalize and sum in other orders) and every slot names
  the same item; the slots no rankable item fills are -inf in both and
  name the lowest unrankable items, ascending, as ``lax.top_k`` does.
* ``SimilarALSAlgorithm.predict`` and ``SimilarProductServing.serve`` on
  shared factors: the same items in the same order, filters included,
  and ``{"itemScores": []}`` for a basket of unknown items. Where two
  summed scores lie within 1e-5 of each other the order may differ.
* ``aggregate_properties`` / ``extract_entity_map`` over ``$set`` /
  ``$unset`` / ``$delete`` sequences through both packages' memory and
  sqlite stores: equal property maps and update times.
* Both packages' ``run_train`` on one event set: the data source's output
  (interactions per signal, the shared item and user maps, the
  categories) is equal exactly.
* A generation the JAX package trained (sqlite metadata + local model
  files, which both packages read) loads in the port, whose ``predict``
  answers as the JAX model's does, and both packages' engine servers
  give the same ``/queries.json`` bodies (scores within 1e-5).
"""

import datetime as dt
import json
import pathlib
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from predictionio_tpu.data.store import EventStore as JaxEventStore
from predictionio_tpu.models.similarproduct import (
    SimilarALSAlgorithm as JaxSimilarALS,
    SimilarDataSource as JaxSimilarDataSource,
    SimilarDataSourceParams as JaxSimilarDSParams,
    SimilarModel as JaxSimilarModel,
    SimilarProductServing as JaxSimilarServing,
    similarproduct_engine as jax_engine,
)
from predictionio_tpu.ops import quantize as jax_quantize
from predictionio_tpu.ops import similarity as jax_similarity
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.core.persistence import (
    deserialize_models,
    load_generation,
)
from predictionio_tpu_torch.core.registry import resolve_engine_factory
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage, set_storage
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.models.similarproduct import (
    SimilarALSAlgorithm,
    SimilarDataSource,
    SimilarDataSourceParams,
    SimilarModel,
    SimilarProductServing,
    similarproduct_engine,
)
from predictionio_tpu_torch.ops import quantize, similarity
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving.engine_server import create_engine_server
from predictionio_tpu_torch.utils.bimap import BiMap

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE_JSON = json.loads(
    (ROOT / "examples" / "similarproduct" / "engine.json").read_text()
)
APP = ENGINE_JSON["datasource"]["params"]["app_name"]
N_ITEMS, RANK = 60, 8
CATEGORIES = [f"c{i}" for i in range(5)]
TOL = dict(rtol=1e-5, atol=1e-5)
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)


@pytest.fixture()
def cpu():
    return ComputeContext.create(device="cpu")


# -- gather_mean_top_k_cosine -----------------------------------------------


def _table(seed=0, n=300, k=16):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


_COSINE_CASES = {
    # case: (basket, num, mask every 7th row)
    "padded_basket": ([3, 7, 11, -1, -1, -1, -1, -1], 20, False),
    "item_mask": ([3, 7, 11, -1], 20, True),
    "num_above_catalog": ([5, -1], 400, False),
    "num_above_catalog_masked": ([5, 9], 400, True),
    "all_padding": ([-1, -1, -1, -1], 20, True),
}


@pytest.mark.parametrize("case", sorted(_COSINE_CASES))
@pytest.mark.parametrize("mode", ["f32", "int8", "bf16"])
def test_gather_mean_top_k_cosine_matches_jax(mode, case):
    basket, num, masked = _COSINE_CASES[case]
    items = _table()
    idx = np.asarray(basket, np.int32)
    mask = np.zeros(len(items), bool)
    mask[::7] = masked
    if mode == "f32":
        jax_items, port_items = items, torch.from_numpy(items)
    else:
        jax_items = jax_quantize.quantize_factors(items, mode)
        port_items = quantize.quantize_factors(torch.from_numpy(items), mode)
    want_s, want_i = (np.asarray(a) for a in jax_similarity.
                      gather_mean_top_k_cosine(
                          jax_items, idx, num,
                          jnp.asarray(mask) if masked else None))
    got_s, got_i = similarity.gather_mean_top_k_cosine(
        port_items, idx, num, torch.from_numpy(mask) if masked else None)
    assert got_s.device.type == "cpu"
    got_s, got_i = got_s.numpy(), got_i.numpy()
    assert got_s.shape == want_s.shape == (1, min(num, len(items)))
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isneginf(got_s), ~fin)
    np.testing.assert_allclose(got_s[fin], want_s[fin], **TOL)
    np.testing.assert_array_equal(got_i, want_i)
    if masked:
        assert not mask[got_i[fin]].any()


def test_gather_mean_top_k_cosine_host_table_goes_to_the_card():
    """A host table is moved to the CUDA device, never ranked on the
    CPU: without a card the call raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the host table is moved there")
    with pytest.raises((RuntimeError, AssertionError)):
        similarity.gather_mean_top_k_cosine(_table(), [1, 2], 5)


# -- predict and serve on shared factors ----------------------------------------


def _categories(seed=1):
    rng = np.random.default_rng(seed)
    return {
        f"i{i}": sorted(rng.choice(CATEGORIES, rng.integers(1, 4),
                                   replace=False).tolist())
        for i in range(N_ITEMS) if i % 9  # every 9th item has none
    }


def _models(seed):
    factors = _table(seed, N_ITEMS, RANK)
    ids = [f"i{i}" for i in range(N_ITEMS)]
    cats = _categories()
    return (
        JaxSimilarModel(item_factors=factors, item_map=JaxBiMap(ids),
                        item_categories=cats),
        SimilarModel(item_factors=factors, item_map=BiMap(ids),
                     item_categories=cats),
    )


QUERIES = [
    {"items": ["i1"], "num": 5},
    {"items": ["i1", "i2", "i3"], "num": 10},
    {"items": ["i4", "i5", "i6", "i7", "i8"], "num": 7},
    {"items": [f"i{i}" for i in range(10, 18)], "num": 12},
    {"items": ["i2"], "num": 4, "categories": ["c1"]},
    {"items": ["i9", "i20"], "num": 6, "categories": ["c0", "c3"]},
    {"items": ["i3"], "num": 5,
     "whiteList": [f"i{i}" for i in range(20, 40)]},
    {"items": ["i3"], "num": 8,
     "blackList": [f"i{i}" for i in range(0, 60, 2)]},
    {"items": ["i11", "i12"], "num": 5, "categories": ["c2"],
     "blackList": ["i13", "i14"], "whiteList": [f"i{i}" for i in range(30)]},
    {"items": ["i1", "i2"], "num": 100},
    {"items": ["nope", "i4"], "num": 5},
    {"items": ["nope", "gone"], "num": 5},
    {"items": [], "num": 3},
    {"num": 3},
]


def _staged(models, cpu):
    jax_model, port_model = models
    return (JaxSimilarALS().stage_model(JaxContext.create(), jax_model),
            SimilarALSAlgorithm().stage_model(cpu, port_model))


def _assert_same_items(got, want, scores_by_item=None):
    """Equal item lists and scores; where the lists differ, the two items
    must tie within 1e-5 under ``scores_by_item`` (the JAX answer's)."""
    g_items = [e["item"] for e in got["itemScores"]]
    w_items = [e["item"] for e in want["itemScores"]]
    assert len(g_items) == len(w_items)
    np.testing.assert_allclose(
        [e["score"] for e in got["itemScores"]],
        [e["score"] for e in want["itemScores"]], **TOL)
    for gi, wi in zip(g_items, w_items):
        if gi != wi:
            assert scores_by_item is not None, (g_items, w_items)
            assert abs(scores_by_item[gi] - scores_by_item[wi]) <= 1e-5


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_predict_matches_jax(qi, cpu):
    jax_model, port_model = _staged(_models(2), cpu)
    query = QUERIES[qi]
    want = JaxSimilarALS().predict(jax_model, query)
    got = SimilarALSAlgorithm().predict(port_model, query)
    _assert_same_items(got, want)
    if not any(it in port_model.item_map for it in query.get("items", [])):
        assert got == {"itemScores": []}
    for e in got["itemScores"]:
        assert e["item"] not in query.get("items", [])
        assert e["item"] not in query.get("blackList", [])
        if query.get("whiteList"):
            assert e["item"] in query["whiteList"]
        if query.get("categories"):
            assert set(query["categories"]) & set(
                port_model.item_categories.get(e["item"], []))


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_two_algorithm_serve_matches_jax(qi, cpu):
    """Two signals' models (view and like), summed per item."""
    view = _staged(_models(3), cpu)
    like = _staged(_models(4), cpu)
    query = QUERIES[qi]
    jax_preds = [JaxSimilarALS().predict(m[0], query) for m in (view, like)]
    port_preds = [SimilarALSAlgorithm().predict(m[1], query)
                  for m in (view, like)]
    want = JaxSimilarServing().serve(query, jax_preds)
    got = SimilarProductServing().serve(query, port_preds)
    summed = {}
    for p in jax_preds:
        for e in p["itemScores"]:
            summed[e["item"]] = summed.get(e["item"], 0.0) + e["score"]
    _assert_same_items(got, want, summed)


# -- property aggregation ---------------------------------------------------------


def _special_events(event_cls):
    """$set / $unset / $delete sequences over six items and one user:
    last write wins by time, unsets older than a set are ignored, a
    delete covering the latest set removes the entity, a set after a
    delete survives, an entity with no $set is absent."""
    def ev(name, eid, minutes, props=None, etype="item"):
        return event_cls(event=name, entity_type=etype, entity_id=eid,
                         properties=props or {},
                         event_time=T0 + dt.timedelta(minutes=minutes))

    return [
        ev("$set", "a", 1, {"categories": ["c1"], "price": 3}),
        ev("$set", "a", 5, {"price": 4, "title": "A"}),
        ev("$set", "a", 3, {"price": 9}),
        ev("$unset", "a", 2, {"price": None}),
        ev("$unset", "a", 6, {"title": None}),
        ev("$set", "b", 1, {"categories": ["c2", "c3"]}),
        ev("$delete", "b", 2),
        ev("$set", "c", 1, {"x": 1}),
        ev("$delete", "c", 2),
        ev("$set", "c", 3, {"y": 2}),
        ev("$unset", "d", 1, {"x": None}),
        ev("$delete", "d", 2),
        ev("$set", "e", 4, {"categories": ["c0"], "x": 1}),
        ev("$set", "e", 4, {"x": 2}),
        ev("$set", "f", 2, {"x": 1}),
        ev("$delete", "f", 1),
        ev("$set", "u", 1, {"x": 1}, etype="user"),
        ev("view", "a", 1, {"ignored": True}),
    ]


def _env(kind, path):
    if kind == "memory":
        return {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}
    return {"PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(path),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"}


def _filled(storage_cls, app_cls, event_cls, env, events):
    storage = storage_cls(env=env)
    app_id = storage.get_meta_data_apps().insert(app_cls(0, APP))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(events, app_id)
    return storage


def _as_plain(props):
    return {eid: (pm.to_dict(), pm.first_updated, pm.last_updated)
            for eid, pm in props.items()}


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_aggregate_properties_matches_jax(kind, tmp_path):
    jax_store = JaxEventStore(_filled(
        JaxStorage, JaxApp, JaxEvent, _env(kind, tmp_path / "jax.sqlite"),
        _special_events(JaxEvent)))
    port_store = EventStore(_filled(
        Storage, App, Event, _env(kind, tmp_path / "port.sqlite"),
        _special_events(Event)))
    for kw in ({"entity_type": "item"}, {"entity_type": "user"},
               {"entity_type": "item", "required": ["categories"]},
               {"entity_type": "item",
                "until_time": T0 + dt.timedelta(minutes=2)}):
        want = _as_plain(jax_store.aggregate_properties(APP, **kw))
        got = _as_plain(port_store.aggregate_properties(APP, **kw))
        assert got == want, kw
    got = port_store.aggregate_properties(APP, entity_type="item")
    assert sorted(got) == ["a", "c", "e", "f"]
    assert got["a"].to_dict() == {"categories": ["c1"], "price": 4}
    assert got["c"].to_dict() == {"y": 2}
    with pytest.raises(ValueError):
        port_store.aggregate_properties(APP, entity_type="")


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_extract_entity_map_matches_jax(kind, tmp_path):
    # the port reads the sqlite file the JAX package wrote
    env = _env(kind, tmp_path / "shared.sqlite")
    jax_storage = _filled(JaxStorage, JaxApp, JaxEvent, env,
                          _special_events(JaxEvent))
    port_storage = (Storage(env=env) if kind == "sqlite" else _filled(
        Storage, App, Event, env, _special_events(Event)))
    want = JaxEventStore(jax_storage).extract_entity_map(APP, "item")
    got = EventStore(port_storage).extract_entity_map(APP, "item")
    assert len(got) == len(want) == 4
    for eid in ("a", "c", "e", "f"):
        assert got.index(eid) == want.index(eid)
        assert got.entity_id(got.index(eid)) == eid
        assert got.data(eid).to_dict() == want.data(eid).to_dict()
    assert "b" not in got and got.get("b") is None


# -- events → run_train → deploy ---------------------------------------------------


def _signal_events(event_cls):
    rng = np.random.default_rng(7)
    out = []
    for name, n, n_users in (("view", 700, 40), ("like", 220, 30)):
        users = rng.integers(0, n_users, n)
        items = rng.zipf(1.3, n) % N_ITEMS
        out += [
            event_cls(event=name, entity_type="user", entity_id=f"u{u}",
                      target_entity_type="item", target_entity_id=f"i{i}",
                      event_time=T0 + dt.timedelta(seconds=j))
            for j, (u, i) in enumerate(zip(users, items))
        ]
    cats = _categories(5)
    out += [
        event_cls(event="$set", entity_type="item", entity_id=eid,
                  properties={"categories": c},
                  event_time=T0 + dt.timedelta(hours=1))
        for eid, c in cats.items()
    ]
    return out


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


def _variant():
    return {k: ENGINE_JSON[k] for k in ("datasource", "algorithms")}


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """The JAX package trains the example's engine.json on sqlite events
    into local model files; returns the shared env and instance id."""
    base = tmp_path_factory.mktemp("similar")
    env = _shared_env(base)
    storage = _filled(JaxStorage, JaxApp, JaxEvent, env,
                      _signal_events(JaxEvent))
    engine = jax_engine()
    jax_set_storage(storage)
    try:
        iid = jax_run_train(engine, engine.params_from_variant(_variant()),
                            "similar", storage=storage)
    finally:
        jax_set_storage(None)
    return env, iid


def test_engine_json_resolves_to_the_port_template():
    assert ENGINE_JSON["engineFactory"] == "similarproduct"
    engine = resolve_engine_factory("similarproduct")()
    params = engine.params_from_variant(_variant())
    assert [p.event_name for _n, p in params.algorithms] == ["view", "like"]
    assert all(p.rank == 16 for _n, p in params.algorithms)


def test_run_train_data_source_output_matches_jax(jax_trained, cpu,
                                                  tmp_path):
    env, jax_iid = jax_trained
    # the port reads the same sqlite events the JAX package trained on
    storage = Storage(env=env)
    set_storage(storage)
    try:
        got = SimilarDataSource(SimilarDataSourceParams(
            app_name=APP)).read_training(cpu)
    finally:
        set_storage(None)
    jax_set_storage(JaxStorage(env=env))
    try:
        want = JaxSimilarDataSource(JaxSimilarDSParams(
            app_name=APP)).read_training(JaxContext.create())
    finally:
        jax_set_storage(None)
    assert got.item_categories == want.item_categories
    assert sorted(got.interactions) == sorted(want.interactions) == [
        "like", "view"]
    for name, g in got.interactions.items():
        w = want.interactions[name]
        assert g.entity_map.keys().tolist() == w.entity_map.keys().tolist()
        assert g.target_map.keys().tolist() == w.target_map.keys().tolist()
        for col in ("rows", "cols", "values", "times"):
            np.testing.assert_array_equal(getattr(g, col), getattr(w, col))
    # the port's own run_train on a copy of those events (its own store):
    # its generation holds the same item map and categories
    port_storage = _filled(Storage, App, Event, _shared_env(tmp_path),
                           _signal_events(Event))
    engine = similarproduct_engine()
    params = engine.params_from_variant({
        "datasource": ENGINE_JSON["datasource"],
        "algorithms": [
            {"name": "als", "params": {**a["params"], "num_iterations": 2}}
            for a in ENGINE_JSON["algorithms"]],
    })
    set_storage(port_storage)
    try:
        iid = run_train(engine, params, "similar", ctx=cpu,
                        storage=port_storage)
    finally:
        set_storage(None)
    port_models = [m for _t, m in deserialize_models(load_generation(
        port_storage.get_model_data_models(), iid))]
    jax_models = [m for _t, m in jax_deserialize(jax_load_generation(
        JaxStorage(env=env).get_model_data_models(), jax_iid))]
    assert len(port_models) == len(jax_models) == 2
    for p, j in zip(port_models, jax_models):
        assert p.item_map.keys().tolist() == j.item_map.keys().tolist()
        assert p.item_categories == j.item_categories
        assert p.item_factors.shape == (len(p.item_map), 16)
        assert np.isfinite(p.item_factors).all()


def _post(base, body):
    req = urllib.request.Request(
        base + "/queries.json", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_jax_trained_generation_predicts_alike_in_the_port(jax_trained,
                                                           cpu):
    env, iid = jax_trained
    blob = jax_load_generation(
        JaxStorage(env=env).get_model_data_models(), iid)
    jax_models = [m for _t, m in jax_deserialize(blob)]
    port_models = [m for _t, m in deserialize_models(blob)]
    assert all(type(m) is SimilarModel for m in port_models)
    for jm, pm in zip(jax_models, port_models):
        jm = JaxSimilarALS().stage_model(JaxContext.create(), jm)
        pm = SimilarALSAlgorithm().stage_model(cpu, pm)
        for q in QUERIES:
            _assert_same_items(SimilarALSAlgorithm().predict(pm, q),
                               JaxSimilarALS().predict(jm, q))


def test_engine_servers_answer_alike_from_one_jax_generation(jax_trained,
                                                             cpu):
    env, iid = jax_trained
    engine = jax_engine()
    jax_es = JaxServer(engine, engine.params_from_variant(_variant()),
                       "similar", storage=JaxStorage(env=env))
    jax_http = jax_es.serve(host="127.0.0.1", port=0)
    jax_http.start()
    engine = similarproduct_engine()
    es, http = create_engine_server(
        engine, engine.params_from_variant(_variant()), "similar",
        host="127.0.0.1", port=0, storage=Storage(env=env), ctx=cpu,
        max_batch=8, max_wait_ms=1.0,
    )
    http.start()
    try:
        assert es._status_data()["engineInstanceId"] == iid
        want = [_post(f"http://127.0.0.1:{jax_http.port}", q)
                for q in QUERIES]
        got = [_post(f"http://127.0.0.1:{http.port}", q) for q in QUERIES]
    finally:
        jax_http.shutdown()
        jax_es.close()
        es.close()
    for q, g, w in zip(QUERIES, got, want):
        summed = {e["item"]: e["score"] for e in w["itemScores"]}
        _assert_same_items(g, w, summed)
    assert got[QUERIES.index({"items": ["nope", "gone"], "num": 5})] == {
        "itemScores": []}
