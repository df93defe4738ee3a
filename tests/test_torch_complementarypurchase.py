"""The complementary-purchase template: the port against the JAX package.

* Baskets: both data sources split the same ``buy`` events (memory
  store) at the example's 3,600 s window into equal baskets.
* The co-occurrence table ``C`` equals a count on the host exactly, and
  both packages' trained complement lists (lift and confidence, with
  ``min_support``) are equal: item ids exactly, scores within 1e-6
  relative (both are float32 counts through the same elementwise
  formula; XLA may fuse it differently).
* Planted ties: baskets built so that many pairs share one lift score;
  the port lists them lower item first, as ``lax.top_k`` does.
* ``predict`` merges the queried items' lists alike, also from a model
  the JAX package pickled.
"""

import datetime as dt
import json
import pathlib

import numpy as np
import pytest
import torch

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import (
    App as JaxApp,
    Storage as JaxStorage,
    set_storage as jax_set_storage,
)
from predictionio_tpu.models.complementarypurchase import (
    CPAlgoParams as JaxCPParams,
    CPAlgorithm as JaxCPAlgorithm,
    CPDataSource as JaxCPDataSource,
    CPDataSourceParams as JaxCPDSParams,
    CPTrainingData as JaxCPTrainingData,
)
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.core.persistence import deserialize_models
from predictionio_tpu_torch.core.registry import resolve_engine_factory
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage, set_storage
from predictionio_tpu_torch.models.complementarypurchase import (
    CPAlgoParams,
    CPAlgorithm,
    CPDataSource,
    CPDataSourceParams,
    CPModel,
    CPTrainingData,
    cooccurrence,
    complementarypurchase_engine,
)
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.utils.bimap import BiMap

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE_JSON = json.loads(
    (ROOT / "examples" / "complementarypurchase" / "engine.json").read_text()
)
APP = ENGINE_JSON["datasource"]["params"]["app_name"]
N_USERS, N_ITEMS = 40, 50
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)


@pytest.fixture()
def cpu():
    return ComputeContext.create(device="cpu")


def _buys(event_cls):
    """Each user buys in a few sessions; the gap between sessions is
    longer than the window, the gaps inside one shorter."""
    rng = np.random.default_rng(5)
    out = []
    for u in range(N_USERS):
        t = T0 + dt.timedelta(hours=int(rng.integers(0, 24)))
        for _session in range(int(rng.integers(1, 5))):
            for _ in range(int(rng.integers(1, 6))):
                item = int(rng.zipf(1.4)) % N_ITEMS
                out.append(event_cls(
                    event="buy", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{item}",
                    event_time=t))
                t += dt.timedelta(seconds=int(rng.integers(1, 3000)))
            t += dt.timedelta(seconds=int(rng.integers(3601, 90000)))
    return out


def _memory(storage_cls, app_cls, event_cls):
    storage = storage_cls(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    app_id = storage.get_meta_data_apps().insert(app_cls(0, APP))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(_buys(event_cls), app_id)
    return storage


@pytest.fixture(scope="module")
def both_data():
    jax_storage = _memory(JaxStorage, JaxApp, JaxEvent)
    port_storage = _memory(Storage, App, Event)
    window = ENGINE_JSON["datasource"]["params"]["basket_window_secs"]
    jax_set_storage(jax_storage)
    try:
        want = JaxCPDataSource(JaxCPDSParams(
            app_name=APP, basket_window_secs=window)).read_training(
                JaxContext.create())
    finally:
        jax_set_storage(None)
    set_storage(port_storage)
    try:
        got = CPDataSource(CPDataSourceParams(
            app_name=APP, basket_window_secs=window)).read_training(
                ComputeContext.create(device="cpu"))
    finally:
        set_storage(None)
    return got, want, port_storage


def test_engine_json_resolves_to_the_port_template():
    assert ENGINE_JSON["engineFactory"] == "complementarypurchase"
    params = resolve_engine_factory("complementarypurchase")(
        ).params_from_variant(ENGINE_JSON)
    (name, p), = params.algorithms
    assert name == "cooccurrence" and isinstance(p, CPAlgoParams)
    assert (p.metric, p.min_support, p.top_k) == ("lift", 2, 20)


def test_baskets_equal(both_data):
    got, want, _ = both_data
    assert got.item_map.keys().tolist() == want.item_map.keys().tolist()
    assert len(got.baskets) == len(want.baskets) > N_USERS
    for g, w in zip(got.baskets, want.baskets):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int32
    assert any(len(b) > 1 for b in got.baskets)


def test_cooccurrence_counts_exactly(both_data):
    got, _, _ = both_data
    n = len(got.item_map)
    want = np.zeros((n, n), np.float32)
    for b in got.baskets:
        want[np.ix_(b, b)] += 1.0
    # chunks smaller than the basket list, so several products add up
    C = cooccurrence(got.baskets, n, 16, torch.device("cpu"))
    np.testing.assert_array_equal(C.numpy(), want)


def _train_both(got, want, **kw):
    jax_model = JaxCPAlgorithm(JaxCPParams(**kw)).train(
        JaxContext.create(), want)
    port_model = CPAlgorithm(CPAlgoParams(**kw)).train(
        ComputeContext.create(device="cpu"), got)
    return jax_model, port_model


@pytest.mark.parametrize("metric", ["lift", "confidence"])
@pytest.mark.parametrize("min_support,top_k,chunk",
                         [(2, 20, 1024), (1, 7, 16), (3, 60, 5)])
def test_trained_lists_match_jax(both_data, metric, min_support, top_k,
                                 chunk):
    got, want, _ = both_data
    jax_model, port_model = _train_both(
        got, want, metric=metric, min_support=min_support, top_k=top_k,
        chunk=chunk)
    np.testing.assert_array_equal(port_model.topk_items,
                                  jax_model.topk_items)
    np.testing.assert_allclose(port_model.topk_scores,
                               np.asarray(jax_model.topk_scores),
                               rtol=1e-6, atol=0)
    assert port_model.topk_items.dtype == np.int32
    assert port_model.topk_scores.dtype == np.float32
    assert (port_model.topk_items >= 0).any()


def _tied_data(training_cls, bimap_cls):
    """Item 0 shares a basket with each of items 1-12 twice, and items
    1-12 appear nowhere else: every pair (0, j) has the same lift, and
    lax.top_k lists them 1, 2, 3, ... Items 13-20 pair among themselves
    with equal counts too."""
    baskets = []
    for j in range(1, 13):
        baskets += [np.asarray([0, j], np.int32)] * 2
    for j in range(13, 20):
        baskets += [np.asarray([j, j + 1], np.int32)] * 3
    ids = [f"i{i}" for i in range(21)]
    return training_cls(item_map=bimap_cls(ids), baskets=baskets)


@pytest.mark.parametrize("metric", ["lift", "confidence"])
def test_planted_ties_resolve_as_lax_top_k(metric):
    jax_model, port_model = _train_both(
        _tied_data(CPTrainingData, BiMap),
        _tied_data(JaxCPTrainingData, JaxBiMap), metric=metric, top_k=8)
    np.testing.assert_array_equal(port_model.topk_items,
                                  jax_model.topk_items)
    assert port_model.topk_items[0].tolist() == list(range(1, 9))
    scores = port_model.topk_scores[0]
    assert (scores == scores[0]).all()


QUERIES = [
    {"items": ["i0"], "num": 5},
    {"items": ["i0", "i1", "i2"], "num": 10},
    {"items": ["i3", "i3", "i4"], "num": 8},
    {"items": ["i1", "nope"], "num": 4},
    {"items": ["nope"], "num": 4},
    {"items": [], "num": 3},
    {"num": 2},
]


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_predict_matches_jax(both_data, qi):
    got, want, _ = both_data
    jax_model, port_model = _train_both(got, want, min_support=1)
    query = QUERIES[qi]
    g = CPAlgorithm().predict(port_model, query)
    w = JaxCPAlgorithm().predict(jax_model, query)
    assert [e["item"] for e in g["itemScores"]] == [
        e["item"] for e in w["itemScores"]]
    np.testing.assert_allclose([e["score"] for e in g["itemScores"]],
                               [e["score"] for e in w["itemScores"]],
                               rtol=1e-6)


def test_jax_generation_loads_and_answers_alike(both_data):
    from predictionio_tpu.core.persistence import (
        serialize_models as jax_serialize,
    )

    got, want, _ = both_data
    jax_model, _ = _train_both(got, want, min_support=1)
    (_, loaded), = deserialize_models(
        jax_serialize("g", [JaxCPAlgorithm()], [jax_model]))
    assert type(loaded) is CPModel
    for query in QUERIES:
        assert CPAlgorithm().predict(loaded, query) == JaxCPAlgorithm(
            ).predict(jax_model, query)


def test_run_train_publishes_a_host_model(both_data, cpu):
    _, _, storage = both_data
    engine = complementarypurchase_engine()
    set_storage(storage)
    try:
        iid = run_train(engine, engine.params_from_variant(ENGINE_JSON),
                        "cp", ctx=cpu, storage=storage)
    finally:
        set_storage(None)
    (_, model), = deserialize_models(
        storage.get_model_data_models().get(iid).models)
    assert type(model) is CPModel
    assert model.topk_items.shape[1] == 20
    assert isinstance(model.topk_scores, np.ndarray)
