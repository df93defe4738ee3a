"""The training slice end to end: events → run_train → deploy → serve.

The same ``rate`` events (made from a seed with numpy) go into both
packages' memory event stores; each package's ``run_train`` reads them,
dedupes, trains ALS (rank 8, 3 iterations, implicit) from one shared
iteration-0 checkpoint (``jax.random`` cannot be reproduced) and
publishes a generation into its own local-filesystem model store; each
package's engine server deploys it and answers ``/queries.json`` over
HTTP. The answers must have scores within rtol 1e-3 / atol 1e-4 slot by
slot (the factors agree to that after three epochs; ``test_torch_als.py``
states why) and name the same items in the same order, except that two
items may trade places where the JAX model scores them within 1e-4 of
each other: the two packages' scores differ by a few 1e-6 and some
neighbouring scores of this data lie closer than 1e-5, so the order of
such a pair depends on summation order, not on the port.

The same again with the events posted over HTTP, half to each package's
event server, into one native event log that both packages' training
reads through its columnar scan.

Then the port's run lifecycle: COMPLETED with the parent generation and
the watermark in the manifest and the card in the instance record,
FAILED when there are no events, INTERRUPTED on stop-after-read.
"""

import datetime as dt
import json
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
    AccessKey as JaxAccessKey,
    App as JaxApp,
    Storage as JaxStorage,
    set_storage as jax_set_storage,
)
from predictionio_tpu.models.recommendation import (
    recommendation_engine as jax_engine,
)
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_tpu.serving.event_server import (
    create_event_server as jax_create_event_server,
)
from predictionio_tpu_torch.core.engine import WorkflowParams
from predictionio_tpu_torch.core.persistence import load_manifest
from predictionio_tpu_torch.core.workflow import latest_completed_id, run_train
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Storage,
    set_storage,
)
from predictionio_tpu_torch.models.recommendation import recommendation_engine
from predictionio_tpu_torch.ops.als import _write_checkpoint, checkpoint_path
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving.engine_server import create_engine_server
from predictionio_tpu_torch.serving.event_server import create_event_server

N_USERS, N_ITEMS, N_EVENTS, RANK = 60, 40, 900, 8
VARIANT = {
    "datasource": {"params": {"app_name": "shop"}},
    "algorithms": [
        {"name": "als", "params": {"rank": RANK, "num_iterations": 3}}
    ],
}
TOL = dict(rtol=1e-3, atol=1e-4)


def _events(event_cls):
    rng = np.random.default_rng(11)
    users = rng.integers(0, N_USERS, N_EVENTS)
    items = rng.zipf(1.3, N_EVENTS) % N_ITEMS
    ratings = rng.integers(1, 6, N_EVENTS)
    return [
        event_cls(event="rate", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}",
                  properties={"rating": int(r)})
        for u, i, r in zip(users, items, ratings)
    ]


def _storage(storage_cls, app_cls, event_cls, model_dir):
    storage = storage_cls(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(model_dir),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    })
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "shop"))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(_events(event_cls), app_id)
    return storage


def _start_checkpoint(ckpt_dir, n_users, n_items):
    rng = np.random.default_rng(12)
    _write_checkpoint(
        checkpoint_path(str(ckpt_dir)),
        iteration=0,
        item_factors=(rng.standard_normal((n_items, RANK)) / 3).astype(
            np.float32),
        user_factors=np.zeros((n_users, RANK), np.float32),
    )


def _post(base, body):
    req = urllib.request.Request(
        base + "/queries.json", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


@pytest.fixture()
def cpu():
    return ComputeContext.create(device="cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages trained on the same events; yields their storages
    and instance ids."""
    base = tmp_path_factory.mktemp("slice")
    events = _events(Event)
    users = {e.entity_id for e in events}
    items = {e.target_entity_id for e in events}
    ckpt = base / "ckpt"
    _start_checkpoint(ckpt, len(users), len(items))
    kw = dict(checkpoint_dir=str(ckpt), resume=True)

    jax_storage = _storage(JaxStorage, JaxApp, JaxEvent, base / "jax")
    engine = jax_engine()
    jax_set_storage(jax_storage)
    try:
        jax_id = jax_run_train(engine, engine.params_from_variant(VARIANT),
                               "rec", storage=jax_storage, **kw)
    finally:
        jax_set_storage(None)

    storage = _storage(Storage, App, Event, base / "port")
    engine = recommendation_engine()
    set_storage(storage)
    try:
        port_id = run_train(engine, engine.params_from_variant(VARIANT),
                            "rec", ctx=ComputeContext.create(device="cpu"),
                            storage=storage, watermark={"events": N_EVENTS},
                            **kw)
    finally:
        set_storage(None)
    return jax_storage, jax_id, storage, port_id, sorted(users)


def _assert_served_alike(jax_storage, jax_id, storage, port_id, users, cpu):
    """Both packages' engine servers deploy their generation; every
    ``/queries.json`` answer names the same items, ties aside."""
    queries = (
        [{"user": u, "num": n} for u, n in zip(users, [1, 3, 5, 10, 40] * 20)]
        + [{"user": "nobody", "num": 4}]
    )
    engine = jax_engine()
    jax_es = JaxServer(engine, engine.params_from_variant(VARIANT), "rec",
                       storage=jax_storage)
    jax_http = jax_es.serve(host="127.0.0.1", port=0)
    jax_http.start()
    engine = recommendation_engine()
    es, http = create_engine_server(
        engine, engine.params_from_variant(VARIANT), "rec",
        host="127.0.0.1", port=0, storage=storage, ctx=cpu,
        max_batch=8, max_wait_ms=1.0,
    )
    http.start()
    try:
        want = [_post(f"http://127.0.0.1:{jax_http.port}", q)
                for q in queries]
        got = [_post(f"http://127.0.0.1:{http.port}", q) for q in queries]
        # the trained generation is the one served
        assert es._status_data()["engineInstanceId"] == port_id
    finally:
        jax_http.shutdown()
        jax_es.close()
        es.close()
    assert got[-1] == want[-1] == {"itemScores": []}
    # every item's score under the JAX model, to tell a tie from an error
    (jax_model,) = [m for _tag, m in jax_deserialize(jax_load_generation(
        jax_storage.get_model_data_models(), jax_id))]
    jax_scores = np.asarray(jax_model.user_factors, np.float64) @ np.asarray(
        jax_model.item_factors, np.float64).T
    swaps = 0
    for q, g, w in zip(queries[:-1], got, want):
        g_items = [e["item"] for e in g["itemScores"]]
        w_items = [e["item"] for e in w["itemScores"]]
        assert len(g_items) == len(set(g_items)) == min(q["num"], N_ITEMS)
        row = jax_scores[jax_model.user_map(q["user"])]
        for gi, wi in zip(g_items, w_items):
            if gi != wi:
                swaps += 1
                gap = abs(row[jax_model.item_map(gi)]
                          - row[jax_model.item_map(wi)])
                assert gap <= 1e-4, (q, gi, wi, gap)
        np.testing.assert_allclose(
            [e["score"] for e in g["itemScores"]],
            [e["score"] for e in w["itemScores"]], **TOL,
        )
    assert swaps <= len(queries) // 10  # ties are rare, not the rule


def test_run_train_then_serve_matches_jax(trained, cpu):
    _assert_served_alike(*trained, cpu)


def _events_json():
    """The same events in the Event API's JSON, with distinct times."""
    t0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    out = []
    for n, e in enumerate(_events(Event)):
        d = e.to_json_dict()
        d.pop("creationTime")
        d["eventTime"] = (t0 + dt.timedelta(seconds=n)).isoformat()
        out.append(d)
    return out


def _post_batches(base, events):
    for lo in range(0, len(events), 50):
        req = urllib.request.Request(
            base + "/batch/events.json?accessKey=k",
            data=json.dumps(events[lo:lo + 50]).encode(), method="POST",
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert [r["status"] for r in json.loads(resp.read())] == [
                201] * len(events[lo:lo + 50])


@pytest.fixture(scope="module")
def trained_over_http(tmp_path_factory):
    """Events posted over HTTP, half to each package's event server,
    into ONE event log; each package's metadata in its own sqlite file
    and its models in its own directory; both train from it."""
    base = tmp_path_factory.mktemp("http-slice")
    users = sorted({e.entity_id for e in _events(Event)})
    items = {e.target_entity_id for e in _events(Event)}
    ckpt = base / "ckpt"
    _start_checkpoint(ckpt, len(users), len(items))
    kw = dict(checkpoint_dir=str(ckpt), resume=True)

    def env(pkg):
        return {
            "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(base / pkg / "pio.sqlite"),
            "PIO_STORAGE_SOURCES_LOG_TYPE": "eventlog",
            "PIO_STORAGE_SOURCES_LOG_PATH": str(base / "eventlog"),
            "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
            "PIO_STORAGE_SOURCES_FS_PATH": str(base / pkg / "models"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
        }

    jax_storage, storage = JaxStorage(env=env("jax")), Storage(env=env("port"))
    for st, app_cls, key_cls in ((jax_storage, JaxApp, JaxAccessKey),
                                 (storage, App, AccessKey)):
        app_id = st.get_meta_data_apps().insert(app_cls(0, "shop"))
        st.get_meta_data_access_keys().insert(key_cls("k", app_id))
    servers = [
        jax_create_event_server(host="127.0.0.1", port=0,
                                storage=jax_storage, admission=False),
        create_event_server(host="127.0.0.1", port=0, storage=storage),
    ]
    for http in servers:
        http.start()
    try:
        events = _events_json()
        for n, lo in enumerate(range(0, len(events), 100)):
            _post_batches(f"http://127.0.0.1:{servers[n % 2].port}",
                          events[lo:lo + 100])
    finally:
        for http in servers:
            http.shutdown()

    engine = jax_engine()
    jax_set_storage(jax_storage)
    try:
        jax_id = jax_run_train(engine, engine.params_from_variant(VARIANT),
                               "rec", storage=jax_storage, **kw)
    finally:
        jax_set_storage(None)
    engine = recommendation_engine()
    set_storage(storage)
    try:
        port_id = run_train(engine, engine.params_from_variant(VARIANT),
                            "rec", ctx=ComputeContext.create(device="cpu"),
                            storage=storage, **kw)
    finally:
        set_storage(None)
    return jax_storage, jax_id, storage, port_id, users


def test_http_ingest_into_one_event_log_then_serve_matches_jax(
        trained_over_http, cpu):
    _, _, storage, _, _ = trained_over_http
    assert len(list(storage.get_events().find(1))) == N_EVENTS
    _assert_served_alike(*trained_over_http, cpu)


def test_run_train_records_the_run(trained):
    _, _, storage, port_id, _ = trained
    instance = storage.get_meta_data_engine_instances().get(port_id)
    assert instance.status == "COMPLETED"
    assert instance.mesh_conf == {"platform": "cpu", "device": "cpu",
                                  "devices": "1"}
    timing = json.loads(instance.env["timing"])
    for step in ("train/total", "train/read", "train/prepare",
                 "train/algorithm", "train/persist", "als/user_solve",
                 "als/item_solve"):
        assert timing[step]["count"] >= 1, step
    assert timing["als/user_solve"]["count"] == 3
    manifest = load_manifest(storage.get_model_data_models(), port_id)
    assert manifest["parent"] is None
    assert manifest["watermark"] == {"events": N_EVENTS}
    assert latest_completed_id(storage, "rec") == port_id


def test_second_run_names_its_parent(tmp_path, cpu):
    storage = _storage(Storage, App, Event, tmp_path)
    engine = recommendation_engine()
    params = engine.params_from_variant(VARIANT)
    set_storage(storage)
    try:
        first = run_train(engine, params, "rec", ctx=cpu, storage=storage)
        second = run_train(engine, params, "rec", ctx=cpu, storage=storage)
    finally:
        set_storage(None)
    manifest = load_manifest(storage.get_model_data_models(), second)
    assert manifest["parent"] == first
    assert latest_completed_id(storage, "rec") == second


@pytest.mark.parametrize("case", ["no_events", "stop_after_read"])
def test_failed_and_interrupted_runs(tmp_path, cpu, case):
    from predictionio_tpu_torch.core.engine import StopAfterReadInterruption

    storage = _storage(Storage, App, Event, tmp_path)
    engine = recommendation_engine()
    variant = dict(VARIANT)
    workflow = None
    if case == "no_events":
        storage.get_meta_data_apps().insert(App(0, "empty"))
        variant["datasource"] = {"params": {"app_name": "empty"}}
        expected, status = ValueError, "FAILED"
    else:
        workflow = WorkflowParams(stop_after_read=True)
        expected, status = StopAfterReadInterruption, "INTERRUPTED"
    set_storage(storage)
    try:
        with pytest.raises(expected):
            run_train(engine, engine.params_from_variant(variant), "rec",
                      workflow=workflow, ctx=cpu, storage=storage)
    finally:
        set_storage(None)
    (instance,) = storage.get_meta_data_engine_instances().get_all()
    assert instance.status == status
    assert latest_completed_id(storage, "rec") is None
