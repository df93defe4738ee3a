"""Three repairs of the port's host surfaces, against the JAX package.

* ``GET /healthz`` answers before routing on both of the port's servers
  (engine and event): status 200 and the JAX servers' body, ``pid``
  masked. Any other method on the path goes to the router as before.
* No access key reaches the port's access log: a DEBUG capture of event
  server requests that carry ``?accessKey=`` holds ``[redacted]`` and
  never the key; ``redact_keys`` equals the JAX package's on the same
  lines.
* ``BackendSpec`` and ``register_backend`` are exported with the JAX
  names and semantics: a user-registered backend is built from
  ``PIO_STORAGE_SOURCES_X_TYPE``, a DAO it leaves out is refused, the
  built-in types are registered through it, and each networked type
  (``postgres``, ``mysql``, ``httpstore``, ``replicated``) resolves and
  round-trips an app through its running servers.
"""

import dataclasses
import datetime as dt
import json
import logging
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.core.persistence import (
    publish_generation as jax_publish,
    serialize_models as jax_serialize,
)
from predictionio_tpu.data.storage import (
    AccessKey as JaxAccessKey,
    App as JaxApp,
    EngineInstance as JaxEngineInstance,
    Storage as JaxStorage,
)
from predictionio_tpu.data.storage import BackendSpec as JaxBackendSpec
from predictionio_tpu.models.recommendation import (
    ALSAlgorithm as JaxALS,
    ALSRecModel as JaxModel,
    recommendation_engine as jax_engine,
)
from predictionio_tpu.obs.context import redact_keys as jax_redact_keys
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_tpu.serving.event_server import (
    create_event_server as jax_create_event_server,
)
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.data import storage as storage_mod
from predictionio_tpu_torch.data.storage import (
    App,
    BackendSpec,
    Storage,
    StorageError,
    memory,
    register_backend,
)
from predictionio_tpu_torch.models.recommendation import recommendation_engine
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving.engine_server import create_engine_server
from predictionio_tpu_torch.serving.event_server import create_event_server
from predictionio_tpu_torch.serving.http import redact_keys

KEY = "s3cr3t-KEY_value.42"


def _env(base):
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(base / "pio.sqlite"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(base / "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }


def _request(url, method="GET", body=None):
    req = urllib.request.Request(
        url, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _masked(body):
    assert body["pid"] == os.getpid()  # both servers run in this process
    return {**body, "pid": "<pid>"}


@pytest.fixture()
def shared(tmp_path):
    """sqlite metadata + events and local model files, which both
    packages read: one app with a key, and one published generation of
    a small recommendation model (JAX-pickled, which the port loads)."""
    env = _env(tmp_path)
    storage = JaxStorage(env=env)
    app_id = storage.get_meta_data_apps().insert(JaxApp(0, "probe"))
    storage.get_meta_data_access_keys().insert(JaxAccessKey(KEY, app_id))
    storage.get_events().init(app_id)
    rng = np.random.default_rng(0)
    model = JaxModel(
        user_factors=rng.standard_normal((4, 8)).astype(np.float32),
        item_factors=rng.standard_normal((12, 8)).astype(np.float32),
        user_map=JaxBiMap([f"u{i}" for i in range(4)]),
        item_map=JaxBiMap([f"i{i}" for i in range(12)]),
    )
    now = dt.datetime.now(dt.timezone.utc)
    iid = storage.get_meta_data_engine_instances().insert(JaxEngineInstance(
        id="", status="COMPLETED", start_time=now, end_time=now,
        engine_id="rec", engine_version="1", engine_variant="default",
        engine_factory="recommendation",
    ))
    jax_publish(storage.get_model_data_models(), iid,
                jax_serialize(iid, [JaxALS()], [model]))
    return env


VARIANT = {"algorithms": [{"name": "als", "params": {"rank": 8}}]}


def test_healthz_on_both_engine_servers_equals_jax(shared):
    engine = jax_engine()
    jax_es = JaxServer(engine, engine.params_from_variant(VARIANT), "rec",
                       storage=JaxStorage(env=shared))
    jax_http = jax_es.serve(host="127.0.0.1", port=0)
    jax_http.start()
    engine = recommendation_engine()
    es, http = create_engine_server(
        engine, engine.params_from_variant(VARIANT), "rec",
        host="127.0.0.1", port=0, storage=Storage(env=shared),
        ctx=ComputeContext.create(device="cpu"),
    )
    http.start()
    try:
        want = _request(f"http://127.0.0.1:{jax_http.port}/healthz")
        got = _request(f"http://127.0.0.1:{http.port}/healthz")
        # the probe is GET only; other methods route as before (404)
        assert _request(f"http://127.0.0.1:{http.port}/healthz",
                        "POST", {})[0] == 404
        # and the engine still serves
        status, body = _request(f"http://127.0.0.1:{http.port}/queries.json",
                                "POST", {"user": "u1", "num": 3})
        assert status == 200 and len(body["itemScores"]) == 3
    finally:
        jax_http.shutdown()
        jax_es.close()
        es.close()
    assert got[0] == want[0] == 200
    assert _masked(got[1]) == _masked(want[1]) == {
        "status": "ok", "service": "engine", "pid": "<pid>"}


def test_healthz_on_both_event_servers_equals_jax(shared):
    jax_http = jax_create_event_server(host="127.0.0.1", port=0,
                                       storage=JaxStorage(env=shared))
    jax_http.start()
    http = create_event_server(host="127.0.0.1", port=0,
                               storage=Storage(env=shared))
    http.start()
    try:
        want = _request(f"http://127.0.0.1:{jax_http.port}/healthz")
        got = _request(f"http://127.0.0.1:{http.port}/healthz")
        # no access key needed for the probe; the routes still want one
        assert _request(f"http://127.0.0.1:{http.port}/events.json")[0] == 401
    finally:
        jax_http.shutdown()
        http.shutdown()
    assert got[0] == want[0] == 200
    assert _masked(got[1]) == _masked(want[1]) == {
        "status": "ok", "service": "eventserver", "pid": "<pid>"}


def test_access_keys_never_reach_the_log(shared, caplog):
    http = create_event_server(host="127.0.0.1", port=0,
                               storage=Storage(env=shared))
    http.start()
    base = f"http://127.0.0.1:{http.port}"
    event = {"event": "view", "entityType": "user", "entityId": "u1",
             "targetEntityType": "item", "targetEntityId": "i1"}
    try:
        with caplog.at_level(logging.DEBUG,
                             logger="predictionio_tpu_torch.serving.http"):
            assert _request(f"{base}/events.json?accessKey={KEY}", "POST",
                            event)[0] == 201
            assert _request(f"{base}/events.json?accessKey={KEY}&limit=1"
                            )[0] == 200
            assert _request(f"{base}/events.json?limit=1&accessKey={KEY}"
                            "&reversed=true")[0] == 200
            assert _request(f"{base}/events.json?accessKey=wrong{KEY}",
                            "POST", event)[0] == 401
    finally:
        http.shutdown()
    lines = [r.getMessage() for r in caplog.records
             if r.name == "predictionio_tpu_torch.serving.http"]
    assert len(lines) >= 4
    assert sum("accessKey=[redacted]" in line for line in lines) >= 4
    assert not any(KEY in line for line in lines)


@pytest.mark.parametrize("line", [
    f'"POST /events.json?accessKey={KEY} HTTP/1.1" 201 -',
    f"GET /events.json?limit=5&accessKey={KEY}&reversed=true",
    f"accessKey={KEY}",
    "GET /healthz HTTP/1.1",
    f"/a?accessKey={KEY}&accessKey=other b",
])
def test_redact_keys_equals_jax(line):
    assert redact_keys(line) == jax_redact_keys(line)
    assert KEY not in redact_keys(line)


class _CountingClient:
    """A user backend: memory apps and events behind a client that
    counts how often it was built."""

    built = 0

    def __init__(self, config: dict):
        type(self).built += 1
        self.config = config
        self.apps = memory.MemoryApps()
        self.events = memory.MemoryEvents()


def test_user_registered_backend_is_picked_up_from_env():
    _CountingClient.built = 0
    register_backend("counting", BackendSpec(
        client=_CountingClient, apps=lambda c: c.apps,
        events=lambda c: c.events))
    try:
        storage = Storage(env={
            "PIO_STORAGE_SOURCES_X_TYPE": "counting",
            "PIO_STORAGE_SOURCES_X_FLAVOR": "plain",
        })
        apps = storage.get_meta_data_apps()
        events = storage.get_events()
        assert isinstance(apps, memory.MemoryApps)
        assert isinstance(events, memory.MemoryEvents)
        assert _CountingClient.built == 1  # one client a source
        assert storage._client("X").config == {"TYPE": "counting",
                                               "FLAVOR": "plain"}
        with pytest.raises(StorageError, match="does not support models"):
            storage.get_model_data_models()
    finally:
        storage_mod._BACKENDS.pop("counting")
    with pytest.raises(StorageError, match="unknown backend type"):
        Storage(env={"PIO_STORAGE_SOURCES_X_TYPE": "counting"})


def test_backend_spec_has_the_jax_fields_and_builtins():
    assert [f.name for f in dataclasses.fields(BackendSpec)] == [
        f.name for f in dataclasses.fields(JaxBackendSpec)]
    assert {"memory", "sqlite", "localfs", "eventlog"} <= set(
        storage_mod._BACKENDS)
    assert all(isinstance(s, BackendSpec)
               for s in storage_mod._BACKENDS.values())
    assert "register_backend" in storage_mod.__all__
    assert "BackendSpec" in storage_mod.__all__


@pytest.mark.parametrize("kind",
                         ["postgres", "mysql", "httpstore", "replicated"])
def test_networked_types_resolve_and_round_trip_an_app(tmp_path, kind):
    """Each networked type the JAX package registers is a registered
    ``BackendSpec`` with every DAO, and an app goes through it (its dev
    server running) and back, as through the JAX package's own."""
    from predictionio_tpu.data.storage import _BACKENDS as JAX_BACKENDS
    from predictionio_tpu_torch.data.storage.minimysql import MiniMySQLServer
    from predictionio_tpu_torch.data.storage.minipg import MiniPGServer
    from predictionio_tpu_torch.serving.store_server import (
        create_store_server,
    )

    spec = storage_mod._BACKENDS[kind]
    assert isinstance(spec, BackendSpec)
    assert {f.name for f in dataclasses.fields(spec)
            if getattr(spec, f.name) is None} == {
        f.name for f in dataclasses.fields(JAX_BACKENDS[kind])
        if getattr(JAX_BACKENDS[kind], f.name) is None} == set()
    env = {"PIO_STORAGE_SOURCES_X_TYPE": kind}
    if kind in ("httpstore", "replicated"):
        servers = []
        for _ in range(1 if kind == "httpstore" else 2):
            server = create_store_server(host="127.0.0.1", port=0,
                                         storage=Storage(env={
                                             "PIO_STORAGE_SOURCES_M_TYPE":
                                                 "memory"}))
            server.start()
            servers.append(server)
        urls = ",".join(f"http://127.0.0.1:{s.port}" for s in servers)
        env["PIO_STORAGE_SOURCES_X_URL" + "S" * (kind == "replicated")] = urls
        env["PIO_STORAGE_SOURCES_X_HINT_DIR"] = str(tmp_path / "hints")

        def stop():
            for server in servers:
                server.shutdown()
    else:
        cls, scheme = ((MiniPGServer, "postgresql") if kind == "postgres"
                       else (MiniMySQLServer, "mysql"))
        server = cls(path=str(tmp_path / "dev.db"), password="pio")
        port = server.start()
        env["PIO_STORAGE_SOURCES_X_URL"] = (
            f"{scheme}://pio:pio@127.0.0.1:{port}/pio")
        stop = server.stop
    storages = [Storage(env=env), Storage(env=env)]
    try:
        apps = storages[0].get_meta_data_apps()
        app_id = apps.insert(App(0, "shop", "first"))
        assert storages[1].get_meta_data_apps().get(app_id) == App(
            app_id, "shop", "first")
        assert [a.name for a in apps.get_all()] == ["shop"]
    finally:
        if kind == "replicated":
            for storage in storages:
                storage._client("X").close()
        stop()
