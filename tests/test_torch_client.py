"""The port's client SDK (``EventClient``, ``EngineClient``) against both
packages' servers, beside the JAX package's SDK.

* Both SDKs' ``EventClient`` against both event servers: single events,
  the ``$set`` helpers, find, batches with a bad event, a wrong key, ids
  with URL-special characters, deletes; every combination gives the
  same results (event ids aside).
* Both SDKs' ``EngineClient`` against both engine servers deploying one
  JAX-trained generation: ``status``, ``send_query`` and
  ``send_batch_queries`` answer alike.
* The wire: each request carries the same headers from both SDKs
  (``X-PIO-Deadline``, the tenant, the affinity key, the criticality,
  the forwarded request id), a shed with ``Retry-After`` and
  ``X-PIO-Shed`` is sent again after the wait, a 5xx on a GET is
  retried, and a host that keeps failing opens the breaker.
"""

from __future__ import annotations

import datetime as dt
import re

import numpy as np
import pytest

from predictionio_tpu import client as jax_client
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
from predictionio_tpu_torch import client
from predictionio_tpu_torch.data.storage import AccessKey, App, Storage
from predictionio_tpu_torch.models.recommendation import recommendation_engine
from predictionio_tpu_torch.obs.context import set_request_id
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving import resilience
from predictionio_tpu_torch.serving.engine_server import create_engine_server
from predictionio_tpu_torch.serving.event_server import create_event_server
from predictionio_tpu_torch.serving.http import HTTPServer, Response, Router

SDKS = {"jax": jax_client, "port": client}
_ID = re.compile(r"^[0-9a-f]{32}$")


def _memory_env():
    return {
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
    }


def _event_server(pkg: str):
    storage_cls, app_cls, key_cls, create = {
        "jax": (JaxStorage, JaxApp, JaxAccessKey, jax_create_event_server),
        "port": (Storage, App, AccessKey, create_event_server),
    }[pkg]
    storage = storage_cls(env=_memory_env())
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "sdkapp"))
    storage.get_events().init(app_id)
    storage.get_meta_data_access_keys().insert(key_cls("sdkkey", app_id))
    http = create(host="127.0.0.1", port=0, storage=storage)
    http.start()
    return http


def _event_script(sdk, url: str) -> list:
    c = sdk.EventClient("sdkkey", url)
    out = []
    when = dt.datetime(2024, 2, 3, 4, 5, 6, tzinfo=dt.timezone.utc)
    eid = c.record_user_action_on_item("rate", "u1", "i1",
                                       properties={"rating": 4.0},
                                       event_time=when)
    out.append(bool(_ID.match(eid)))
    got = c.get_event(eid)
    out.append({k: v for k, v in got.items()
                if k not in ("eventId", "creationTime")})
    c.set_user("u1", {"age": 33}, event_time=when)
    c.set_item("i1", {"categories": ["a"]}, event_time=when)
    out.append(sorted(e["entityType"] for e in c.find_events(event="$set")))
    out.append([r["status"] for r in c.create_events([
        {"event": "view", "entityType": "user", "entityId": "u2"},
        {"event": "$bad", "entityType": "user", "entityId": "u3"}])])
    odd = c.create_event("view", "user", "john doe+#&")
    out.append(c.get_event(odd)["entityId"])
    out.append(len(c.find_events(entityId="john doe+#&")))
    c.delete_event(eid)
    for call in (lambda: c.get_event(eid),
                 lambda: sdk.EventClient("wrong", url).set_user("u9")):
        with pytest.raises(sdk.PIOClientError) as e:
            call()
        out.append((e.value.status, e.value.message))
    return out


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_both_event_clients_against_each_event_server(server_pkg):
    got = {}
    for sdk_pkg, sdk in SDKS.items():
        http = _event_server(server_pkg)
        try:
            got[sdk_pkg] = _event_script(sdk, f"http://127.0.0.1:{http.port}")
        finally:
            http.shutdown()
    assert got["port"] == got["jax"]
    assert got["port"][0] is True and got["port"][3] == [201, 400]
    assert [s for s, _m in got["port"][-2:]] == [404, 401]


# -- the engine clients ------------------------------------------------------

N_USERS, N_ITEMS, RANK = 40, 30, 8
VARIANT = {
    "datasource": {"params": {"app_name": "shop"}},
    "algorithms": [
        {"name": "als", "params": {"rank": RANK, "num_iterations": 2}}
    ],
}


@pytest.fixture(scope="module")
def engine_servers(tmp_path_factory):
    """One JAX-trained generation in a sqlite + localfs store, deployed
    by both packages' engine servers; yields their base URLs."""
    root = tmp_path_factory.mktemp("sdk")
    env = {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(root / "pio.sqlite"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(root / "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }
    storage = JaxStorage(env=env)
    app_id = storage.get_meta_data_apps().insert(JaxApp(0, "shop"))
    storage.get_events().init(app_id)
    rng = np.random.default_rng(21)
    storage.get_events().insert_batch([
        JaxEvent(event="rate", entity_type="user", entity_id=f"u{u}",
                 target_entity_type="item", target_entity_id=f"i{i}",
                 properties={"rating": int(r)})
        for u, i, r in zip(rng.integers(0, N_USERS, 500),
                           rng.integers(0, N_ITEMS, 500),
                           rng.integers(1, 6, 500))], app_id)
    engine = jax_engine()
    jax_set_storage(storage)
    try:
        jax_run_train(engine, engine.params_from_variant(VARIANT), "rec",
                      storage=storage)
    finally:
        jax_set_storage(None)
    jax_es = JaxServer(engine, engine.params_from_variant(VARIANT), "rec",
                       storage=storage)
    jax_http = jax_es.serve(host="127.0.0.1", port=0)
    jax_http.start()
    engine = recommendation_engine()
    es, http = create_engine_server(
        engine, engine.params_from_variant(VARIANT), "rec", host="127.0.0.1",
        port=0, storage=Storage(env=env),
        ctx=ComputeContext.create(device="cpu"), max_batch=8,
        max_wait_ms=1.0)
    http.start()
    yield {"jax": f"http://127.0.0.1:{jax_http.port}",
           "port": f"http://127.0.0.1:{http.port}"}
    jax_http.shutdown()
    jax_es.close()
    es.close()


def _scores(answer) -> list:
    return [(e["item"], round(e["score"], 4)) for e in answer["itemScores"]]


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_both_engine_clients_against_each_engine_server(engine_servers,
                                                        server_pkg):
    url = engine_servers[server_pkg]
    queries = [{"user": f"u{u}", "num": n}
               for u, n in zip(range(0, N_USERS, 3), [1, 3, 5, 10] * 4)]
    got = {}
    for sdk_pkg, sdk in SDKS.items():
        c = sdk.EngineClient(url, tenant="acme")
        status = c.status()
        singles = [c.send_query(q, affinity=q["user"]) for q in queries]
        critical = c.send_query(queries[0], criticality="critical")
        batch = c.send_batch_queries(queries + [{"user": "nobody",
                                                 "num": 2}])
        got[sdk_pkg] = (status["engineId"], singles, critical, batch)
    assert got["port"] == got["jax"]
    # the two servers agree too, on the same generation
    other = client.EngineClient(
        engine_servers["jax" if server_pkg == "port" else "port"])
    for q, answer in zip(queries, got["port"][1]):
        assert [i for i, _s in _scores(other.send_query(q))] == [
            i for i, _s in _scores(answer)]
    assert got["port"][3][-1] == {"status": 200,
                                  "prediction": {"itemScores": []}}


# -- the wire ----------------------------------------------------------------


@pytest.fixture()
def scripted():
    """A server that records each request's headers and answers from a
    script of (status, headers, body), then 200."""
    seen, replies = [], []

    def handler(request):
        seen.append({k: request.headers.get(k) for k in (
            "X-PIO-Tenant", "X-PIO-Affinity", "X-PIO-Criticality",
            "X-Request-ID", "Content-Type")} | {
            "deadline": request.headers.get("X-PIO-Deadline") is not None,
            "path": request.path})
        if replies:
            status, headers, body = replies.pop(0)
            resp = Response(status, body)
            for k, v in headers.items():
                resp.headers[k] = v
            return resp
        return Response(200, {"ok": True, "eventId": "e1"})

    router = Router()
    for path in ("/queries.json", "/batch/queries.json", "/events.json"):
        router.route("POST", path, handler)
    router.route("GET", "/probe", handler)
    http = HTTPServer(router, host="127.0.0.1", port=0)
    http.start()
    yield f"http://127.0.0.1:{http.port}", seen, replies
    http.shutdown()


def test_both_sdks_send_the_same_headers(scripted):
    import contextvars

    from predictionio_tpu.obs.context import (
        set_request_id as jax_set_request_id,
    )

    base, seen, _replies = scripted

    def calls(sdk, set_id):
        sdk.EngineClient(base, tenant="acme").send_query(
            {"x": 1}, affinity="user-7", criticality="sheddable")
        sdk.EngineClient(base).send_batch_queries([{"x": 1}])
        set_id("req-123")
        sdk.EventClient("k", base).create_event("view", "user", "u1")

    got = {}
    for pkg, set_id in (("jax", jax_set_request_id),
                        ("port", set_request_id)):
        seen.clear()
        # a fresh context: no request id until the script sets one
        contextvars.Context().run(calls, SDKS[pkg], set_id)
        got[pkg] = list(seen)
    assert got["port"] == got["jax"]
    assert got["port"][0]["X-PIO-Tenant"] == "acme"
    assert got["port"][0]["X-PIO-Affinity"] == "user-7"
    assert got["port"][0]["X-PIO-Criticality"] == "sheddable"
    assert got["port"][0]["X-Request-ID"] is None
    assert got["port"][2]["X-Request-ID"] == "req-123"
    assert all(s["deadline"] for s in got["port"])


@pytest.mark.parametrize("case", ["shed_then_ok", "shed_unmarked",
                                  "get_5xx_retried", "breaker_opens"])
def test_both_sdks_retry_and_break_alike(scripted, case, monkeypatch):
    base, seen, replies = scripted
    monkeypatch.setenv("PIO_RETRY_BASE_MS", "1")
    got = {}
    for pkg, sdk in SDKS.items():
        seen.clear()
        replies.clear()
        if pkg == "port":
            resilience.reset_breakers()
        else:
            from predictionio_tpu.serving import resilience as jax_res

            jax_res.reset_breakers()
        shed = (503, {"Retry-After": "0", "X-PIO-Shed": "overload"},
                {"message": "shed"})
        if case == "shed_then_ok":
            replies += [shed, shed]
            call = lambda: sdk.EngineClient(base).send_query({"x": 1})  # noqa: E731
        elif case == "shed_unmarked":
            replies += [(503, {"Retry-After": "0"}, {"message": "busy"})]
            call = lambda: sdk.EngineClient(base).send_query({"x": 1})  # noqa: E731
        elif case == "get_5xx_retried":
            replies += [(500, {}, {"message": "boom"})]
            call = lambda: sdk._request(base + "/probe")  # noqa: E731
        else:
            replies += [(500, {}, {"message": "boom"})] * 50
            call = lambda: sdk._request(base + "/probe")  # noqa: E731
        outcome = []
        for _ in range(3 if case == "breaker_opens" else 1):
            try:
                outcome.append(call())
            except Exception as e:  # noqa: BLE001 - compared across SDKs
                outcome.append((type(e).__name__,
                                getattr(e, "status", None)))
        got[pkg] = (outcome, len(seen))
    assert got["port"] == got["jax"], got
    if case == "shed_then_ok":
        assert got["port"] == ([{"ok": True, "eventId": "e1"}], 3)
    if case == "shed_unmarked":
        assert got["port"] == ([("PIOClientError", 503)], 1)
    if case == "get_5xx_retried":
        assert got["port"] == ([{"ok": True, "eventId": "e1"}], 2)
    if case == "breaker_opens":
        assert got["port"][0][-1] == ("CircuitOpenError", None)
