"""One engine server under load and across generations: the port's
against the JAX package's, on the CPU, on one JAX-trained generation.

The JAX package trains ALS (rank 8, 3 iterations) on seeded ``rate``
events into a shared sqlite + localfs store; both packages' engine
servers deploy that generation with the query cache on, a canary
config, and an admission controller at a fixed limit of 10 whose
in-flight count the test pre-loads (six requests of tenant ``hot``, one
of ``b``), so that what a concurrent load would decide is deterministic
for sequential requests:

* a seeded script of ~120 ``/queries.json`` with ``X-PIO-Criticality``,
  ``X-PIO-Tenant``, ``X-PIO-Deadline`` and ``Cache-Control`` headers
  gets the same status codes (200, 503 by class, 429 by fair share,
  504 for a spent budget), the same ``X-PIO-Shed`` and ``X-PIO-Cache``
  values, a ``Retry-After`` on every shed, and the same bodies: error
  messages equal, answers naming the same items with scores within
  1e-5 (XLA and torch sum in different orders);
* a cached (or coalesced) 200 carries the same bytes as the miss that
  filled it;
* ``/reload {"canary": true}`` of a generation 2 (the item factors
  × (1 + 1e-4·N(0,1))) answers 202 in both, and both end ``stable``
  with it serving; a generation 3 with NaN item rows ends ``rejected``
  in both, and generation 2 keeps answering;
* drain: with four requests in flight (``PIO_CHAOS`` holds each 300 ms),
  ``begin_drain`` lets all four end 200, refuses new work with 503 and
  ``Retry-After``, ``/healthz`` answers ``draining`` and
  ``pio_server_draining`` reads 1, in both packages.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime as dt
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.core.persistence import (
    deserialize_models as jax_deserialize,
    load_generation as jax_load_generation,
    publish_generation as jax_publish,
    serialize_models as jax_serialize,
)
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import (
    App as JaxApp,
    EngineInstance as JaxInstance,
    Storage as JaxStorage,
    set_storage as jax_set_storage,
)
from predictionio_tpu.models.recommendation import (
    ALSAlgorithm as JaxALS,
    recommendation_engine as jax_engine,
)
from predictionio_tpu.obs import MetricRegistry as JaxRegistry
from predictionio_tpu.serving import admission as jax_adm
from predictionio_tpu.serving import canary as jax_canary
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.models.recommendation import recommendation_engine
from predictionio_tpu_torch.obs import MetricRegistry
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving import admission as adm
from predictionio_tpu_torch.serving import canary
from predictionio_tpu_torch.serving.engine_server import EngineServer

N_USERS, N_ITEMS, RANK = 60, 40, 8
VARIANT = {
    "datasource": {"params": {"app_name": "shop"}},
    "algorithms": [
        {"name": "als", "params": {"rank": RANK, "num_iterations": 3}}
    ],
}
TOL = dict(rtol=1e-5, atol=1e-5)


def _env(root):
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(root / "pio.sqlite"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(root / "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A JAX-trained generation in a sqlite + localfs store both
    packages read; returns (env, JAX storage, the JAX model)."""
    root = tmp_path_factory.mktemp("load")
    env = _env(root)
    storage = JaxStorage(env=env)
    app_id = storage.get_meta_data_apps().insert(JaxApp(0, "shop"))
    storage.get_events().init(app_id)
    rng = np.random.default_rng(11)
    storage.get_events().insert_batch([
        JaxEvent(event="rate", entity_type="user", entity_id=f"u{u}",
                 target_entity_type="item", target_entity_id=f"i{i}",
                 properties={"rating": int(r)})
        for u, i, r in zip(rng.integers(0, N_USERS, 900),
                           rng.zipf(1.3, 900) % N_ITEMS,
                           rng.integers(1, 6, 900))
    ], app_id)
    engine = jax_engine()
    jax_set_storage(storage)
    try:
        iid = jax_run_train(engine, engine.params_from_variant(VARIANT),
                            "rec", storage=storage)
    finally:
        jax_set_storage(None)
    (_, model), = jax_deserialize(
        jax_load_generation(storage.get_model_data_models(), iid))
    return env, storage, model


def _publish_jax(storage, model):
    """A new COMPLETED generation of ``model``, published by the JAX
    package; returns its instance id."""
    now = dt.datetime.now(dt.timezone.utc)
    instances = storage.get_meta_data_engine_instances()
    iid = instances.insert(JaxInstance(
        id="", status="INIT", start_time=now, end_time=now,
        engine_id="rec", engine_version="1", engine_variant="default",
        engine_factory="recommendation"))
    jax_publish(storage.get_model_data_models(), iid,
                jax_serialize(iid, [JaxALS()], [model]))
    instances.update(dataclasses.replace(instances.get(iid),
                                         status="COMPLETED"))
    return iid


_ADMISSION = dict(initial_limit=10.0, min_limit=10.0, max_limit=10.0)
_CANARY = dict(shadow_sample=1.0, min_shadow=5, max_divergence=0.05,
               watch_min_requests=5, watch_s=0.0, latency_factor=1000.0)


def _servers(env, jax_storage, preload=True):
    """Both packages' engine servers on the store, started; each with
    its admission controller pre-loaded to 7 of 10 in flight (unless
    ``preload`` is False)."""
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            engine = jax_engine()
            registry = JaxRegistry()
            ctl = jax_adm.AdmissionController(
                "engine", registry=registry,
                config=jax_adm.AdmissionConfig(**_ADMISSION))
            server = JaxServer(
                engine, engine.params_from_variant(VARIANT), "rec",
                storage=jax_storage, max_batch=8, max_wait_ms=1.0,
                registry=registry, admission=ctl, cache=True,
                canary=jax_canary.CanaryConfig(**_CANARY))
        else:
            engine = recommendation_engine()
            registry = MetricRegistry()
            ctl = adm.AdmissionController(
                "engine", registry=registry,
                config=adm.AdmissionConfig(**_ADMISSION))
            server = EngineServer(
                engine, engine.params_from_variant(VARIANT), "rec",
                storage=Storage(env=env),
                ctx=ComputeContext.create(device="cpu"), max_batch=8,
                max_wait_ms=1.0, registry=registry, admission=ctl,
                cache=True, canary=canary.CanaryConfig(**_CANARY))
        for tenant in ["hot"] * 6 + ["b"] if preload else []:
            ctl.try_acquire("critical", tenant)
        http = server.serve(host="127.0.0.1", port=0)
        http.start()
        out[pkg] = (server, http, f"http://127.0.0.1:{http.port}")
    return out


def _call(base, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        base + path, data=data, method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _script(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(120):
        headers = {}
        cls = ["critical", "default", "sheddable", None][
            rng.choice(4, p=[.35, .35, .2, .1])]
        if cls:
            headers["X-PIO-Criticality"] = cls
        tenant = [None, "hot", "b"][rng.choice(3, p=[.6, .25, .15])]
        if tenant:
            headers["X-PIO-Tenant"] = tenant
        budget = [None, "0", "60000"][rng.choice(3, p=[.7, .1, .2])]
        if budget:
            headers["X-PIO-Deadline"] = budget
        if rng.random() < 0.1:
            headers["Cache-Control"] = "no-cache"
        user = f"u{int(rng.zipf(1.5)) % (N_USERS + 5)}"
        out.append(({"user": user, "num": int(rng.choice([3, 5]))},
                    headers))
    out.append(([1, 2], {"X-PIO-Criticality": "critical"}))
    return out


def _body(raw):
    body = json.loads(raw)
    if isinstance(body, dict):
        body.pop("requestId", None)
    return body


def _same_answer(got, want):
    if "itemScores" not in want:
        assert got == want
        return
    assert [e["item"] for e in got["itemScores"]] == [
        e["item"] for e in want["itemScores"]]
    np.testing.assert_allclose([e["score"] for e in got["itemScores"]],
                               [e["score"] for e in want["itemScores"]],
                               **TOL)


def _drive_until(base, state, queries, limit=400):
    for i in range(limit):
        q = queries[i % len(queries)]
        status, _, _ = _call(base, "/queries.json", q,
                             {"X-PIO-Criticality": "critical",
                              "Cache-Control": "no-cache"})
        assert status == 200
        _, _, raw = _call(base, "/canary")
        if json.loads(raw)["state"] in state:
            return json.loads(raw)
        time.sleep(0.002)
    return json.loads(_call(base, "/canary")[2])


def test_same_answers_under_load_and_across_generations(store):
    env, jax_storage, model = store
    servers = _servers(env, jax_storage)
    try:
        answers = {}
        for pkg, (_, _, base) in servers.items():
            answers[pkg] = [_call(base, "/queries.json", body, headers)
                            for body, headers in _script(5)]
        seen = set()
        cached_bytes = {}
        for i, ((ws, wh, wb), (gs, gh, gb)) in enumerate(
                zip(answers["jax"], answers["torch"])):
            assert gs == ws, (i, gs, ws, gb, wb)
            for h in ("X-PIO-Shed", "X-PIO-Cache"):
                assert gh.get(h) == wh.get(h), (i, h)
            if gs in (429, 503):
                assert "Retry-After" in gh and float(gh["Retry-After"]) > 0
                assert gh.get("X-PIO-Shed") in ("limit", "fairshare")
            _same_answer(_body(gb), _body(wb))
            seen.add((gs, gh.get("X-PIO-Shed"), gh.get("X-PIO-Cache")))
            body, _ = _script(5)[i]
            if gs == 200 and gh.get("X-PIO-Cache"):
                # a hit answers with the bytes the miss served
                key = json.dumps(body, sort_keys=True)
                cached_bytes.setdefault(key, gb)
                assert gb == cached_bytes[key]
        statuses = {s for s, _, _ in seen}
        assert {200, 429, 503, 504, 400} <= statuses
        assert (200, None, "hit") in seen and (200, None, "miss") in seen

        # generation 2: the item factors × (1 + 1e-4·N(0, 1))
        rng = np.random.default_rng(7)
        items = np.asarray(model.item_factors)
        g2 = dataclasses.replace(model, item_factors=(
            items * (1 + 1e-4 * rng.standard_normal(items.shape))
        ).astype(np.float32))
        iid2 = _publish_jax(jax_storage, g2)
        queries = [{"user": f"u{u}", "num": 3} for u in range(0, 40, 3)]
        states = {}
        for pkg, (server, _, base) in servers.items():
            status, _, raw = _call(base, "/reload", {"canary": True})
            assert status == 202 and json.loads(raw)["engineInstanceId"] == (
                iid2)
            states[pkg] = _drive_until(base, ("stable", "rejected",
                                               "rolled_back"), queries)
        assert states["torch"]["state"] == states["jax"]["state"] == "stable"
        for key in ("servingInstanceId", "generation"):
            assert states["torch"][key] == states["jax"][key]
        assert states["torch"]["servingInstanceId"] == iid2

        # generation 3: half the item rows NaN
        g3_items = np.array(g2.item_factors)
        g3_items[::2] = np.nan
        iid3 = _publish_jax(jax_storage,
                            dataclasses.replace(model, item_factors=g3_items))
        for pkg, (server, _, base) in servers.items():
            status, _, raw = _call(base, "/reload", {"canary": True})
            assert status == 202 and json.loads(raw)["engineInstanceId"] == (
                iid3)
            states[pkg] = _drive_until(base, ("stable", "rejected",
                                               "rolled_back"), queries)
        assert states["torch"]["state"] == states["jax"]["state"] == (
            "rejected")
        assert states["torch"]["servingInstanceId"] == iid2
        after = {pkg: _body(_call(base, "/queries.json", queries[1],
                                  {"X-PIO-Criticality": "critical"})[2])
                 for pkg, (_, _, base) in servers.items()}
        _same_answer(after["torch"], after["jax"])
        status = json.loads(_call(servers["torch"][2], "/")[2])
        assert status["canaryState"] == "rejected"
        assert status["engineInstanceId"] == iid2
    finally:
        for server, http, _ in servers.values():
            http.shutdown()
            server.close()


@pytest.fixture()
def chaos_latency(monkeypatch):
    monkeypatch.setenv("PIO_CHAOS", "latency:p=1,ms=300")
    monkeypatch.setenv("PIO_CHAOS_SEED", "1")


def test_drain_answers_in_flight_and_refuses_new(store, chaos_latency):
    env, jax_storage, _ = store
    servers = _servers(env, jax_storage, preload=False)
    got = {}
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            for pkg, (server, http, base) in servers.items():
                inflight = [pool.submit(
                    _call, base, "/queries.json", {"user": f"u{i}",
                                                   "num": 3},
                    {"X-PIO-Criticality": "critical"}) for i in range(4)]
                deadline = time.monotonic() + 10
                while http.inflight < 4 and time.monotonic() < deadline:
                    time.sleep(0.005)
                assert http.inflight == 4
                http.begin_drain()
                refused = _call(base, "/queries.json", {"user": "u1"},
                                {"X-PIO-Criticality": "critical"})
                health = _call(base, "/healthz")
                metrics = _call(base, "/metrics")[2].decode()
                done = [f.result(30) for f in inflight]
                t0 = time.monotonic()
                clean = http.drain(grace_s=5.0)
                got[pkg] = dict(
                    done=[s for s, _, _ in done],
                    refused=(refused[0], refused[1].get("Retry-After"),
                             _body(refused[2])),
                    health=(health[0], json.loads(health[2])["status"]),
                    draining=[line for line in metrics.splitlines()
                              if line.startswith("pio_server_draining")],
                    clean=clean, seconds=time.monotonic() - t0)
    finally:
        for server, http, _ in servers.values():
            http.shutdown()
            server.close()
    assert got["torch"]["done"] == got["jax"]["done"] == [200] * 4
    for key in ("refused", "health", "draining", "clean"):
        assert got["torch"][key] == got["jax"][key], key
    assert got["torch"]["refused"][:2] == (503, "1")
    assert got["torch"]["health"] == (503, "draining")
    assert got["torch"]["draining"] == [
        'pio_server_draining{service="engine"} 1']
    assert got["torch"]["clean"] and got["torch"]["seconds"] < 5.0


def _events(metrics_text, event):
    return sum(float(line.rsplit(" ", 1)[1])
               for line in metrics_text.splitlines()
               if line.startswith("pio_canary_events_total")
               and f'event="{event}"' in line)


def test_a_failed_shadow_launch_vetoes_the_canary(store):
    """The port's shadow path launches on the staged generation or
    raises: a launch that fails there (a ``RuntimeError``, as a failed
    CUDA launch raises) rejects the canary, while a staged batcher that
    is already closed only drops the shadow score. The JAX server drops
    both (ROADMAP §3), so this holds the port alone."""
    env, jax_storage, model = store
    engine = recommendation_engine()
    server = EngineServer(
        engine, engine.params_from_variant(VARIANT), "rec",
        storage=Storage(env=env), ctx=ComputeContext.create(device="cpu"),
        max_batch=8, max_wait_ms=1.0, registry=MetricRegistry(),
        admission=False, cache=True, canary=canary.CanaryConfig(**_CANARY))
    http = server.serve(host="127.0.0.1", port=0)
    http.start()
    base = f"http://127.0.0.1:{http.port}"
    queries = [{"user": f"u{u}", "num": 3} for u in range(0, 40, 3)]
    try:
        serving = _call(base, "/canary")[2]
        serving_id = json.loads(serving)["servingInstanceId"]

        def failed_launch(items):
            raise RuntimeError("fused_topk: CUDA launch failed")

        iid = _publish_jax(jax_storage, model)
        status, _, raw = _call(base, "/reload", {"canary": True})
        assert status == 202 and json.loads(raw)["engineInstanceId"] == iid
        for b in server._canary.staged.batchers:
            b._dispatch_fn = failed_launch
        state = _drive_until(base, ("stable", "rejected", "rolled_back"),
                             queries)
        assert state["state"] == "rejected", state
        assert "CUDA launch failed" in state["reason"], state
        assert state["servingInstanceId"] == serving_id
        metrics = _call(base, "/metrics")[2].decode()
        assert _events(metrics, "shadow_error") >= 1

        iid = _publish_jax(jax_storage, model)
        status, _, raw = _call(base, "/reload", {"canary": True})
        assert status == 202 and json.loads(raw)["engineInstanceId"] == iid
        for b in server._canary.staged.batchers:
            b.close()
        for q in queries:
            assert _call(base, "/queries.json", q,
                         {"Cache-Control": "no-cache"})[0] == 200
        deadline = time.monotonic() + 10
        while _events(_call(base, "/metrics")[2].decode(),
                      "shadow_dropped") < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert json.loads(_call(base, "/canary")[2])["state"] == "shadowing"
    finally:
        http.shutdown()
        server.close()
