"""Multi-tenant engine servers: the port's against the JAX package's, on
the CPU, on JAX-trained generations of three tenant variants.

The JAX package trains ALS (rank 8, 3 iterations, one seed per variant)
on seeded ``rate`` events into a shared sqlite + localfs store, one
engine variant per tenant. Both packages' engine servers serve the
three tenants through a model pool whose budget fits one tenant, so
every change of tenant evicts one and loads another:

* a seeded script (``accessKey`` and ``X-PIO-Tenant`` routing, a query
  naming no tenant (400), an unknown tenant (404), batch queries per
  tenant, a per-tenant ``/reload`` of a new generation, a reload naming
  no tenant or an unknown one, the status route and the metrics) gets
  the same statuses and bodies: messages equal with the request id
  masked, answers naming the same items with scores within 1e-5 (XLA
  and torch sum in different orders); the status route's pool section,
  tenants and generations are equal, and so are the ``pio_pool_*`` and
  labelled ``pio_model_generation`` samples;
* an eviction racing queries in flight is lossless (after JAX
  ``tests/test_engine_server_mt.py:241``): two threads alternate two
  tenants through a pool that holds one, and every answer is 200 and
  equal to the plain top-k of that tenant's factors (the tenants whose
  variants no other test republishes);
* tenants served as int8 + scale or bf16 tables (``quantize``) answer
  as the JAX package's quantized tenants do, within the tolerance of
  ``test_torch_quantize.py`` (items equal, scores within 1e-5);
* a canary and tenants refuse each other in both packages;
* the ``accessKey`` ambiguity under key auth: in a pooled server
  ``accessKey`` names the tenant and is also the last place the server
  key is looked for, so ``/reload?accessKey=alice`` is 401 unless the
  server key is ``alice``, and a key sent as ``accessKey`` then names a
  tenant that does not exist (404); with the key in a header the reload
  goes through, and queries stay open, in both packages alike.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import json
import threading
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
from predictionio_tpu.serving.config import ServerConfig as JaxConfig
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_tpu.serving.modelpool import ModelPool as JaxPool
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.models.recommendation import recommendation_engine
from predictionio_tpu_torch.obs import MetricRegistry
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving.config import ServerConfig
from predictionio_tpu_torch.serving.engine_server import EngineServer
from predictionio_tpu_torch.serving.modelpool import ModelPool

N_USERS, N_ITEMS, RANK = 60, 40, 8
TENANTS = {"alice": "va", "bob": "vb", "carol": "vc"}
SEEDS = {"va": 3, "vb": 7, "vc": 11}
TOL = dict(rtol=1e-5, atol=1e-5)
#: one tenant's factor tables: (users + items) × rank × 4 bytes
TENANT_BYTES = (N_USERS + N_ITEMS) * RANK * 4


def _variant(seed: int) -> dict:
    return {
        "datasource": {"params": {"app_name": "shop"}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "num_iterations": 3, "seed": seed}}],
    }


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
    """Three JAX-trained variants in a sqlite + localfs store both
    packages read; returns (env, JAX storage, {variant: JAX model})."""
    root = tmp_path_factory.mktemp("mt")
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
    models = {}
    jax_set_storage(storage)
    try:
        for variant, seed in SEEDS.items():
            iid = jax_run_train(
                engine, engine.params_from_variant(_variant(seed)), "rec",
                engine_variant=variant, storage=storage)
            (_, models[variant]), = jax_deserialize(jax_load_generation(
                storage.get_model_data_models(), iid))
    finally:
        jax_set_storage(None)
    return env, storage, models


def _publish_jax(storage, model, variant):
    """A new COMPLETED generation of ``model`` under ``variant``,
    published by the JAX package."""
    now = dt.datetime.now(dt.timezone.utc)
    instances = storage.get_meta_data_engine_instances()
    iid = instances.insert(JaxInstance(
        id="", status="INIT", start_time=now, end_time=now,
        engine_id="rec", engine_version="1", engine_variant=variant,
        engine_factory="recommendation"))
    jax_publish(storage.get_model_data_models(), iid,
                jax_serialize(iid, [JaxALS()], [model]))
    instances.update(dataclasses.replace(instances.get(iid),
                                         status="COMPLETED"))
    return iid


def _servers(env, jax_storage, budget, quantize=None, key=None):
    """Both packages' multi-tenant servers on the store, started, each
    with a pool of ``budget`` bytes; returns {pkg: (server, http, base,
    registry, pool)}."""
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            engine, registry = jax_engine(), JaxRegistry()
            pool = JaxPool(budget, registry=registry)
            server = JaxServer(
                engine, engine.params_from_variant(_variant(3)), "rec",
                storage=jax_storage, max_batch=4, max_wait_ms=1.0,
                registry=registry, admission=False, tenants=TENANTS,
                pool=pool, quantize=quantize,
                server_config=JaxConfig(key is not None, key or ""))
        else:
            engine, registry = recommendation_engine(), MetricRegistry()
            pool = ModelPool(budget, registry=registry)
            server = EngineServer(
                engine, engine.params_from_variant(_variant(3)), "rec",
                storage=Storage(env=env),
                ctx=ComputeContext.create(device="cpu"), max_batch=4,
                max_wait_ms=1.0, registry=registry, admission=False,
                tenants=TENANTS, pool=pool, quantize=quantize,
                server_config=ServerConfig(key is not None, key or ""))
        http = server.serve(host="127.0.0.1", port=0)
        http.start()
        out[pkg] = (server, http, f"http://127.0.0.1:{http.port}",
                    registry, pool)
    return out


def _close(servers):
    for server, http, _, _, pool in servers.values():
        http.shutdown()
        server.close()
        pool.close()


def _call(base, path, body=None, headers=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        base + path, data=data,
        method=method or ("GET" if body is None else "POST"),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _masked(body):
    if isinstance(body, dict):
        body = {k: v for k, v in body.items() if k != "requestId"}
    return body


def _same(got, want, where):
    got, want = _masked(got), _masked(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for g, w in zip(got, want):
            assert g["status"] == w["status"], where
            _same(g.get("prediction", g), w.get("prediction", w), where)
        return
    if not isinstance(want, dict) or "itemScores" not in want:
        assert got == want, where
        return
    assert [e["item"] for e in got["itemScores"]] == [
        e["item"] for e in want["itemScores"]], where
    np.testing.assert_allclose([e["score"] for e in got["itemScores"]],
                               [e["score"] for e in want["itemScores"]],
                               **TOL, err_msg=str(where))


def _script(seed):
    """(path, body, headers) of a seeded mix of routed queries."""
    rng = np.random.default_rng(seed)
    names = sorted(TENANTS)
    out = [
        ("/queries.json", {"user": "u1", "num": 4}, {}),
        ("/queries.json?accessKey=mallory", {"user": "u1", "num": 4}, {}),
        ("/queries.json", {"user": "u1", "num": 4},
         {"X-PIO-Tenant": "mallory"}),
        ("/batch/queries.json?accessKey=carol",
         [{"user": "u2", "num": 3}, {"user": "u5", "num": 5}, "bogus"], {}),
        ("/batch/queries.json", [{"user": "u7", "num": 2}],
         {"X-PIO-Tenant": "bob"}),
    ]
    for _ in range(36):
        tenant = names[int(rng.integers(0, len(names)))]
        body = {"user": f"u{int(rng.integers(0, N_USERS + 3))}",
                "num": int(rng.choice([1, 3, 5, 50]))}
        if rng.random() < 0.5:
            out.append((f"/queries.json?accessKey={tenant}", body, {}))
        else:
            out.append(("/queries.json", body, {"X-PIO-Tenant": tenant}))
    return out


def _samples(registry, *prefixes):
    return sorted(
        line for line in registry.render_prometheus().splitlines()
        if line.startswith(prefixes)
    )


def _status_view(body):
    return {k: body[k] for k in ("multiTenant", "tenants",
                                 "tenantGenerations", "pool")}


def test_same_answers_routing_and_reload(store):
    env, jax_storage, models = store
    servers = _servers(env, jax_storage, int(TENANT_BYTES * 1.5))
    try:
        for pkg, (server, _, base, _, pool) in servers.items():
            assert pool.stats()["tenants"] and pool.resident() == ["carol"]
        script = _script(5)
        answers = {pkg: [_call(base, path, body, headers)
                         for path, body, headers in script]
                   for pkg, (_, _, base, _, _) in servers.items()}
        statuses = []
        for i, (want, got) in enumerate(zip(answers["jax"],
                                            answers["torch"])):
            assert got[0] == want[0], (i, script[i], got, want)
            _same(got[1], want[1], (i, script[i]))
            statuses.append(got[0])
        assert statuses[:3] == [400, 404, 404]
        assert statuses.count(200) == len(script) - 3

        views = {pkg: _status_view(_call(base, "/")[1])
                 for pkg, (_, _, base, _, _) in servers.items()}
        assert views["torch"] == views["jax"]
        assert views["torch"]["pool"]["evictions"] > 10
        (resident,) = views["torch"]["pool"]["tenants"].values()
        assert resident["residentBytes"] == TENANT_BYTES

        # a new generation of alice's variant, then her reload alone
        model = models["va"]
        rng = np.random.default_rng(9)
        items = np.asarray(model.item_factors)
        _publish_jax(jax_storage, dataclasses.replace(model, item_factors=(
            items * (1 + 0.5 * rng.standard_normal(items.shape))
        ).astype(np.float32)), "va")
        reloads = [({"tenant": "alice"}, {}, ""), ({}, {}, ""),
                   ({"tenant": "mallory"}, {}, ""),
                   (None, {"X-PIO-Tenant": "bob"}, ""),
                   (None, {}, "?accessKey=carol")]
        after = [("/queries.json?accessKey=alice", {"user": f"u{u}",
                                                    "num": 5}, {})
                 for u in range(0, N_USERS, 7)]
        for pkg, (_, _, base, _, _) in servers.items():
            answers[pkg] = [
                _call(base, "/reload" + qs, body, headers, method="POST")
                for body, headers, qs in reloads
            ] + [_call(base, path, body, headers)
                 for path, body, headers in after]
        got_reloads = [s for s, _ in answers["torch"][:len(reloads)]]
        assert got_reloads == [200, 400, 404, 200, 200]
        reloaded = answers["torch"][0][1]
        assert (reloaded["message"], reloaded["tenant"]) == (
            "reloaded", "alice")
        for i, (want, got) in enumerate(zip(answers["jax"],
                                            answers["torch"])):
            assert got[0] == want[0], (i, got, want)
            _same(got[1], want[1], ("after reload", i))

        views = {pkg: _status_view(_call(base, "/")[1])
                 for pkg, (_, _, base, _, _) in servers.items()}
        assert views["torch"] == views["jax"]
        # a generation counts every load of the tenant: its reload and
        # each load after an eviction
        assert views["torch"]["tenantGenerations"]["alice"] >= 2
        metrics = {pkg: _samples(registry, "pio_pool_",
                                 "pio_model_generation{")
                   for pkg, (_, _, _, registry, _) in servers.items()}
        assert metrics["torch"] == metrics["jax"]
        assert any(line.startswith('pio_pool_evictions_total{tenant="bob"}')
                   for line in metrics["torch"])
    finally:
        _close(servers)


def _plain_top(model, user: str, num: int) -> list[str]:
    users = np.asarray(model.user_factors, np.float64)
    items = np.asarray(model.item_factors, np.float64)
    row = users[model.user_map(user)] @ items.T
    order = np.argsort(-row, kind="stable")[:num]
    inverse = {v: k for k, v in model.item_map.to_dict().items()}
    return [inverse[int(i)] for i in order]


def test_eviction_racing_queries_in_flight_is_lossless(store):
    env, _, models = store
    registry = MetricRegistry()
    pool = ModelPool(int(TENANT_BYTES * 1.5), registry=registry)
    engine = recommendation_engine()
    server = EngineServer(
        engine, engine.params_from_variant(_variant(3)), "rec",
        storage=Storage(env=env), ctx=ComputeContext.create(device="cpu"),
        max_batch=4, registry=registry, tenants=TENANTS, pool=pool,
        warmup=False, admission=False)
    http = server.serve(host="127.0.0.1", port=0)
    http.start()
    base = f"http://127.0.0.1:{http.port}"
    errors = []

    def hammer(tenant):
        model = models[TENANTS[tenant]]
        for i in range(8):
            user = f"u{(i * 5) % N_USERS}"
            status, body = _call(base, f"/queries.json?accessKey={tenant}",
                                 {"user": user, "num": 4})
            if status != 200 or [e["item"] for e in body["itemScores"]] \
                    != _plain_top(model, user, 4):
                errors.append((tenant, i, status, body))

    try:
        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in ("bob", "carol")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        assert pool.stats()["evictions"] >= 1
        assert "pio_pool_evictions_total" in registry.render_prometheus()
    finally:
        http.shutdown()
        server.close()
        pool.close()


@pytest.mark.parametrize("quantize", ["int8", "bf16"])
def test_quantized_tenants_answer_like_jax(store, quantize):
    env, jax_storage, _ = store
    servers = _servers(env, jax_storage, 10 * TENANT_BYTES, quantize)
    try:
        script = [s for s in _script(8) if s[0] != "/queries.json"
                  or s[2].get("X-PIO-Tenant") != "mallory"][5:]
        for i, (path, body, headers) in enumerate(script):
            want = _call(servers["jax"][2], path, body, headers)
            got = _call(servers["torch"][2], path, body, headers)
            assert got[0] == want[0] == 200, (i, got, want)
            _same(got[1], want[1], (quantize, i))
        views = {pkg: _status_view(_call(base, "/")[1])
                 for pkg, (_, _, base, _, _) in servers.items()}
        assert views["torch"] == views["jax"]
        per_tenant = views["torch"]["pool"]["tenants"]["alice"]
        assert per_tenant["residentBytes"] < TENANT_BYTES
    finally:
        _close(servers)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_canary_and_tenants_refuse_each_other(store, pkg):
    env, jax_storage, _ = store
    if pkg == "jax":
        engine = jax_engine()
        make = lambda **kw: JaxServer(  # noqa: E731
            engine, engine.params_from_variant(_variant(3)), "rec",
            storage=jax_storage, **kw)
    else:
        engine = recommendation_engine()
        make = lambda **kw: EngineServer(  # noqa: E731
            engine, engine.params_from_variant(_variant(3)), "rec",
            storage=Storage(env=env),
            ctx=ComputeContext.create(device="cpu"), **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        make(tenants=TENANTS, canary=True)


def test_an_evicted_tenant_frees_its_tables(store, monkeypatch):
    """The pool's close ends the tenant's batchers and drops the staged
    generation, so its tables are freed by reference count alone (the
    collector off), as the card's memory must be when a tenant leaves."""
    import gc
    import weakref

    from predictionio_tpu_torch.models import recommendation as rec

    env, _, _ = store
    staged = {}
    real_stage = rec.ALSAlgorithm.stage_model

    def stage_model(self, ctx, model):
        out = real_stage(self, ctx, model)
        staged.setdefault(len(staged), weakref.ref(out.item_factors))
        return out

    monkeypatch.setattr(rec.ALSAlgorithm, "stage_model", stage_model)
    pool = ModelPool(int(TENANT_BYTES * 1.5))
    engine = recommendation_engine()
    server = EngineServer(
        engine, engine.params_from_variant(_variant(3)), "rec",
        storage=Storage(env=env), ctx=ComputeContext.create(device="cpu"),
        max_batch=4, tenants=TENANTS, pool=pool, admission=False)
    gc.collect()
    gc.disable()
    try:
        http = server.serve(host="127.0.0.1", port=0)
        http.start()
        base = f"http://127.0.0.1:{http.port}"
        for tenant in ("alice", "bob", "carol", "alice"):
            assert _call(base, f"/queries.json?accessKey={tenant}",
                         {"user": "u1", "num": 3})[0] == 200
        # the loader thread closes the evicted entry; give it a moment
        alive = None
        for _ in range(100):
            alive = [i for i, ref in staged.items() if ref() is not None]
            if len(alive) == 1:
                break
            time.sleep(0.02)
        # three preloads, then four cold loads: only the last is held
        assert len(staged) == 7 and alive == [6], (len(staged), alive)
        assert pool.resident() == ["alice"]
    finally:
        gc.enable()
        http.shutdown()
        server.close()
        pool.close()


@pytest.mark.parametrize("key, want", [
    ("sekrit", [401, 404, 200, 401, 200]),
    # the server key that is also a tenant's name
    ("alice", [200, 200, 200, 401, 200]),
])
def test_access_key_is_the_tenant_and_the_last_key_source(store, key, want):
    env, jax_storage, _ = store
    servers = _servers(env, jax_storage, 10 * TENANT_BYTES, key=key)
    try:
        got = {}
        for pkg, (_, _, base, _, _) in servers.items():
            got[pkg] = [
                _call(base, "/reload?accessKey=alice", {}, method="POST"),
                _call(base, f"/reload?accessKey={key}", {}, method="POST"),
                _call(base, "/reload", {"tenant": "alice"},
                      {"X-PIO-Server-Key": key}, method="POST"),
                _call(base, "/stop?accessKey=bob", None, method="POST"),
                _call(base, "/queries.json?accessKey=alice",
                      {"user": "u1", "num": 3}),
            ]
        assert [s for s, _ in got["torch"]] == want
        assert [s for s, _ in got["jax"]] == want
        for (gs, gb), (ws, wb) in zip(got["torch"], got["jax"]):
            if gs != 200:
                assert _masked(gb) == _masked(wb)
    finally:
        _close(servers)
