"""The rest of one engine server: the port's against the JAX package's,
on the CPU, on one JAX-published generation (random ALS factors, 20
users × 30 items, rank 4, in a sqlite + localfs store both read).

* feedback (JAX ``tests/test_engine_server.py:113``, ``:264``): every
  answer, single or in a batch, carries a 32-hex ``prId`` and leaves a
  ``predict`` event of entity ``pio_pr`` whose id is that ``prId`` and
  whose properties hold the query, the answer and the instance id, in
  both packages; the query cache is turned off under feedback in both;
* the remote error log (``:573``, ``:633``): a failing query's report
  reaches the collector with the JAX package's fields and values, a
  good query sends none, a shed is never reported, a non-http
  ``log_url`` is refused at construction, ``close`` stops the one
  sender thread and a report carries at most 4,096 bytes of the query;
* plugins (JAX ``tests/test_plugins.py``): an output blocker rewrites
  every answer, an output sniffer sees every (query, answer) pair off
  the request thread and serves REST under ``/plugins/outputsniffer``,
  ``/plugins.json`` lists both, alike in both packages;
* the HTML status page (``:157``): ``text/html`` when asked for, with
  the JAX page's headings and rows, JSON otherwise;
* ``POST /debug/profile``: 401 without the server key and 400 for a bad
  ``durationMs`` in both packages; with the key the port returns a
  ``tar.gz`` of the ``torch.profiler`` trace, the spans and the
  manifest, and a second capture while one runs is 409.
"""

from __future__ import annotations

import base64
import dataclasses
import datetime as dt
import http.server
import io
import json
import re
import tarfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.core.persistence import (
    publish_generation as jax_publish,
    serialize_models as jax_serialize,
)
from predictionio_tpu.data.storage import (
    App as JaxApp,
    EngineInstance as JaxInstance,
    Storage as JaxStorage,
)
from predictionio_tpu.models.recommendation import (
    ALSAlgorithm as JaxALS,
    ALSRecModel as JaxModel,
    recommendation_engine as jax_engine,
)
from predictionio_tpu.serving import plugins as jax_plugins
from predictionio_tpu.serving.config import ServerConfig as JaxConfig
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.models.recommendation import recommendation_engine
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving import plugins
from predictionio_tpu_torch.serving.config import ServerConfig
from predictionio_tpu_torch.serving.engine_server import EngineServer

VARIANT = {"algorithms": [{"name": "als", "params": {"rank": 4}}]}
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
    """(env, JAX storage, instance id, feedback app id): one
    JAX-published generation and an app for the feedback events."""
    root = tmp_path_factory.mktemp("extras")
    env = _env(root)
    storage = JaxStorage(env=env)
    app_id = storage.get_meta_data_apps().insert(JaxApp(0, "feedback"))
    storage.get_events().init(app_id)
    rng = np.random.default_rng(5)
    model = JaxModel(
        user_factors=rng.standard_normal((20, 4)).astype(np.float32),
        item_factors=rng.standard_normal((30, 4)).astype(np.float32),
        user_map=JaxBiMap([f"u{i}" for i in range(20)]),
        item_map=JaxBiMap([f"i{i}" for i in range(30)]),
    )
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
    return env, storage, iid, app_id


def _server(pkg, store, **kw):
    env, jax_storage, _, _ = store
    if pkg == "jax":
        engine = jax_engine()
        return JaxServer(engine, engine.params_from_variant(VARIANT), "rec",
                         storage=jax_storage, max_batch=4, warmup=False,
                         admission=False, **kw)
    engine = recommendation_engine()
    return EngineServer(engine, engine.params_from_variant(VARIANT), "rec",
                        storage=kw.pop("storage", None) or Storage(env=env),
                        ctx=ComputeContext.create(device="cpu"),
                        max_batch=4, warmup=False, admission=False, **kw)


@pytest.fixture()
def served(request, store):
    """Factory: both packages' servers, started, with the same options;
    closed at the end. Returns {pkg: (server, base)}."""
    opened = []

    def make(per_pkg=None, **kw):
        out = {}
        for pkg in ("jax", "torch"):
            extra = dict(kw, **((per_pkg or {}).get(pkg, {})))
            server = _server(pkg, store, **extra)
            http = server.serve(host="127.0.0.1", port=0)
            http.start()
            opened.append((server, http))
            out[pkg] = (server, f"http://127.0.0.1:{http.port}")
        return out

    yield make
    for server, http in opened:
        http.shutdown()
        server.close()


def _call(url, body=None, headers=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method or ("GET" if body is None else "POST"),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _json(raw):
    body = json.loads(raw)
    if isinstance(body, dict):
        body.pop("requestId", None)
    return body


def _same_scores(got, want):
    assert [e["item"] for e in got["itemScores"]] == [
        e["item"] for e in want["itemScores"]]
    np.testing.assert_allclose([e["score"] for e in got["itemScores"]],
                               [e["score"] for e in want["itemScores"]],
                               **TOL)


# -- feedback ------------------------------------------------------------------


def _pio_pr_events(pkg, store, app_id):
    env, jax_storage, _, _ = store
    storage = jax_storage if pkg == "jax" else Storage(env=env)
    return [e for e in storage.get_events().find(app_id,
                                                 entity_type="pio_pr")]


def test_feedback_events_and_prid_like_jax(store, served):
    env, _, iid, app_id = store
    servers = served(feedback=True, feedback_app_id=app_id, cache=True)
    before = {pkg: len(_pio_pr_events(pkg, store, app_id))
              for pkg in servers}
    answers = {}
    for pkg, (server, base) in servers.items():
        assert server._cache is None  # off under feedback
        single = _json(_call(base + "/queries.json",
                             {"user": "u3", "num": 4})[2])
        batch = _json(_call(base + "/batch/queries.json",
                            [{"user": "u1", "num": 2},
                             {"user": "u9", "num": 3}])[2])
        answers[pkg] = [single] + [r["prediction"] for r in batch]
    got, want = answers["torch"], answers["jax"]
    for g, w in zip(got, want):
        assert re.fullmatch(r"[0-9a-f]{32}", g["prId"]), g
        _same_scores(g, w)
    # both packages write into one event table: each server's three
    # events are told apart by the prIds it returned
    events = _pio_pr_events("torch", store, app_id)
    assert len(events) == before["torch"] + 6
    by_id = {e.entity_id: e for e in events}
    for pkg, answered in answers.items():
        for answer, query in zip(answered, [{"user": "u3", "num": 4},
                                            {"user": "u1", "num": 2},
                                            {"user": "u9", "num": 3}]):
            event = by_id[answer["prId"]]
            assert event.event == "predict"
            props = dict(event.properties)
            assert props["query"] == query
            assert props["engineInstanceId"] == iid
            stored = props["prediction"]
            assert "prId" not in stored
            _same_scores(stored, answer)


# -- the remote error log ---------------------------------------------------


class _Sink:
    """A collector that records every POSTed report."""

    def __init__(self):
        self.received = []
        self.got = threading.Event()
        sink = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                sink.received.append((self.path, self.rfile.read(length)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()
                sink.got.set()

            def log_message(self, *a):
                pass

        self.server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_port}/collect"

    def wait(self, n, timeout=10.0):
        deadline = time.monotonic() + timeout
        while len(self.received) < n and time.monotonic() < deadline:
            time.sleep(0.02)
        return len(self.received) >= n


def test_remote_error_log_like_jax(served):
    sinks = {"jax": _Sink(), "torch": _Sink()}
    servers = served(per_pkg={pkg: {"log_url": sink.url}
                              for pkg, sink in sinks.items()},
                     log_prefix="pio-")
    try:
        statuses = {}
        for pkg, (_, base) in servers.items():
            statuses[pkg] = [
                _call(base + "/queries.json", [1, 2])[0],
                _call(base + "/queries.json", {"user": "u1"})[0],
            ] + [r["status"] for r in _json(_call(
                base + "/batch/queries.json",
                [{"user": "u1"}, {"user": "u2", "num": "many"}])[2])]
            assert sinks[pkg].wait(2), pkg
        # one batch launch holds both slots, so the bad num fails both
        assert statuses["torch"] == statuses["jax"] == [400, 200, 500, 500]
        time.sleep(0.3)
        reports = {}
        for pkg, sink in sinks.items():
            reports[pkg] = [(path, json.loads(raw))
                            for path, raw in sink.received]
        assert len(reports["torch"]) == len(reports["jax"]) == 2
        for (gp, g), (wp, w) in zip(reports["torch"], reports["jax"]):
            assert gp == wp == "/collect"
            assert g == w
        first = reports["torch"][0][1]
        assert first["message"].startswith("pio-")
        assert json.loads(first["query"]) == [1, 2]
        assert first["engineInstance"] == {
            "engineId": "rec", "engineVersion": "1",
            "engineVariant": "default"}
    finally:
        for sink in sinks.values():
            sink.server.shutdown()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_bad_log_url_refused_at_construction(store, pkg):
    with pytest.raises(ValueError, match="log-url"):
        _server(pkg, store, log_url="collector.internal/log")


def test_close_stops_the_sender_and_bounds_the_report(store):
    before = set(threading.enumerate())
    server = _server("torch", store, log_url="http://127.0.0.1:9/collect")
    sender = [t for t in set(threading.enumerate()) - before
              if t.name == "remote-error-log"]
    assert len(sender) == 1
    server.close()
    sender[0].join(timeout=5)
    assert not sender[0].is_alive()

    class _Big:
        body = b"[" + b"1," * 100_000 + b"1]"

    server._post_remote_log(ValueError("boom"), _Big())
    payload = server._log_queue.get_nowait()
    assert len(payload) < 8192
    assert b'"queryTruncated": true' in payload


# -- plugins -----------------------------------------------------------------


def _plugin_classes(mod):
    class Stamp(mod.EngineServerPlugin):
        plugin_name = "stamp"
        plugin_description = "adds the engine id"
        plugin_type = mod.OUTPUT_BLOCKER

        def process(self, engine_info, query, prediction):
            return {**prediction, "servedBy": engine_info["engineId"],
                    "n": len(prediction["itemScores"])}

    class Recorder(mod.EngineServerPlugin):
        plugin_name = "recorder"
        plugin_description = "records what was served"
        plugin_type = mod.OUTPUT_SNIFFER

        def __init__(self):
            self.seen = []
            self.got = threading.Event()

        def process(self, engine_info, query, prediction):
            self.seen.append((query["user"], prediction["n"]))
            self.got.set()

        def handle_rest(self, path, query):
            return {"seen": len(self.seen), "path": path}

    return Stamp(), Recorder()


def test_output_plugins_like_jax(served):
    made = {"jax": _plugin_classes(jax_plugins),
            "torch": _plugin_classes(plugins)}
    contexts = {
        "jax": jax_plugins.PluginContext(list(made["jax"]), load_env=False),
        "torch": plugins.PluginContext(list(made["torch"]), load_env=False),
    }
    servers = served(per_pkg={pkg: {"plugins": ctx}
                              for pkg, ctx in contexts.items()})
    got = {}
    for pkg, (_, base) in servers.items():
        single = _json(_call(base + "/queries.json",
                             {"user": "u4", "num": 3})[2])
        batch = _json(_call(base + "/batch/queries.json",
                            [{"user": "u5", "num": 2}])[2])
        recorder = made[pkg][1]
        deadline = time.monotonic() + 5
        while len(recorder.seen) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        rest = _json(_call(base + "/plugins/outputsniffer/recorder/a/b")[2])
        listing = _json(_call(base + "/plugins.json")[2])
        missing = _call(base + "/plugins/outputsniffer/nope/x")[0]
        wrong_type = _call(base + "/plugins/inputsniffer/recorder/x")[0]
        got[pkg] = (single, batch, sorted(recorder.seen), rest, listing,
                    missing, wrong_type)
    (gs, gb, *g_rest), (ws, wb, *w_rest) = got["torch"], got["jax"]
    _same_scores(gs, ws)
    assert gs["servedBy"] == ws["servedBy"] == "rec" and gs["n"] == 3
    _same_scores(gb[0]["prediction"], wb[0]["prediction"])
    assert gb[0]["prediction"]["n"] == wb[0]["prediction"]["n"] == 2
    assert g_rest == w_rest
    assert g_rest[0] == [("u4", 3), ("u5", 2)]
    assert g_rest[1] == {"seen": 2, "path": "a/b"}


# -- the HTML status page -----------------------------------------------------


def _page(base):
    status, headers, raw = _call(base + "/", headers={"Accept": "text/html"})
    return status, headers["Content-Type"], raw.decode()


def test_html_status_page_like_jax(served):
    servers = served()
    pages = {pkg: _page(base) for pkg, (_, base) in servers.items()}
    (gs, gt, gp), (ws, wt, wp) = pages["torch"], pages["jax"]
    assert gs == ws == 200 and gt == wt == "text/html"

    def skeleton(page):
        # headings, row names and the tenant row; values of times, ids,
        # counts and the params' reprs are each package's own
        return (re.findall(r"<h[12]>([^<]*)</h[12]>", page),
                re.findall(r"<th>([^<]*)</th>", page),
                re.findall(r"<title>([^<]*)</title>", page))

    assert skeleton(gp) == skeleton(wp)
    assert "<h1>Engine Server</h1>" in gp and "Request Count" in gp
    for pkg, (_, base) in servers.items():
        status, headers, raw = _call(base + "/")
        assert status == 200 and json.loads(raw)["status"] == "alive"


# -- /debug/profile -----------------------------------------------------------


_PROFILE_CASES = [
    ({}, None, 401),
    ({"X-PIO-Server-Key": "wrong"}, {"durationMs": 50}, 401),
    ({"X-PIO-Server-Key": "k"}, {"durationMs": "soon"}, 400),
    ({"X-PIO-Server-Key": "k"}, [1], 400),
]


def test_debug_profile_refusals_like_jax(served):
    servers = served(per_pkg={
        "jax": {"server_config": JaxConfig(True, "k")},
        "torch": {"server_config": ServerConfig(True, "k")}})
    for headers, body, status in _PROFILE_CASES:
        got = {pkg: _call(base + "/debug/profile", body, headers, "POST")
               for pkg, (_, base) in servers.items()}
        assert got["torch"][0] == got["jax"][0] == status
        assert _json(got["torch"][2]) == _json(got["jax"][2])


def test_debug_profile_captures_and_refuses_overlap(store, served):
    servers = served(per_pkg={"torch": {"server_config":
                                        ServerConfig(True, "k")},
                              "jax": {}})
    _, base = servers["torch"]
    headers = {"X-PIO-Server-Key": "k"}
    result = {}

    def capture():
        result["long"] = _call(base + "/debug/profile", {"durationMs": 1500},
                               headers, "POST")

    worker = threading.Thread(target=capture)
    worker.start()
    time.sleep(0.4)
    overlap = _call(base + "/debug/profile", {"durationMs": 50}, headers,
                    "POST")
    for _ in range(10):
        assert _call(base + "/queries.json", {"user": "u2"})[0] == 200
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert overlap[0] == 409
    assert "already running" in _json(overlap[2])["message"]
    status, _, raw = result["long"]
    assert status == 200
    body = json.loads(raw)
    assert body["profile"]["durationS"] >= 1.5
    with tarfile.open(fileobj=io.BytesIO(
            base64.b64decode(body["bundle"])), mode="r:gz") as tar:
        names = tar.getnames()
    assert any(n.endswith("manifest.json") for n in names)
    assert any(n.endswith("spans.json") for n in names)
    assert any("torch_trace/" in n and n.endswith(".trace.json")
               for n in names)
    again = _call(base + "/debug/profile", {"durationMs": 10}, headers,
                  "POST")
    assert again[0] == 200
    # the duration is held to at least 50 ms
    assert json.loads(again[2])["profile"]["durationS"] >= 0.05
