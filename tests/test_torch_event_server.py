"""The port's event server over a real socket.

The cases of the JAX package's ``test_event_server.py``, ``test_stats.py``
and ``test_plugins.py`` against the port's server, stats and plugins;
then one seeded script of about 200 requests (creates, batches with bad
items, whitelisted and bad keys, channels, finds with filters, deletes,
webhooks and their probes, ``/stats.json``) sent to the JAX package's
server and to the port's, each over its own fresh storage: status and
body must agree request for request, with ``eventId``, ``pid``,
``requestId`` and creation times masked.
"""

import base64
import datetime as dt
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.data.storage import (
    AccessKey as JaxAccessKey,
    App as JaxApp,
    Channel as JaxChannel,
    Storage as JaxStorage,
)
from predictionio_tpu.serving.event_server import (
    create_event_server as jax_create_event_server,
)
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Channel,
    Storage,
)
from predictionio_tpu_torch.data.storage.base import PartialBatchError
from predictionio_tpu_torch.serving import stats as stats_mod
from predictionio_tpu_torch.serving.event_server import (
    EventServer,
    create_event_server,
)
from predictionio_tpu_torch.serving.http import HTTPServer
from predictionio_tpu_torch.serving.plugins import (
    INPUT_BLOCKER,
    INPUT_SNIFFER,
    OUTPUT_BLOCKER,
    EngineServerPlugin,
    EventServerPlugin,
    PluginContext,
    PluginNotFound,
    PluginRejection,
    load_plugin_spec,
    plugins_from_env,
)
from predictionio_tpu_torch.serving.stats import Stats

MEMORY = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}


def _setup(storage, app_cls, key_cls, channel_cls):
    """App ``srvapp`` with a channel ``ch1``, key ``testkey`` (every
    event) and key ``limitedkey`` (``view`` only)."""
    app_id = storage.get_meta_data_apps().insert(app_cls(id=0, name="srvapp"))
    storage.get_events().init(app_id)
    keys = storage.get_meta_data_access_keys()
    key = keys.insert(key_cls(key="testkey", appid=app_id))
    cid = storage.get_meta_data_channels().insert(
        channel_cls(id=0, name="ch1", appid=app_id))
    storage.get_events().init(app_id, cid)
    limited = keys.insert(
        key_cls(key="limitedkey", appid=app_id, events=("view",)))
    return key, limited


@pytest.fixture()
def memory_store():
    return Storage(env=MEMORY)


@pytest.fixture()
def server(memory_store):
    key, limited = _setup(memory_store, App, AccessKey, Channel)
    http = create_event_server(
        host="127.0.0.1", port=0, storage=memory_store, stats=True
    )
    http.start()
    yield f"http://127.0.0.1:{http.port}", key, limited
    http.shutdown()


def _call(url, method="GET", body=None, headers=None, raw=None):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method)
    if data and raw is None:
        req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _event(name="view", entity="u1", **extra):
    return {
        "event": name,
        "entityType": "user",
        "entityId": entity,
        **extra,
    }


class TestEventAPI:
    def test_alive(self, server):
        base, _, _ = server
        status, body = _call(f"{base}/")
        assert status == 200
        assert body["status"] == "alive"
        assert body["pid"] == os.getpid()  # in-process server

    def test_create_get_delete(self, server):
        base, key, _ = server
        status, body = _call(
            f"{base}/events.json?accessKey={key}", "POST", _event()
        )
        assert status == 201
        eid = body["eventId"]
        status, body = _call(f"{base}/events/{eid}.json?accessKey={key}")
        assert status == 200 and body["event"] == "view"
        status, _ = _call(
            f"{base}/events/{eid}.json?accessKey={key}", "DELETE"
        )
        assert status == 200
        status, _ = _call(f"{base}/events/{eid}.json?accessKey={key}")
        assert status == 404

    def test_auth_required_and_invalid(self, server):
        base, _, _ = server
        assert _call(f"{base}/events.json", "POST", _event())[0] == 401
        assert (
            _call(f"{base}/events.json?accessKey=wrong", "POST", _event())[0]
            == 401
        )

    def test_basic_auth(self, server):
        base, key, _ = server
        good = base64.b64encode(f"{key}:".encode()).decode()
        status, _ = _call(f"{base}/events.json", "POST", _event(),
                          headers={"Authorization": f"Basic {good}"})
        assert status == 201
        status, body = _call(f"{base}/events.json", "POST", _event(),
                             headers={"Authorization": "Basic !!notb64"})
        assert (status, body["message"]) == (401, "Missing accessKey.")

    def test_event_whitelist(self, server):
        base, _, limited = server
        ok = _call(
            f"{base}/events.json?accessKey={limited}", "POST", _event("view")
        )
        assert ok[0] == 201
        denied = _call(
            f"{base}/events.json?accessKey={limited}", "POST", _event("buy")
        )
        assert denied[0] == 403

    def test_invalid_event_rejected(self, server):
        base, key, _ = server
        status, body = _call(
            f"{base}/events.json?accessKey={key}", "POST", _event("$bogus")
        )
        assert status == 400
        assert "reserved" in body["message"]

    def test_find_with_filters(self, server):
        base, key, _ = server
        for i in range(5):
            _call(
                f"{base}/events.json?accessKey={key}",
                "POST",
                _event("view" if i % 2 == 0 else "buy", f"u{i}"),
            )
        status, body = _call(f"{base}/events.json?accessKey={key}&event=buy")
        assert status == 200 and len(body) == 2
        status, body = _call(
            f"{base}/events.json?accessKey={key}&limit=3"
        )
        assert len(body) == 3

    def test_channel_isolation(self, server):
        base, key, _ = server
        _call(
            f"{base}/events.json?accessKey={key}&channel=ch1",
            "POST",
            _event("view", "chan-user"),
        )
        status, body = _call(
            f"{base}/events.json?accessKey={key}&channel=ch1"
        )
        assert [e["entityId"] for e in body] == ["chan-user"]
        status, body = _call(
            f"{base}/events.json?accessKey={key}&channel=nope"
        )
        assert status == 400

    def test_batch(self, server):
        base, key, _ = server
        events = [_event("view", f"b{i}") for i in range(3)]
        events.insert(1, {"event": "$bad", "entityType": "u", "entityId": "x"})
        status, body = _call(
            f"{base}/batch/events.json?accessKey={key}", "POST", events
        )
        assert status == 200
        assert [r["status"] for r in body] == [201, 400, 201, 201]

    def test_batch_partial_storage_failure(self, server, memory_store,
                                           monkeypatch):
        """Mid-batch storage failure: slots keep per-event statuses —
        the durable prefix reports 201, the unsaved suffix 500 — so
        clients can retry only what was lost."""
        base, key, _ = server

        def explode(self, events, app_id, channel_id=None):
            raise PartialBatchError("disk full", ["id-0", "id-1"])

        monkeypatch.setattr(
            type(memory_store.get_events()), "insert_batch", explode
        )
        payload = [_event("view", f"p{i}") for i in range(4)]
        payload.insert(2, {"event": "$bad", "entityType": "u",
                           "entityId": "x"})
        status, body = _call(
            f"{base}/batch/events.json?accessKey={key}", "POST", payload
        )
        assert status == 200
        assert [r["status"] for r in body] == [201, 201, 400, 500, 500]
        assert body[0]["eventId"] == "id-0"
        assert "not saved" in body[3]["message"]

    def test_batch_other_storage_failure_may_not_be_saved(
            self, server, memory_store, monkeypatch):
        """Any other storage error leaves saved-ness unknown: every
        accepted event reports 500 "may not be saved"."""
        base, key, _ = server

        def explode(self, events, app_id, channel_id=None):
            raise OSError("disk gone")

        monkeypatch.setattr(
            type(memory_store.get_events()), "insert_batch", explode
        )
        payload = [_event("view", "q0"), {"event": "$bad",
                                          "entityType": "u",
                                          "entityId": "x"},
                   _event("view", "q1")]
        status, body = _call(
            f"{base}/batch/events.json?accessKey={key}", "POST", payload
        )
        assert status == 200
        assert [r["status"] for r in body] == [500, 400, 500]
        assert body[0]["message"] == "storage error; event may not be saved"

    def test_batch_limit_50(self, server):
        base, key, _ = server
        status, body = _call(
            f"{base}/batch/events.json?accessKey={key}",
            "POST",
            [_event("view", f"b{i}") for i in range(51)],
        )
        assert status == 400
        assert "50" in body["message"]

    def test_stats(self, server):
        base, key, _ = server
        _call(f"{base}/events.json?accessKey={key}", "POST", _event())
        status, body = _call(f"{base}/stats.json?accessKey={key}")
        assert status == 200
        assert body["statusCount"].get("201", 0) >= 1
        assert body["eventCount"].get("view", 0) >= 1

    def test_webhook_segmentio(self, server):
        base, key, _ = server
        payload = {
            "type": "track",
            "userId": "seg-user",
            "event": "Signed Up",
            "properties": {"plan": "pro"},
            "timestamp": "2026-01-01T00:00:00Z",
        }
        status, body = _call(
            f"{base}/webhooks/segmentio.json?accessKey={key}",
            "POST",
            payload,
        )
        assert status == 201
        status, events = _call(
            f"{base}/events.json?accessKey={key}&event=track"
        )
        assert events[0]["entityId"] == "seg-user"
        assert events[0]["properties"]["event"] == "Signed Up"

    def test_webhook_unknown_connector(self, server):
        base, key, _ = server
        status, _ = _call(
            f"{base}/webhooks/nope.json?accessKey={key}", "POST", {}
        )
        assert status == 404

    def test_webhook_get_probe(self, server):
        base, key, _ = server
        status, body = _call(
            f"{base}/webhooks/segmentio.json?accessKey={key}"
        )
        assert (status, body) == (200, {"message": "Ok"})
        status, body = _call(
            f"{base}/webhooks/mailchimp.form?accessKey={key}"
        )
        assert (status, body) == (200, {"message": "Ok"})
        # registered under the other protocol -> 404
        status, _ = _call(
            f"{base}/webhooks/mailchimp.json?accessKey={key}"
        )
        assert status == 404
        status, _ = _call(f"{base}/webhooks/segmentio.json")
        assert status == 401

    def test_method_not_allowed(self, server):
        base, key, _ = server
        status, _ = _call(f"{base}/batch/events.json?accessKey={key}")
        assert status == 405

    def test_bad_json(self, server):
        base, key, _ = server
        status, _ = _call(f"{base}/events.json?accessKey={key}", "POST",
                          raw=b"{not json")
        assert status == 400


class TestReviewRegressions:
    def test_bad_event_time_single_is_400(self, server):
        base, key, _ = server
        status, body = _call(
            f"{base}/events.json?accessKey={key}",
            "POST",
            _event(eventTime="garbage"),
        )
        assert status == 400
        assert "ISO-8601" in body["message"]

    def test_bad_event_time_in_batch_keeps_contract(self, server):
        base, key, _ = server
        events = [
            _event("view", "ok1"),
            _event("view", "bad", eventTime="bad"),
            _event("view", "ok2"),
        ]
        status, body = _call(
            f"{base}/batch/events.json?accessKey={key}", "POST", events
        )
        assert status == 200
        assert [r["status"] for r in body] == [201, 400, 201]

    def test_mailchimp_without_fired_at_defaults_now(self, server):
        base, key, _ = server
        form = urllib.parse.urlencode(
            {
                "type": "cleaned",
                "data[list_id]": "L1",
                "data[email]": "x@y.z",
            }
        ).encode()
        status, _ = _call(f"{base}/webhooks/mailchimp.form?accessKey={key}",
                          "POST", raw=form)
        assert status == 201

    def test_route_dots_are_literal(self, server):
        base, key, _ = server
        status, _ = _call(f"{base}/eventsXjson?accessKey={key}")
        assert status == 404


# -- stats --------------------------------------------------------------------


def _stat_event(name="view", entity_type="user"):
    return Event(event=name, entity_type=entity_type, entity_id="e1")


class TestStats:
    def test_rollover_creates_a_new_bucket(self, monkeypatch):
        t = dt.datetime(2026, 8, 2, 10, 59, tzinfo=dt.timezone.utc)
        monkeypatch.setattr(stats_mod, "_now", lambda: t)
        s = Stats()
        s.update(1, 201, _stat_event())
        t2 = t + dt.timedelta(minutes=2)
        monkeypatch.setattr(stats_mod, "_now", lambda: t2)
        s.update(1, 201, _stat_event())
        assert {bucket for bucket, _aid in s._status} == {
            "2026-08-02T10:00:00Z",
            "2026-08-02T11:00:00Z",
        }
        assert s.snapshot(1)["statusCount"] == {"201": 2}

    def test_bucket_is_utc_even_for_offset_times(self, monkeypatch):
        tz = dt.timezone(dt.timedelta(hours=5, minutes=30))
        t = dt.datetime(2026, 8, 2, 1, 15, tzinfo=tz)  # 19:45Z prev day
        monkeypatch.setattr(stats_mod, "_now", lambda: t)
        s = Stats()
        s.update(1, 201)
        (bucket, _aid), = s._status
        assert bucket == "2026-08-01T19:00:00Z"

    def test_snapshots_do_not_mix_apps(self):
        s = Stats()
        s.update(1, 201, _stat_event("view"))
        s.update(1, 400)
        s.update(2, 201, _stat_event("buy", entity_type="order"))
        snap1, snap2 = s.snapshot(1), s.snapshot(2)
        assert snap1["statusCount"] == {"201": 1, "400": 1}
        assert snap1["eventCount"] == {"view": 1}
        assert snap2["statusCount"] == {"201": 1}
        assert snap2["eventCount"] == {"buy": 1}
        assert snap2["entityTypeCount"] == {"order": 1}

    def test_unknown_app_snapshot_is_empty(self):
        s = Stats()
        s.update(1, 201)
        assert s.snapshot(99)["statusCount"] == {}

    def test_concurrent_updates_lose_nothing(self):
        s = Stats()
        n_threads, per_thread = 8, 500
        barrier = threading.Barrier(n_threads)

        def work(app_id):
            barrier.wait()
            for _ in range(per_thread):
                s.update(app_id, 201, _stat_event())

        threads = [threading.Thread(target=work, args=(i % 2,))
                   for i in range(n_threads)]
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
        assert not any(t.is_alive() for t in threads)
        total = (s.snapshot(0)["statusCount"]["201"]
                 + s.snapshot(1)["statusCount"]["201"])
        assert total == n_threads * per_thread
        assert s.snapshot(0)["eventCount"]["view"] == 2000

    def test_concurrent_update_and_snapshot(self):
        s = Stats()
        stop = threading.Event()
        errors = []

        def reader():
            while not stop.is_set():
                try:
                    assert s.snapshot(1)["statusCount"].get("201", 0) >= 0
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(e)

        t = threading.Thread(target=reader)
        t.start()
        for _ in range(2000):
            s.update(1, 201)
        stop.set()
        t.join(timeout=60)
        assert not t.is_alive()
        assert errors == []
        assert s.snapshot(1)["statusCount"] == {"201": 2000}


# -- plugins ------------------------------------------------------------------


class RejectBuyBlocker(EventServerPlugin):
    plugin_name = "reject-buy"
    plugin_description = "rejects buy events"
    plugin_type = INPUT_BLOCKER

    def process(self, event_json, app_id, channel_id):
        if event_json["event"] == "buy":
            raise PluginRejection("no buying allowed")


class RecordingSniffer(EventServerPlugin):
    plugin_name = "recorder"
    plugin_type = INPUT_SNIFFER

    def __init__(self):
        self.seen = []

    def process(self, event_json, app_id, channel_id):
        self.seen.append((event_json["event"], app_id))

    def handle_rest(self, path, query):
        return {"seen": len(self.seen), "path": path}


class UppercasePlugin(EngineServerPlugin):
    plugin_name = "upper"
    plugin_type = OUTPUT_BLOCKER

    def process(self, engine_info, query, prediction):
        return {**prediction, "label": prediction["label"].upper()}


SAMPLE_PLUGIN = RecordingSniffer()  # module-level for spec loading


@pytest.fixture
def plugin_server(tmp_path):
    storage = Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})  # sqlite
    app_id = storage.get_meta_data_apps().insert(App(id=0, name="pluginapp"))
    storage.get_events().init(app_id)
    key = storage.get_meta_data_access_keys().insert(
        AccessKey(key="pkey", appid=app_id))
    sniffer = RecordingSniffer()
    ctx = PluginContext([RejectBuyBlocker(), sniffer], load_env=False)
    es = EventServer(storage=storage, plugins=ctx)
    http = HTTPServer(es.router, host="127.0.0.1", port=0)
    http.start()
    yield f"http://127.0.0.1:{http.port}", key, sniffer
    http.shutdown()
    ctx.close()


def test_input_blocker_rejects(plugin_server):
    base, key, _ = plugin_server
    status, body = _call(f"{base}/events.json?accessKey={key}", "POST",
                         _event("buy"))
    assert status == 403
    assert "no buying" in body["message"]


def test_input_blocker_passes_other_events(plugin_server):
    base, key, sniffer = plugin_server
    status, body = _call(f"{base}/events.json?accessKey={key}", "POST",
                         _event("view"))
    assert status == 201 and body["eventId"]
    deadline = time.time() + 5
    while not sniffer.seen and time.time() < deadline:
        time.sleep(0.01)
    assert sniffer.seen and sniffer.seen[0][0] == "view"


def test_plugins_json_and_sniffer_rest(plugin_server):
    base, _, _ = plugin_server
    status, body = _call(f"{base}/plugins.json")
    assert status == 200
    assert set(body["plugins"]) == {"reject-buy", "recorder"}
    assert body["plugins"]["reject-buy"]["type"] == INPUT_BLOCKER
    status, body = _call(f"{base}/plugins/inputsniffer/recorder/counts/today")
    assert status == 200
    assert body["path"] == "counts/today"


def test_plugin_rest_unknown_404(plugin_server):
    base, _, _ = plugin_server
    assert _call(f"{base}/plugins/inputsniffer/nope/x")[0] == 404
    assert _call(f"{base}/plugins/outputsniffer/recorder/x")[0] == 404


def test_output_blocker_folds():
    ctx = PluginContext([UppercasePlugin()], load_env=False)
    assert ctx.block_output({}, {"q": 1}, {"label": "cat"}) == {
        "label": "CAT"}
    ctx.close()


def test_output_blocker_order():
    class A(EngineServerPlugin):
        plugin_name = "a"
        plugin_type = OUTPUT_BLOCKER

        def process(self, info, q, p):
            return p + "a"

    class B(A):
        plugin_name = "b"

        def process(self, info, q, p):
            return p + "b"

    ctx = PluginContext([A(), B()], load_env=False)
    assert ctx.block_output({}, {}, "") == "ab"
    ctx.close()


def test_load_plugin_spec_class_and_instance():
    p = load_plugin_spec("tests.test_torch_event_server:RejectBuyBlocker")
    assert (p.plugin_name, p.plugin_type) == ("reject-buy", INPUT_BLOCKER)
    p2 = load_plugin_spec("tests.test_torch_event_server:SAMPLE_PLUGIN")
    assert p2.plugin_name == "recorder"


def test_plugins_from_env(monkeypatch):
    monkeypatch.setenv(
        "PIO_PLUGINS",
        "tests.test_torch_event_server:RejectBuyBlocker, nonexistent.module:x",
    )
    plugins = plugins_from_env()
    assert [p.plugin_name for p in plugins] == ["reject-buy"]


def test_bad_spec_raises():
    with pytest.raises(ValueError):
        load_plugin_spec("no_colon_here")


def test_plugin_internal_keyerror_not_masked():
    class Broken(EventServerPlugin):
        plugin_name = "broken"
        plugin_type = INPUT_SNIFFER

        def handle_rest(self, path, query):
            return query["missing-param"]

    ctx = PluginContext([Broken()], load_env=False)
    try:
        with pytest.raises(KeyError):
            ctx.handle_rest("inputsniffer", "broken", "x", {})
        with pytest.raises(PluginNotFound):
            ctx.handle_rest("inputsniffer", "nope", "x", {})
    finally:
        ctx.close()


# -- parity with the JAX package's server ---------------------------------------

T0 = dt.datetime(2024, 5, 1, tzinfo=dt.timezone.utc)
MASKED = {"eventId", "pid", "requestId", "creationTime", "startTime"}
JSON_CT = {"Content-Type": "application/json"}


def _script(seed=3):
    """About 200 requests, from a seed: (method, path, body bytes,
    headers). ``{id:n}`` in a path is the ``eventId`` request ``n``
    returned on the server being driven."""
    rng = np.random.default_rng(seed)
    reqs = []

    def add(method, path, body=None, headers=None, raw=None):
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None)
        reqs.append((method, path, data,
                     headers or (JSON_CT if raw is None and data else {})))
        return len(reqs) - 1

    def ev(i, name=None):
        name = name or str(rng.choice(["rate", "view", "buy"]))
        d = {"event": name, "entityType": "user",
             "entityId": f"u{rng.integers(0, 6)}",
             "eventTime": (T0 + dt.timedelta(seconds=i)).isoformat()}
        if rng.random() < 0.8:
            d.update(targetEntityType="item",
                     targetEntityId=f"i{rng.integers(0, 5)}")
        if name == "rate":
            d["properties"] = {"rating": int(rng.integers(1, 6))}
        if rng.random() < 0.2:
            d["tags"] = ["t"]
        return d

    k = "accessKey=testkey"
    created = []
    for i in range(80):
        created.append(add("POST", f"/events.json?{k}", ev(i)))
    bad_events = [
        {"event": "$bogus", "entityType": "user", "entityId": "x"},
        {"event": "view", "entityType": "user"},
        {"event": "view", "entityType": "user", "entityId": "x",
         "eventTime": "garbage"},
        {"event": "view", "entityType": "pio_user", "entityId": "x"},
        {"event": "$unset", "entityType": "user", "entityId": "x"},
        {"event": "view", "entityType": "user", "entityId": "x",
         "targetEntityType": "item"},
    ]
    for b in bad_events:
        add("POST", f"/events.json?{k}", b)
    n = 100
    for _ in range(16):
        batch = [ev(n + j) for j in range(int(rng.integers(1, 9)))]
        n += len(batch)
        for b in rng.choice(len(bad_events), int(rng.integers(0, 3))):
            batch.insert(int(rng.integers(0, len(batch) + 1)),
                         bad_events[b])
        add("POST", f"/batch/events.json?{k}", batch)
    add("POST", f"/batch/events.json?{k}", [ev(900 + j) for j in range(51)])
    add("POST", f"/batch/events.json?{k}", {"not": "a list"})
    add("POST", f"/batch/events.json?{k}", [1, "x"])
    add("POST", f"/batch/events.json?accessKey=limitedkey",
        [ev(950, "view"), ev(951, "buy"), ev(952, "view")])
    for name in ("view", "buy", "rate"):
        add("POST", "/events.json?accessKey=limitedkey", ev(960, name))
    basic = base64.b64encode(b"testkey:").decode()
    add("POST", "/events.json", ev(970),
        {**JSON_CT, "Authorization": f"Basic {basic}"})
    add("POST", "/events.json", ev(971))
    add("POST", "/events.json?accessKey=wrong", ev(972))
    add("GET", "/events.json")
    for i in range(4):
        add("POST", f"/events.json?{k}&channel=ch1", ev(980 + i))
    add("POST", f"/events.json?{k}&channel=nope", ev(990))
    add("GET", f"/events.json?{k}&channel=ch1")
    add("GET", f"/events.json?{k}&channel=nope")
    finds = [
        "", "&limit=5", "&limit=7&reversed=true", "&limit=-1",
        "&event=rate&limit=100", "&event=buy", "&entityType=user&entityId=u2",
        "&targetEntityType=none&limit=50", "&targetEntityId=none",
        "&targetEntityType=item&targetEntityId=i3",
        f"&startTime={urllib.parse.quote((T0 + dt.timedelta(seconds=20)).isoformat())}"
        f"&untilTime={urllib.parse.quote((T0 + dt.timedelta(seconds=40)).isoformat())}",
        "&startTime=2024-05-01T00:00:30&limit=50",
        "&untilTime=2024-05-01T00:00:10Z",
        "&limit=abc", "&startTime=notatime", "&reversed=TRUE&limit=3",
        "&entityId=u1&event=view&limit=100",
    ]
    for f in finds:
        add("GET", f"/events.json?{k}{f}")
    for i in rng.choice(created, 12, replace=False):
        add("GET", f"/events/{{id:{i}}}.json?{k}")
    for i in rng.choice(created, 6, replace=False):
        add("DELETE", f"/events/{{id:{i}}}.json?{k}")
        add("GET", f"/events/{{id:{i}}}.json?{k}")
        add("DELETE", f"/events/{{id:{i}}}.json?{k}")
    add("GET", f"/events/missing.json?{k}")
    add("DELETE", f"/events/missing.json?{k}")
    add("GET", f"/events.json?{k}&limit=200")
    seg = {"type": "track", "userId": "seg-user", "event": "Signed Up",
           "properties": {"plan": "pro"}, "context": {"ip": "1.2.3.4"},
           "timestamp": "2026-01-01T00:00:00Z"}
    add("POST", f"/webhooks/segmentio.json?{k}", seg)
    add("POST", f"/webhooks/segmentio.json?{k}",
        {"type": "identify", "anonymousId": "anon", "traits": {"a": 1},
         "sentAt": "2026-01-02T00:00:00Z"})
    add("POST", f"/webhooks/segmentio.json?{k}", {"type": "nope"})
    add("POST", f"/webhooks/segmentio.json?{k}", {"type": "track"})
    add("POST", "/webhooks/segmentio.json?accessKey=limitedkey", seg)
    mail = {"type": "subscribe", "fired_at": "2026-01-03 04:05:06",
            "data[id]": "m1", "data[list_id]": "L1",
            "data[email]": "a@b.c", "data[merges][FNAME]": "Ann"}
    add("POST", f"/webhooks/mailchimp.form?{k}",
        raw=urllib.parse.urlencode(mail).encode())
    add("POST", f"/webhooks/mailchimp.form?{k}",
        raw=urllib.parse.urlencode({"data[id]": "m2"}).encode())
    add("POST", f"/webhooks/mailchimp.form?{k}", raw=urllib.parse.urlencode(
        {"type": "campaign", "fired_at": "2026-01-03 04:05:07",
         "data[id]": "c1", "data[subject]": "s"}).encode())
    add("POST", f"/webhooks/mailchimp.form?{k}", raw=urllib.parse.urlencode(
        {"type": "cleaned", "fired_at": "bad", "data[list_id]": "L1"}
    ).encode())
    add("POST", f"/webhooks/nope.json?{k}", {})
    add("POST", f"/webhooks/nope.form?{k}", raw=b"a=b")
    for probe in ("segmentio.json", "mailchimp.form", "mailchimp.json",
                  "segmentio.form", "nope.json"):
        add("GET", f"/webhooks/{probe}?{k}")
    add("GET", "/webhooks/segmentio.json")
    add("GET", f"/events.json?{k}&entityType=user&limit=200")
    add("GET", f"/stats.json?{k}")
    add("GET", "/stats.json?accessKey=limitedkey")
    add("GET", "/stats.json")
    add("GET", "/")
    add("GET", f"/batch/events.json?{k}")
    add("PUT", f"/events.json?{k}", {})
    add("GET", f"/eventsXjson?{k}")
    add("GET", "/no/such/route")
    add("POST", f"/events.json?{k}", raw=b"{not json",
        headers=JSON_CT)
    add("GET", "/plugins.json")
    add("GET", "/plugins/inputsniffer/none/x")
    return reqs


def _mask(x):
    if isinstance(x, dict):
        return {k: ("<masked>" if k in MASKED else _mask(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_mask(v) for v in x]
    return x


def _drive(base, reqs):
    out = []
    for method, path, data, headers in reqs:
        if "{id:" in path:
            i = int(path.split("{id:")[1].split("}")[0])
            path = path.replace(f"{{id:{i}}}", out[i][1]["eventId"])
        req = urllib.request.Request(base + path, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                out.append((resp.status, json.loads(resp.read() or b"null")))
        except urllib.error.HTTPError as e:
            out.append((e.code, json.loads(e.read() or b"null")))
    return out


@pytest.mark.parametrize("kind", ["sqlite", "eventlog"])
def test_same_answers_as_the_jax_server(tmp_path, monkeypatch, kind):
    monkeypatch.delenv("PIO_PLUGINS", raising=False)

    def env(base):
        return {
            "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(base / "pio.sqlite"),
            "PIO_STORAGE_SOURCES_LOG_TYPE": "eventlog",
            "PIO_STORAGE_SOURCES_LOG_PATH": str(base / "log"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE":
                "SQL" if kind == "sqlite" else "LOG",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
        }

    reqs = _script()
    assert 180 <= len(reqs) <= 260
    answers = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            storage = JaxStorage(env=env(tmp_path / pkg))
            _setup(storage, JaxApp, JaxAccessKey, JaxChannel)
            http = jax_create_event_server(
                host="127.0.0.1", port=0, storage=storage, stats=True,
                admission=False)
        else:
            storage = Storage(env=env(tmp_path / pkg))
            _setup(storage, App, AccessKey, Channel)
            http = create_event_server(host="127.0.0.1", port=0,
                                       storage=storage, stats=True)
        http.start()
        try:
            answers.append(_drive(f"http://127.0.0.1:{http.port}", reqs))
        finally:
            http.shutdown()
    want, got = answers
    statuses = [s for s, _ in want]
    # the script reaches every kind of answer
    assert {200, 201, 400, 401, 403, 404, 405} <= set(statuses)
    for i, (w, g) in enumerate(zip(want, got)):
        assert (g[0], _mask(g[1])) == (w[0], _mask(w[1])), (i, reqs[i][:2])
