"""The port's stores against the JAX package's, on the same seeded events.

Each package writes its own sqlite file and its own event-log directory
from the same operations; every answer must agree, and each package
must read what the other wrote. Event times compare to the microsecond
(the log keeps float64 seconds); every other field compares exactly.
The two packages' native ``interactions`` scans of one log give the same
arrays and the same maps.
"""

import dataclasses
import datetime as dt
import sys
import threading

import numpy as np
import pytest

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import (
    AccessKey as JaxAccessKey,
    App as JaxApp,
    Channel as JaxChannel,
    EngineInstance as JaxEngineInstance,
    EngineManifest as JaxEngineManifest,
    EvaluationInstance as JaxEvaluationInstance,
    Storage as JaxStorage,
)
from predictionio_tpu.data.storage.eventlog import (
    EventLogEvents as JaxEventLogEvents,
)
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    Storage,
    StorageError,
)
from predictionio_tpu_torch.data.storage import eventlog
from predictionio_tpu_torch.data.storage.base import PartialBatchError
from predictionio_tpu_torch.data.store import EventStore

PORT = dict(Event=Event, App=App, AccessKey=AccessKey, Channel=Channel,
            EngineInstance=EngineInstance, EngineManifest=EngineManifest,
            EvaluationInstance=EvaluationInstance, Storage=Storage)
JAX = dict(Event=JaxEvent, App=JaxApp, AccessKey=JaxAccessKey,
           Channel=JaxChannel, EngineInstance=JaxEngineInstance,
           EngineManifest=JaxEngineManifest,
           EvaluationInstance=JaxEvaluationInstance, Storage=JaxStorage)
T0 = dt.datetime(2024, 3, 1, 12, 0, 0, tzinfo=dt.timezone.utc)
N_EVENTS = 120


def _env(kind, base):
    """METADATA (and models) on memory or sqlite; EVENTDATA on sqlite,
    the event log or memory."""
    env = {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(base / "pio.sqlite"),
        "PIO_STORAGE_SOURCES_LOG_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_LOG_PATH": str(base / "eventlog"),
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE":
            "MEM" if kind == "memory" else "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE":
            {"sqlite": "SQL", "eventlog": "LOG", "memory": "MEM"}[kind],
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
    }
    return env


def _event_rows(n=N_EVENTS, seed=7):
    """Seeded event fields: rates, views, buys and ``$set`` events,
    distinct times with microseconds, tags and prIds on some."""
    rng = np.random.default_rng(seed)
    names = np.array(["rate", "view", "buy", "$set"])
    kinds = rng.choice(4, n, p=[0.5, 0.25, 0.15, 0.1])
    users = rng.integers(0, 12, n)
    items = rng.integers(0, 9, n)
    ratings = rng.integers(1, 6, n)
    offsets = np.sort(rng.choice(10**9, n, replace=False))
    rows = []
    for i in range(n):
        name = str(names[kinds[i]])
        row = dict(
            event=name,
            entity_type="user",
            entity_id=f"u{users[i]}",
            event_time=T0 + dt.timedelta(microseconds=int(offsets[i])),
            creation_time=T0 + dt.timedelta(seconds=i),
            event_id=f"ev{i:04d}",
        )
        if name == "$set":
            row["properties"] = {"age": int(users[i]) + 20}
        else:
            row.update(target_entity_type="item",
                       target_entity_id=f"i{items[i]}")
            if name == "rate":
                row["properties"] = {"rating": int(ratings[i])}
        if i % 7 == 0:
            row["tags"] = ("a", f"t{i % 3}")
        if i % 11 == 0:
            row["pr_id"] = f"pr{i}"
        rows.append(row)
    return rows


def _fill(pkg, kind, base, rows=None):
    """A storage of one package with one app, a channel and the events
    (half by ``insert_batch``, half by ``insert``, the channel's by
    ``insert``)."""
    storage = pkg["Storage"](env=_env(kind, base))
    app_id = storage.get_meta_data_apps().insert(pkg["App"](0, "shop"))
    cid = storage.get_meta_data_channels().insert(
        pkg["Channel"](0, "side", app_id))
    events = storage.get_events()
    events.init(app_id)
    events.init(app_id, cid)
    made = [pkg["Event"](**r) for r in (rows or _event_rows())]
    half = len(made) // 2
    events.insert_batch(made[:half], app_id)
    for e in made[half:]:
        events.insert(e, app_id)
    events.insert(pkg["Event"](event="view", entity_type="user",
                               entity_id="side-user", event_id="side0",
                               event_time=T0), app_id, cid)
    return storage, app_id, cid


def _plain(events):
    """(fields, (event time, creation time)) per event."""
    out = []
    for e in events:
        d = e.to_json_dict()
        times = tuple(
            dt.datetime.fromisoformat(d.pop(k)).timestamp()
            for k in ("eventTime", "creationTime")
        )
        out.append((d, times))
    return out


def _assert_same_events(got, want):
    got, want = _plain(got), _plain(want)
    assert [d for d, _ in got] == [d for d, _ in want]
    for (_, gt), (_, wt) in zip(got, want):
        np.testing.assert_allclose(gt, wt, rtol=0, atol=1e-6)


FILTERS = {
    "all": {},
    "time_range": dict(start_time=T0 + dt.timedelta(seconds=200),
                       until_time=T0 + dt.timedelta(seconds=700)),
    "naive_time_is_utc": dict(start_time=dt.datetime(2024, 3, 1, 12, 5)),
    "entity": dict(entity_type="user", entity_id="u3"),
    "unknown_entity": dict(entity_type="user", entity_id="nobody"),
    "event_names": dict(event_names=["rate", "buy"]),
    "target_absent": dict(target_entity_type=None),
    "target_id_absent": dict(target_entity_id=None),
    "target_type": dict(target_entity_type="item"),
    "target_id": dict(target_entity_id="i2"),
    "limit": dict(limit=5),
    "limit_reversed": dict(limit=7, reversed=True),
    "reversed": dict(reversed=True),
    "limit_zero": dict(limit=0),
    "mixed": dict(entity_id="u1", event_names=["rate"],
                  until_time=T0 + dt.timedelta(seconds=900)),
}


@pytest.fixture(scope="module", params=["sqlite", "eventlog"])
def filled(request, tmp_path_factory):
    kind = request.param
    jbase = tmp_path_factory.mktemp(f"jax-{kind}")
    pbase = tmp_path_factory.mktemp(f"port-{kind}")
    jax = _fill(JAX, kind, jbase)
    port = _fill(PORT, kind, pbase)
    # each package over the other's files
    port_on_jax = Storage(env=_env(kind, jbase))
    jax_on_port = JaxStorage(env=_env(kind, pbase))
    return kind, jax, port, port_on_jax, jax_on_port


@pytest.mark.parametrize("case", list(FILTERS))
def test_find_matches_and_reads_the_other_package(filled, case):
    _, (jax, app_id, _), (port, papp, _), port_on_jax, jax_on_port = filled
    kw = FILTERS[case]
    want = list(jax.get_events().find(app_id, **kw))
    if case not in ("unknown_entity", "limit_zero"):
        assert want, case
    _assert_same_events(list(port.get_events().find(papp, **kw)), want)
    _assert_same_events(list(port_on_jax.get_events().find(app_id, **kw)),
                        want)
    _assert_same_events(list(jax_on_port.get_events().find(papp, **kw)),
                        want)


def test_get_channel_and_metadata_across_packages(filled):
    kind, (jax, app_id, cid), (port, papp, pcid), port_on_jax, _ = filled
    for eid in ("ev0000", "ev0007", "ev0077"):
        _assert_same_events([port.get_events().get(eid, papp)],
                            [jax.get_events().get(eid, app_id)])
        _assert_same_events([port_on_jax.get_events().get(eid, app_id)],
                            [jax.get_events().get(eid, app_id)])
    assert port.get_events().get("missing", papp) is None
    assert port.get_events().get("ev0000", papp, pcid) is None
    side = list(port_on_jax.get_events().find(app_id, cid))
    _assert_same_events(side, list(jax.get_events().find(app_id, cid)))
    assert [e.entity_id for e in side] == ["side-user"]
    # sqlite metadata written by the JAX package reads in the port
    assert port_on_jax.get_meta_data_apps().get_by_name("shop").id == app_id
    assert [c.name for c in port_on_jax.get_meta_data_channels()
            .get_by_app_id(app_id)] == ["side"]


@pytest.mark.parametrize("kind", ["sqlite", "eventlog", "memory"])
def test_delete_then_get_and_find(tmp_path, kind):
    results = []
    for pkg, base in ((JAX, tmp_path / "jax"), (PORT, tmp_path / "port")):
        storage, app_id, _ = _fill(pkg, kind, base, _event_rows(30, seed=3))
        events = storage.get_events()
        deleted = [events.delete(eid, app_id)
                   for eid in ("ev0003", "ev0004", "nope", "ev0003")]
        results.append((deleted, events.get("ev0003", app_id),
                        list(events.find(app_id))))
    (jd, jget, jall), (pd, pget, pall) = results
    assert pd == jd == [True, True, False, False]
    assert pget is None and jget is None
    assert len(pall) == 28
    _assert_same_events(pall, jall)
    if kind != "memory":
        # the JAX package sees the port's deletes (tombstones, rows)
        jax_view = JaxStorage(env=_env(kind, tmp_path / "port"))
        _assert_same_events(list(jax_view.get_events().find(1)), jall)


def _metadata_ops(pkg, storage):
    """One script over every metadata DAO; returns what each call gave,
    records as plain dicts."""
    out = []

    def rec(x):
        if isinstance(x, list):
            return [rec(v) for v in x]
        return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x

    apps = storage.get_meta_data_apps()
    out += [apps.insert(pkg["App"](0, "a1", "first")),
            apps.insert(pkg["App"](0, "a2")),
            apps.insert(pkg["App"](0, "a1")),  # duplicate name
            apps.insert(pkg["App"](7, "a7"))]
    out += [rec(apps.get(1)), rec(apps.get_by_name("a7")),
            apps.update(pkg["App"](2, "a2", "second")),
            apps.update(pkg["App"](99, "zz")), apps.delete(7),
            apps.delete(7), rec(apps.get_all())]
    keys = storage.get_meta_data_access_keys()
    out += [keys.insert(pkg["AccessKey"]("k1", 1)),
            keys.insert(pkg["AccessKey"]("k2", 1, ("view", "buy"))),
            keys.insert(pkg["AccessKey"]("k1", 2))]
    generated = keys.insert(pkg["AccessKey"]("", 2, ("rate",)))
    out += [len(generated), rec(keys.get("k2")), keys.get("none"),
            sorted(k.key for k in keys.get_by_app_id(1)),
            keys.update(pkg["AccessKey"]("k1", 1, ("x",))),
            keys.update(pkg["AccessKey"]("zz", 1)),
            rec(keys.get("k1")), keys.delete("k1"), keys.delete("k1"),
            sorted(k.appid for k in keys.get_all())]
    channels = storage.get_meta_data_channels()
    out += [channels.insert(pkg["Channel"](0, "c1", 1)),
            channels.insert(pkg["Channel"](0, "c1", 1)),
            channels.insert(pkg["Channel"](0, "bad name!", 1)),
            channels.insert(pkg["Channel"](0, "c1", 2)),
            rec(channels.get(2)), rec(channels.get_by_app_id(1)),
            channels.delete(1), channels.get(1)]
    t1 = T0 + dt.timedelta(hours=1)
    ei = storage.get_meta_data_engine_instances()
    first = pkg["EngineInstance"](
        id="i1", status="COMPLETED", start_time=T0, end_time=t1,
        engine_id="e", engine_version="1", engine_variant="v",
        engine_factory="f", env={"a": "b"}, mesh_conf={"d": "1"})
    out += [ei.insert(first),
            ei.insert(dataclasses.replace(first, id="i2", start_time=t1)),
            ei.insert(dataclasses.replace(first, id="i3", status="INIT")),
            rec(ei.get("i1")),
            [i.id for i in ei.get_completed("e", "1", "v")],
            rec(ei.get_latest_completed("e", "1", "v")),
            ei.get_latest_completed("e", "1", "other"),
            ei.update(dataclasses.replace(first, status="FAILED")),
            ei.update(dataclasses.replace(first, id="zz")),
            sorted(i.id for i in ei.get_all()), ei.delete("i3"),
            ei.delete("i3"), len(ei.insert(dataclasses.replace(first, id="")))]
    em = storage.get_meta_data_engine_manifests()
    m = pkg["EngineManifest"](id="m", version="1", name="rec",
                              files=("a.py", "b.py"), engine_factory="f")
    em.insert(m)
    em.insert(dataclasses.replace(m, version="2", description="d"))
    em.update(dataclasses.replace(m, name="renamed"))
    em.update(dataclasses.replace(m, id="new"), upsert=True)
    with pytest.raises(KeyError):
        em.update(dataclasses.replace(m, id="absent"))
    out += [rec(em.get("m", "1")), em.get("m", "9"),
            sorted((x.id, x.version) for x in em.get_all()),
            em.delete("m", "2"), em.delete("m", "2")]
    evi = storage.get_meta_data_evaluation_instances()
    ev = pkg["EvaluationInstance"](
        id="x1", status="EVALCOMPLETED", start_time=T0, end_time=t1,
        evaluation_class="E", env={"k": "v"}, evaluator_results="0.5")
    out += [evi.insert(ev),
            evi.insert(dataclasses.replace(ev, id="x2", start_time=t1)),
            evi.insert(dataclasses.replace(ev, id="x3", status="INIT")),
            rec(evi.get("x1")), [i.id for i in evi.get_completed()],
            evi.update(dataclasses.replace(ev, status="EVALUATING")),
            evi.update(dataclasses.replace(ev, id="zz")),
            sorted(i.id for i in evi.get_all()), evi.delete("x2"),
            evi.delete("x2")]
    return out


def _metadata_dump(storage):
    """Everything the metadata DAOs hold, as plain sorted dicts, without
    the generated access key and the auto-assigned instance id (they
    differ between two runs of one script)."""
    def rows(xs):
        out = [dataclasses.asdict(x) for x in xs]
        for r in out:
            if "key" in r:
                r["key"] = r["key"] if r["key"] in ("k1", "k2") else "gen"
            if r.get("id") not in (None, "i1", "i2", "i3") and "engine_id" in r:
                r["id"] = "auto"
        return sorted(out, key=repr)

    return [
        rows(storage.get_meta_data_apps().get_all()),
        rows(storage.get_meta_data_access_keys().get_all()),
        rows(storage.get_meta_data_channels().get_by_app_id(1)),
        rows(storage.get_meta_data_channels().get_by_app_id(2)),
        rows(storage.get_meta_data_engine_instances().get_all()),
        rows(storage.get_meta_data_engine_manifests().get_all()),
        rows(storage.get_meta_data_evaluation_instances().get_all()),
    ]


@pytest.mark.parametrize("kind", ["sqlite", "memory"])
def test_metadata_daos_match(tmp_path, kind):
    jax = JaxStorage(env=_env(kind, tmp_path / "jax"))
    port = Storage(env=_env(kind, tmp_path / "port"))
    want = _metadata_ops(JAX, jax)
    assert _metadata_ops(PORT, port) == want
    if kind == "sqlite":
        # each package reads the other's file the same way
        dump = _metadata_dump
        mine = Storage(env=_env(kind, tmp_path / "port"))
        theirs = Storage(env=_env(kind, tmp_path / "jax"))
        assert dump(theirs) == dump(mine) == dump(jax) == dump(
            JaxStorage(env=_env(kind, tmp_path / "port")))


def test_sqlite_schema_is_the_jax_packages(tmp_path):
    """Table names, columns and the stored time text are byte for byte
    the same."""
    import sqlite3

    dumps = []
    for pkg, name in ((JAX, "jax"), (PORT, "port")):
        _fill(pkg, "sqlite", tmp_path / name, _event_rows(10))
        con = sqlite3.connect(tmp_path / name / "pio.sqlite")
        schema = con.execute(
            "SELECT type, name, sql FROM sqlite_master ORDER BY name"
        ).fetchall()
        events = con.execute(
            "SELECT * FROM events_1 ORDER BY id").fetchall()
        con.close()
        dumps.append((schema, events))
    assert dumps[0] == dumps[1]


@pytest.mark.parametrize("value_key", [None, "rating"])
@pytest.mark.parametrize("event_names", [None, ("rate",)])
def test_native_interactions_identical_in_both_packages(
        tmp_path, value_key, event_names):
    """One log, written in turns by both packages (so each must pick up
    the strings the other interned), scanned by each; the JAX package
    writes last, after the port's log is open."""
    rows = _event_rows(200, seed=5)
    jax_log = JaxEventLogEvents({"PATH": str(tmp_path)})
    port_log = eventlog.EventLogEvents({"PATH": str(tmp_path)})
    for lo in range(0, len(rows), 25):
        chunk = rows[lo:lo + 25]
        if (lo // 25) % 2:
            port_log.insert_batch([Event(**r) for r in chunk], 1)
        else:
            jax_log.insert_batch([JaxEvent(**r) for r in chunk], 1)
    late = dict(event="rate", entity_type="user", entity_id="late-user",
                target_entity_type="item", target_entity_id="late-item",
                properties={"rating": 4}, event_time=T0, event_id="late")
    jax_log.insert(JaxEvent(**late), 1)  # strings the port has not seen
    rows.append(late)
    kw = dict(event_names=event_names, value_key=value_key,
              default_value=2.5)
    want = jax_log.interactions(1, **kw)
    got = port_log.interactions(1, **kw)
    for field in ("rows", "cols", "values", "times"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert list(got.entity_map.keys()) == list(want.entity_map.keys())
    assert list(got.target_map.keys()) == list(want.target_map.keys())
    n_target = sum(1 for r in rows if "target_entity_id" in r
                   and (event_names is None or r["event"] in event_names))
    assert got.nnz == n_target
    _assert_same_events(list(port_log.find(1)), list(jax_log.find(1)))


def _triples(inter):
    return sorted(zip(inter.entity_map.decode(inter.rows).tolist(),
                      inter.target_map.decode(inter.cols).tolist(),
                      inter.values.tolist()))


def test_event_store_reaches_the_native_scan(tmp_path, monkeypatch):
    """``EventStore.interactions`` dispatches to the log's scan; the
    sqlite and memory backends take the frame path; all three give the
    same (user, item, value) triples."""
    calls = []
    real = eventlog.EventLogEvents.interactions

    def counted(self, *args, **kwargs):
        calls.append(args)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(eventlog.EventLogEvents, "interactions", counted)
    got = {}
    for kind in ("eventlog", "sqlite", "memory"):
        storage, _, _ = _fill(PORT, kind, tmp_path / kind)
        got[kind] = _triples(EventStore(storage).interactions(
            "shop", event_names=["rate"], value_key="rating"))
    assert len(calls) == 1
    assert got["eventlog"] == got["sqlite"] == got["memory"]
    assert len(got["eventlog"]) == sum(
        r["event"] == "rate" for r in _event_rows())


@pytest.mark.parametrize("k", [0, 3, 9])
def test_partial_batch_error_reports_the_durable_prefix(
        tmp_path, monkeypatch, k):
    real = eventlog.EventLogEvents._append_one
    calls = []

    def fail_at_k(log, stamped, blob):
        calls.append(stamped.event_id)
        if len(calls) == k + 1:
            return -1
        return real(log, stamped, blob)

    backend = eventlog.EventLogEvents({"PATH": str(tmp_path)})
    monkeypatch.setattr(eventlog.EventLogEvents, "_append_one",
                        staticmethod(fail_at_k))
    events = [Event(**r) for r in _event_rows(12)]
    with pytest.raises(PartialBatchError) as err:
        backend.insert_batch(events, 1)
    assert err.value.inserted_ids == [e.event_id for e in events[:k]]
    monkeypatch.undo()
    stored = [e.event_id for e in backend.find(1)]
    assert stored == err.value.inserted_ids
    # the JAX package's view of the same log agrees
    assert [e.event_id for e in JaxEventLogEvents(
        {"PATH": str(tmp_path)}).find(1)] == stored


class _CountingLib:
    def __init__(self, lib, sync_rc=0):
        self._lib = lib
        self.syncs = 0
        self.sync_rc = sync_rc

    def pio_log_sync(self, handle):
        self.syncs += 1
        return self.sync_rc

    def __getattr__(self, name):
        return getattr(self._lib, name)


@pytest.mark.parametrize("flag", ["1", ""])
def test_eventlog_fsync_commits_once_per_write(tmp_path, monkeypatch, flag):
    monkeypatch.setenv("PIO_EVENTLOG_FSYNC", flag)
    backend = eventlog.EventLogEvents({"PATH": str(tmp_path)})
    backend.init(1)
    log = backend._log(1, None)
    assert log.fsync_on_commit is bool(flag)
    lib = _CountingLib(log.lib)
    monkeypatch.setattr(log, "lib", lib)
    rows = _event_rows(5)
    backend.insert(Event(**rows[0]), 1)
    backend.insert_batch([Event(**r) for r in rows[1:]], 1)
    assert lib.syncs == (2 if flag else 0)
    assert len(list(backend.find(1))) == 5
    if flag:
        lib.sync_rc = -1
        with pytest.raises(OSError, match="fsync failed"):
            backend.insert(Event(**_event_rows(6)[5]), 1)


def test_sqlite_ingest_from_many_threads(tmp_path):
    """One connection per thread: 8 writer threads and a reader share
    one client without errors or lost events."""
    storage = Storage(env=_env("sqlite", tmp_path))
    events = storage.get_events()
    events.init(1)
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def writer(w):
        try:
            for b in range(10):
                events.insert_batch([
                    Event(event="rate", entity_type="user",
                          entity_id=f"w{w}", target_entity_type="item",
                          target_entity_id=f"i{b}-{j}")
                    for j in range(20)
                ], 1)
                list(events.find(1, entity_id=f"w{w}", limit=3))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
    try:
        [t.start() for t in threads]
        [t.join(timeout=120) for t in threads]
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(list(events.find(1))) == 8 * 10 * 20


@pytest.mark.parametrize("env", ["empty", "basedir"])
def test_default_wiring_matches_jax(tmp_path, env):
    """From the same env with no source declared, both packages wire
    sqlite (metadata, events) and localfs (models) at the same paths.
    Nothing is opened until a DAO is asked for."""
    e = {} if env == "empty" else {"PIO_FS_BASEDIR": str(tmp_path)}
    jax, port = JaxStorage(env=e), Storage(env=e)
    assert port._repo_source == jax._repo_source == {
        "METADATA": "SQLITE", "EVENTDATA": "SQLITE", "MODELDATA": "LOCALFS"}
    assert {n: c for n, (_t, c) in port._specs.items()} == {
        n: c for n, (_s, c) in jax._specs.items()}
    assert port._specs["SQLITE"][0] == "sqlite"
    assert port._specs["LOCALFS"][0] == "localfs"
    if env == "basedir":
        app_id = port.get_meta_data_apps().insert(App(0, "shop"))
        port.get_events().insert(Event(**_event_rows(1)[0]), app_id)
        assert jax.get_meta_data_apps().get_by_name("shop").id == app_id
        assert [e.event_id for e in jax.get_events().find(app_id)] == [
            "ev0000"]
        assert (tmp_path / "pio.sqlite").exists()


@pytest.fixture()
def networked_env(request, tmp_path):
    """``PIO_STORAGE_*`` naming one networked store for every repository,
    its server (the port's minipg, minimysql or store server) running."""
    from predictionio_tpu_torch.data.storage.minimysql import MiniMySQLServer
    from predictionio_tpu_torch.data.storage.minipg import MiniPGServer
    from predictionio_tpu_torch.serving.store_server import (
        create_store_server,
    )

    kind = request.param
    env = {"PIO_STORAGE_SOURCES_X_TYPE": kind}
    if kind == "replicated":
        # three store servers, each on its own sqlite; W = 2 of 3
        servers = []
        for i in range(3):
            (tmp_path / f"node{i}").mkdir()
            server = create_store_server(
                host="127.0.0.1", port=0, storage=Storage(env={
                    **_env("sqlite", tmp_path / f"node{i}"),
                    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"}))
            server.start()
            servers.append(server)
        env["PIO_STORAGE_SOURCES_X_URLS"] = ",".join(
            f"http://127.0.0.1:{s.port}" for s in servers)
        env["PIO_STORAGE_SOURCES_X_HINT_DIR"] = str(tmp_path / "hints")

        def stop():
            for server in servers:
                server.shutdown()
    elif kind == "httpstore":
        server = create_store_server(
            host="127.0.0.1", port=0, storage=Storage(env={
                **_env("sqlite", tmp_path),
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"}))
        server.start()
        env["PIO_STORAGE_SOURCES_X_URL"] = f"http://127.0.0.1:{server.port}"
        stop = server.shutdown
    else:
        cls, scheme = ((MiniPGServer, "postgresql") if kind == "postgres"
                       else (MiniMySQLServer, "mysql"))
        server = cls(path=str(tmp_path / "dev.db"), password="pio")
        port = server.start()
        env["PIO_STORAGE_SOURCES_X_URL"] = (
            f"{scheme}://pio:pio@127.0.0.1:{port}/pio")
        stop = server.stop
    yield kind, env
    stop()


@pytest.mark.parametrize("networked_env",
                         ["postgres", "mysql", "httpstore", "replicated"],
                         indirect=True)
def test_networked_backends_resolve_and_round_trip_an_app(networked_env):
    """``Storage(env=...)`` resolves each networked type for every
    repository (``replicated``: a quorum over three store servers), and
    an app, its events and a model go there and back."""
    kind, env = networked_env
    storage = Storage(env=env)
    if kind == "replicated":
        try:
            _round_trip(storage)
            for peer in storage._client("X").peers:
                assert peer.models.get("m").models == b"\x00\xffblob"
        finally:
            storage._client("X").close()
        return
    _round_trip(storage)


def _round_trip(storage):
    app_id = storage.get_meta_data_apps().insert(App(0, "shop", "d"))
    assert storage.get_meta_data_apps().get_by_name("shop") == App(
        app_id, "shop", "d")
    rows = _event_rows(20, seed=5)
    events = storage.get_events()
    events.init(app_id)
    events.insert_batch([Event(**r) for r in rows], app_id)
    jax_made = [JaxEvent(**r) for r in rows]
    _assert_same_events(list(events.find(app_id)), jax_made)
    from predictionio_tpu_torch.data.storage import Model

    storage.get_model_data_models().insert(Model("m", b"\x00\xffblob"))
    assert storage.get_model_data_models().get("m").models == (
        b"\x00\xffblob")
    assert storage.verify_all_data_objects() == []
    assert storage.backend_for_source("X") is storage.get_events()


@pytest.mark.parametrize("kind", ["sqlite", "eventlog", "memory"])
def test_verify_all_data_objects_and_backend_for_source(tmp_path, kind):
    storage = Storage(env=_env(kind, tmp_path))
    assert storage.verify_all_data_objects() == []
    assert storage.get_events() is storage.get_events()
    source = {"sqlite": "SQL", "eventlog": "LOG", "memory": "MEM"}[kind]
    assert storage.backend_for_source(source) is storage.get_events()
    with pytest.raises(StorageError, match="unknown storage source"):
        storage.backend_for_source("NOPE")
    fs = Storage(env={"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
                      "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "m")})
    with pytest.raises(StorageError, match="does not support events"):
        fs.backend_for_source("FS")


def test_legacy_access_key_column_is_renamed(tmp_path):
    """A file whose ``access_keys`` table still has the old ``key``
    column opens in the port, which renames the column in place; the
    JAX package reads the result."""
    import sqlite3

    path = tmp_path / "pio.sqlite"
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE access_keys (key TEXT PRIMARY KEY, "
                "appid INTEGER NOT NULL, events TEXT NOT NULL)")
    con.execute("INSERT INTO access_keys VALUES ('old', 3, '[\"view\"]')")
    con.commit()
    con.close()
    port = Storage(env=_env("sqlite", tmp_path))
    assert port.get_meta_data_access_keys().get("old") == AccessKey(
        "old", 3, ("view",))
    assert JaxStorage(env=_env("sqlite", tmp_path)) \
        .get_meta_data_access_keys().get("old").events == ("view",)
