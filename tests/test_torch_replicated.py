"""The port's replicated store tier against the JAX package's.

Every case runs one seeded script twice: with the JAX
``ReplicatedStoreClient`` over three (or fewer) JAX store servers, and
with the port's client over the port's servers; most also run the
port's client over JAX peers and the JAX client over the port's peers.
What each run leaves behind is compared after masking ports, writer ids
and wall times: acks and raises, each peer's contents, the hint files
(their JSON payloads), ``status()``, the timeline's event kinds in
order, and the ``pio_store_*`` samples (counter deltas, gauges by peer).
The groups mirror JAX ``tests/test_replicated.py``:

* quorum writes (every peer; one down and hinted; below quorum raising
  and hinting nothing; the batch quorum prefix; metadata ids fanned out);
* ``X-PIO-Store-Seq`` replay on the event log (same seq; a cold cache; a
  warm writer's replay marker; a retry overtaken by a concurrent seq; a
  bad header → 400);
* hinted handoff (replay on recovery; the bound, drop-oldest; a poison
  hint dropped; the drain stopping at the first failure);
* failover reads (a live peer's None falls through; sticky failover;
  read-repair; a corrupt blob detected and repaired; completed instances
  merged newest first);
* anti-entropy (an empty node converges; a manifest is withheld until
  its artifacts verify; a server's loop reports in ``/healthz``), the
  incremental watermark cache, the ``replicated`` env source, and
  ``status --store-url``;
* a port store server peering with a JAX one, both ways, converges;
* a quorum writer of the port SIGKILLed mid-stream loses no acked write
  (``tests/torch_quorum_crash_child.py``);
* events through the tier → ``run_train`` (CPU) → served (CPU): the
  answers name the same items in the same order as the JAX package's
  over its own tier, ties aside, scores within 2e-5 absolute (the
  tolerance of ``test_torch_train.py``, whose helper holds them);
* the port's anti-entropy pulls a peer's events with one scan of the
  local log, where the JAX loop makes a point read per peer event (a
  whole-log scan each on the event log): the pulls are the same.

No case sleeps on a cadence: ``sync_once`` and ``HintQueue.drain`` are
called directly, and every wait has a time limit of its own.
"""

from __future__ import annotations

import datetime as dt
import hashlib
import importlib
import json
import os
import re
import signal
import subprocess
import sys
import types

import pytest

T0 = dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(os.path.dirname(__file__), "torch_quorum_crash_child.py")
MEM_ENV = {
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
}


def _mods(pkg: str) -> types.SimpleNamespace:
    root = "predictionio_tpu" if pkg == "jax" else "predictionio_tpu_torch"

    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        name=pkg, storage=m("data.storage"), base=m("data.storage.base"),
        httpstore=m("data.storage.httpstore"),
        repl=m("data.storage.replicated"), event=m("data.event"),
        store_server=m("serving.store_server"),
        resilience=m("serving.resilience"), timeline=m("obs.timeline"),
        registry=m("obs.registry"), cli=m("cli.main"))


MODS = {pkg: _mods(pkg) for pkg in ("jax", "port")}
#: (client package, server package) of a run; the reference is jax/jax
TOPOLOGIES = {"port": ("port", "port"), "port-over-jax": ("port", "jax"),
              "jax-over-port": ("jax", "port")}


@pytest.fixture(autouse=True)
def _clean_breakers():
    """Circuit breakers are process-global (keyed host:port) in each
    package: a peer crashed in one case must not fast-fail the next."""
    for mods in MODS.values():
        mods.resilience.reset_breakers()
    yield
    for mods in MODS.values():
        mods.resilience.reset_breakers()


class Run:
    """One run of a case: ``C`` the client package's modules, ``S`` the
    servers'. Tracks what it starts so ``close`` ends it, and the live
    ports so ``observe`` can mask them."""

    def __init__(self, client: str, server: str, base):
        self.C, self.S = MODS[client], MODS[server]
        self.base = base
        base.mkdir(parents=True, exist_ok=True)
        self.servers, self.clients, self.loops, self.ports = [], [], [], []

    # -- servers and clients ---------------------------------------------

    def mem(self, mods=None):
        return (mods or self.S).storage.Storage(env=MEM_ENV)

    def server(self, port=0, storage=None, mods=None, **kw):
        mods = mods or self.S
        http = mods.store_server.create_store_server(
            host="127.0.0.1", port=port, storage=storage or self.mem(mods),
            **kw)
        http.start()
        self.servers.append(http)
        if http.port not in self.ports:
            self.ports.append(http.port)
        if http.store_app.replication is not None:
            self.loops.append(http.store_app.replication)
        return http

    @staticmethod
    def url(server) -> str:
        return f"http://127.0.0.1:{server.port}"

    def client(self, urls, mods=None, **conf):
        config = {"URLS": ",".join(urls), "HINT_DIR": str(self.base / "hints"),
                  "TIMEOUT": "5"}
        config.update({k: str(v) for k, v in conf.items()})
        rc = (mods or self.C).repl.ReplicatedStoreClient(config)
        self.clients.append(rc)
        return rc

    def loop(self, storage, peers, mods=None, **kw):
        loop = (mods or self.S).repl.AntiEntropyLoop(
            storage=storage, peers=peers, interval=3600, **kw)
        self.loops.append(loop)
        return loop

    def http_events(self, server, mods=None):
        mods = mods or self.C
        return mods.httpstore.HTTPEvents(
            mods.httpstore.HTTPStoreClient({"URL": self.url(server)}))

    def event(self, i: int, tag: str = "u", mods=None):
        return (mods or self.C).event.Event(
            event="rate", entity_type="user", entity_id=f"{tag}{i}",
            properties={"n": i}, event_time=T0 + dt.timedelta(seconds=i),
            creation_time=T0 + dt.timedelta(hours=1, seconds=i),
            event_id=f"{tag}ev{i:04d}")

    def model(self, model_id, blob, mods=None):
        return (mods or self.C).base.Model(id=model_id, models=blob)

    def close(self):
        for rc in self.clients:
            rc.close()
        for loop in self.loops:
            loop.close()
        for s in self.servers:
            s.shutdown()

    # -- what a run leaves behind ------------------------------------------

    def hints(self, rc) -> dict:
        """{peer index: [payload, ...]} of every non-empty queue, in
        queue order."""
        out = {}
        for i, peer in enumerate(rc.peers):
            q = rc.hints[peer.name]
            files = sorted(f for f in os.listdir(q.dir) if f.endswith(".json"))
            if files:
                out[i] = [json.loads(open(os.path.join(q.dir, f)).read())
                          for f in files]
        return out

    def mask(self, obj):
        text = json.dumps(obj, sort_keys=True, default=str)
        for i, port in enumerate(self.ports):
            text = re.sub(rf"127\.0\.0\.1([:_]){port}\b",
                          rf"<node{i}>", text)
        text = re.sub(r'"[0-9a-f]{12}:(\d+)"', r'"<writer>:\1"', text)
        text = re.sub(r'(requestId\\*": \\*")[0-9a-f]{16}', r"\1<rid>",
                      text)
        return _mask_times(json.loads(text))


_TIME_KEYS = {"lastSync", "lagSeconds", "wall", "mono"}


def _mask_times(obj):
    if isinstance(obj, dict):
        return {k: ("<t>" if k in _TIME_KEYS and v is not None
                    else _mask_times(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask_times(v) for v in obj]
    return obj


def _metric_state() -> dict:
    """Every ``pio_store_*`` sample of both packages' registries."""
    out = {}
    for pkg, mods in MODS.items():
        lag, hints, repairs = mods.repl._register_metrics(
            mods.registry.get_registry())
        for fam in (hints, repairs):
            for labels, child in fam.samples():
                out[(pkg, fam.name, labels)] = child.value
    return out


class _Recorded:
    """Every ``Timeline.record`` of both packages while it is entered,
    in call order, whichever ring took it (each store server installs
    its own as the process-global one)."""

    def __init__(self):
        self.kinds: list = []
        self._saved = []

    def __enter__(self):
        for mods in MODS.values():
            cls = mods.timeline.Timeline
            real = cls.record
            self._saved.append((cls, real))

            def record(this, kind, message, *a, _real=real, **kw):
                self.kinds.append((kind, kw.get("peer")))
                return _real(this, kind, message, *a, **kw)

            cls.record = record
        return self

    def __exit__(self, *exc):
        for cls, real in self._saved:
            cls.record = real


def observe(case, topology: str, base) -> dict:
    """``case(run)`` under one topology, with the timeline and metric
    deltas it caused, masked."""
    client, server = topology
    before_m = _metric_state()
    run = Run(client, server, base / f"{client}-{server}")
    try:
        with _Recorded() as recorded:
            result = case(run)
    finally:
        run.close()
    after = _metric_state()
    metrics = {}
    for (pkg, name, labels), value in after.items():
        delta = value - before_m.get((pkg, name, labels), 0.0)
        key = f"{name}{list(labels)}"
        if name == "pio_store_hints_pending":
            if delta:  # a gauge this run moved: its final value
                metrics[key] = value
        elif delta:
            metrics[key] = metrics.get(key, 0.0) + delta
    out = run.mask({"result": result, "timeline": recorded.kinds,
                    "metrics": metrics})
    # a gauge of this run's own nodes only: the fixed dead ports'
    # gauges are shared by every case's clients
    out["metrics"] = {
        k: v for k, v in out["metrics"].items()
        if not k.startswith("pio_store_hints_pending") or "<node" in k}
    return out


_REFERENCE: dict = {}


def check_alike(case, topology_name: str, tmp_path) -> dict:
    """The case's run under ``topology_name`` equals the jax/jax run's
    (run once per case and kept)."""
    if case not in _REFERENCE:
        _REFERENCE[case] = observe(case, ("jax", "jax"), tmp_path / "ref")
    got = observe(case, TOPOLOGIES[topology_name], tmp_path)
    assert got == _REFERENCE[case]
    return got


def _raised(fn) -> dict:
    """The exception ``fn`` raises: its class name and its message up to
    the first error's text (which names a port and the OS's wording)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the raise is the observation
        return {"raised": type(e).__name__,
                "message": str(e).split("; first error")[0]}
    return {"raised": None}


def _manifest(model_id: str, blob: bytes) -> bytes:
    return json.dumps({"artifacts": [{
        "id": model_id, "sha256": hashlib.sha256(blob).hexdigest(),
        "bytes": len(blob)}]}).encode()


# -- quorum writes -------------------------------------------------------------


def q_every_peer(run):
    servers = [run.server() for _ in range(3)]
    rc = run.client([run.url(s) for s in servers], W=2)
    events = rc.dao("events")
    events.init(1)
    eid = events.insert(run.event(0), 1)
    return {"eid": eid,
            "held": [p.events.get(eid, 1) is not None for p in rc.peers],
            "status": rc.status(), "hints": run.hints(rc)}


def q_one_down(run):
    servers = [run.server() for _ in range(2)]
    rc = run.client([run.url(s) for s in servers] + ["http://127.0.0.1:1"],
                    W=2, TIMEOUT=1)
    events = rc.dao("events")
    events.init(1)
    eid = events.insert(run.event(0), 1)
    ids = events.insert_batch([run.event(i) for i in range(1, 4)], 1)
    return {"eid": eid, "ids": ids,
            "held": [p.events.get(eid, 1) is not None for p in rc.peers[:2]],
            "status": rc.status(), "hints": run.hints(rc)}


def q_below_quorum(run):
    server = run.server()
    rc = run.client([run.url(server), "http://127.0.0.1:1",
                     "http://127.0.0.1:2"], W=2, TIMEOUT=1)
    raised = _raised(lambda: rc.dao("events").insert(run.event(0), 1))
    return {"raised": raised, "hints": run.hints(rc),
            "pending": [rc.hints[p.name].pending() for p in rc.peers]}


def q_batch_prefix(run):
    servers = [run.server() for _ in range(2)]
    rc = run.client([run.url(s) for s in servers], W=2)
    events = rc.dao("events")
    events.init(1)
    ids = events.insert_batch([run.event(i) for i in range(20)], 1)
    return {"ids": ids,
            "held": [sorted(e.event_id for e in p.events.find(1))
                     for p in rc.peers]}


def q_batch_below_quorum(run):
    server = run.server()
    rc = run.client([run.url(server), "http://127.0.0.1:1"], W=2, TIMEOUT=1)
    events = rc.dao("events")
    err = None
    try:
        events.insert_batch([run.event(i) for i in range(5)], 1)
    except run.C.base.PartialBatchError as e:
        err = {"inserted": list(e.inserted_ids), "message": str(e)}
    return {"partial": err, "hints": run.hints(rc),
            "held": sorted(e.event_id for e in rc.peers[0].events.find(1))}


def q_metadata_ids(run):
    servers = [run.server() for _ in range(2)]
    rc = run.client([run.url(s) for s in servers], W=2)
    apps = rc.dao("apps")
    first = apps.insert(run.C.base.App(id=0, name="repl"))
    second = apps.insert(run.C.base.App(id=0, name="repl2"))
    dup = apps.insert(run.C.base.App(id=0, name="repl"))
    key = rc.dao("access_keys").insert(
        run.C.base.AccessKey(key="k1", appid=first))
    return {"ids": [first, second, dup], "key": key,
            "per_peer": [[(a.id, a.name) for a in p.apps.get_all()]
                         for p in rc.peers],
            "keys": [[k.key for k in p.access_keys.get_all()]
                     for p in rc.peers]}


QUORUM = {"every_peer": q_every_peer, "one_down": q_one_down,
          "below_quorum": q_below_quorum, "batch_prefix": q_batch_prefix,
          "batch_below_quorum": q_batch_below_quorum,
          "metadata_ids": q_metadata_ids}


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("case", list(QUORUM))
def test_quorum_writes_alike(tmp_path, case, topology):
    got = check_alike(QUORUM[case], topology, tmp_path)
    if case == "below_quorum":
        assert got["result"]["raised"]["raised"] == "ReplicationError"
        assert "peers acked" in got["result"]["raised"]["message"]
    if case == "one_down":
        assert len(got["result"]["hints"]["2"]) == 3
        assert "store_hint_enqueued" in [k for k, _ in got["timeline"]]


# -- X-PIO-Store-Seq replay on the event log -----------------------------------


def _eventlog_server(run):
    storage = run.S.storage.Storage(env={
        **MEM_ENV,
        "PIO_STORAGE_SOURCES_ELOG_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_ELOG_PATH": str(run.base / "elog"),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "ELOG"})
    return run.server(storage=storage)


def s_same_seq(run):
    server = _eventlog_server(run)
    dao = run.http_events(server)
    dao.init(1)
    e = run.event(0)
    out = [dao.insert(e, 1, store_seq="w1:7"),
           dao.insert(e, 1, store_seq="w1:7")]
    return {"acks": out, "held": [x.event_id for x in dao.find(1)]}


def s_cold_cache(run):
    server = _eventlog_server(run)
    dao = run.http_events(server)
    dao.init(1)
    e = run.event(1)
    out = [dao.insert(e, 1, store_seq="w2:1")]
    server.store_app._seq_cache.clear()
    out.append(dao.insert(e, 1, store_seq="w2:1"))
    return {"acks": out, "held": [x.event_id for x in dao.find(1)]}


def s_warm_writer(run):
    server = _eventlog_server(run)
    dao = run.http_events(server)
    dao.init(1)
    first, pulled = run.event(0), run.event(1)
    dao.insert(first, 1, store_seq="w3:1", replay=True)
    dao.insert(pulled, 1)
    dao.insert(pulled, 1, store_seq="w3:2", replay=True)
    mid = len(list(dao.find(1)))
    acks = dao.insert_batch([first, pulled], 1, store_seq="w3:3",
                            replay=True)
    return {"mid": mid, "acks": acks,
            "held": [x.event_id for x in dao.find(1)]}


def s_overtaken(run):
    server = _eventlog_server(run)
    dao = run.http_events(server)
    dao.init(1)
    e5, e6 = run.event(5), run.event(6)
    dao.insert(e5, 1, store_seq="w4:5")
    dao.insert(e6, 1, store_seq="w4:6")
    dao.insert(e5, 1, store_seq="w4:5")
    mid = len(list(dao.find(1)))
    server.store_app._SEQ_WINDOW = 1
    dao.insert(run.event(7), 1, store_seq="w4:7")
    dao.insert(e5, 1, store_seq="w4:5")
    return {"mid": mid, "held": [x.event_id for x in dao.find(1)]}


def s_bad_header(run):
    server = _eventlog_server(run)
    dao = run.http_events(server)
    dao.init(1)
    raised = _raised(lambda: dao.insert(run.event(2), 1,
                                        store_seq="no-writer-part"))
    return {"raised": raised, "has_400": "400" in raised.get("message", ""),
            "held": [x.event_id for x in dao.find(1)]}


SEQ = {"same_seq": s_same_seq, "cold_cache": s_cold_cache,
       "warm_writer": s_warm_writer, "overtaken": s_overtaken,
       "bad_header": s_bad_header}


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("case", list(SEQ))
def test_seq_replay_alike(tmp_path, monkeypatch, case, topology):
    monkeypatch.setenv("PIO_EVENTLOG_FSYNC", "1")
    got = check_alike(SEQ[case], topology, tmp_path)["result"]
    if case in ("same_seq", "cold_cache"):
        assert len(got["held"]) == 1
    if case == "warm_writer":
        assert got["mid"] == len(got["held"]) == 2
    if case == "overtaken":
        assert (got["mid"], len(got["held"])) == (2, 3)
    if case == "bad_header":
        assert got["has_400"] and got["held"] == []


# -- hinted handoff ------------------------------------------------------------


def h_recovery(run):
    up, down = run.server(), run.server()
    down_port = down.port
    down.shutdown()
    run.servers.remove(down)
    rc = run.client([run.url(up), f"http://127.0.0.1:{down_port}"],
                    W=1, TIMEOUT=1)
    events = rc.dao("events")
    events.init(1)
    eid = events.insert(run.event(0), 1)
    models = rc.dao("models")
    models.insert(run.model("g1", b"blob-bytes"))
    queued = run.hints(rc)
    queue = rc.hints[rc.peers[1].name]
    recovered = run.server(port=down_port)
    import time

    time.sleep(0.1)  # past PIO_BREAKER_RESET_S: the probe half-opens
    replayed = queue.drain(lambda p: rc._apply_hint(rc.peers[1], p))
    back = rc.peers[1]
    return {"queued": queued, "replayed": replayed,
            "pending": queue.pending(),
            "event": back.events.get(eid, 1) is not None,
            "model": back.models.get("g1").models.decode(),
            "recovered_port": recovered.port == down_port}


def _queue(run, name, limit):
    return run.C.repl.HintQueue(str(run.base / "q"), name, limit=limit)


def h_bounded(run):
    queue = _queue(run, "peer_1", 3)
    for i in range(5):
        queue.append({"op": "event", "n": i})
    seen = []
    pending, dropped = queue.pending(), queue.dropped
    queue.drain(lambda p: seen.append(p["n"]))
    return {"pending": pending, "dropped": dropped, "seen": seen,
            "files_after": os.listdir(queue.dir)}


def h_poison(run):
    queue = _queue(run, "peer_4", 10)
    queue.append({"op": "event"})
    queue.append({"n": 1})
    with open(os.path.join(queue.dir, f"{99:020d}.json"), "w") as f:
        f.write("{torn")
    seen = []

    def apply(payload):
        if "n" not in payload:
            raise KeyError("event")
        seen.append(payload["n"])

    replayed = queue.drain(apply)
    return {"replayed": replayed, "seen": seen, "pending": queue.pending(),
            "dropped": queue.dropped}


def h_first_failure(run):
    queue = _queue(run, "peer_2", 10)
    for i in range(3):
        queue.append({"n": i})
    calls = []

    def flaky(payload):
        calls.append(payload["n"])
        if payload["n"] == 1:
            raise run.C.base.StorageError("peer went away again")

    raised = _raised(lambda: queue.drain(flaky))
    return {"raised": raised, "calls": calls, "pending": queue.pending(),
            "left": sorted(os.listdir(queue.dir))}


HINTS = {"recovery": h_recovery, "bounded": h_bounded, "poison": h_poison,
         "first_failure": h_first_failure}


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("case", list(HINTS))
def test_hinted_handoff_alike(tmp_path, monkeypatch, case, topology):
    monkeypatch.setenv("PIO_BREAKER_RESET_S", "0.05")
    got = check_alike(HINTS[case], topology, tmp_path)["result"]
    if case == "recovery":
        assert got["replayed"] == 3 and got["pending"] == 0
        assert got["event"] and got["model"] == "blob-bytes"
        ops = [p["op"] for p in got["queued"]["1"]]
        assert ops == ["event_init", "event", "model"]
    if case == "bounded":
        assert (got["pending"], got["dropped"], got["seen"]) == (
            3, 2, [2, 3, 4])
    if case == "poison":
        assert (got["replayed"], got["seen"], got["dropped"]) == (1, [1], 2)
    if case == "first_failure":
        assert got["calls"] == [0, 1] and got["pending"] == 2


# -- failover reads ------------------------------------------------------------


def f_fall_through(run):
    a, b = run.server(), run.server()
    rc = run.client([run.url(a), run.url(b)], W=1)
    rc.peers[1].access_keys.insert(run.C.base.AccessKey(key="k-fresh",
                                                        appid=1))
    got = rc.dao("access_keys").get("k-fresh")
    return {"got": got.key if got else None,
            "absent": rc.dao("access_keys").get("k-absent"),
            "order": [p.name for p in rc.read_order()]}


def f_sticky(run):
    server = run.server()
    rc = run.client(["http://127.0.0.1:1", run.url(server)], W=1, TIMEOUT=1)
    app_id = rc.peers[1].apps.insert(run.C.base.App(id=0, name="only-b"))
    first = rc.dao("apps").get(app_id).name
    order = [p.name for p in rc.read_order()]
    again = rc.dao("apps").get_by_name("only-b").id
    return {"first": first, "order": order, "again": again,
            "all": [a.name for a in rc.dao("apps").get_all()]}


def f_read_repair(run):
    servers = [run.server() for _ in range(2)]
    rc = run.client([run.url(s) for s in servers], W=1)
    blob = b"generation-bytes"
    rc.peers[1].models.insert(run.model("gen1", blob))
    rc.peers[1].models.insert(run.model("gen1.manifest",
                                        _manifest("gen1", blob)))
    got = rc.dao("models").get("gen1")
    back = rc.peers[0].models.get("gen1")
    return {"got": got.models.decode(), "backfilled": back.models.decode(),
            "missing": rc.dao("models").get("nope"),
            "ids": rc.dao("models").list_ids()}


def f_corrupt(run):
    servers = [run.server() for _ in range(2)]
    rc = run.client([run.url(s) for s in servers], W=1)
    blob = b"good-bytes"
    rc.peers[0].models.insert(run.model("gen2", b"rotten-bytes!!"))
    for p in rc.peers:
        p.models.insert(run.model("gen2.manifest", _manifest("gen2", blob)))
    rc.peers[1].models.insert(run.model("gen2", blob))
    got = rc.dao("models").get("gen2")
    return {"got": got.models.decode(),
            "repaired": rc.peers[0].models.get("gen2").models.decode()}


def f_merged(run):
    servers = [run.server() for _ in range(2)]
    rc = run.client([run.url(s) for s in servers], W=1)

    def inst(iid, offset):
        return run.C.base.EngineInstance(
            id=iid, status="COMPLETED",
            start_time=T0 + dt.timedelta(minutes=offset),
            end_time=T0 + dt.timedelta(minutes=offset + 1),
            engine_id="e", engine_version="1", engine_variant="default",
            engine_factory="f")

    rc.peers[0].engine_instances.insert(inst("old", 0))
    rc.peers[1].engine_instances.insert(inst("new", 60))
    rc.peers[1].engine_instances.insert(inst("mid", 30))
    dao = rc.dao("engine_instances")
    return {"latest": dao.get_latest_completed("e", "1", "default").id,
            "merged": [i.id for i in dao.get_completed("e", "1",
                                                       "default")]}


FAILOVER = {"fall_through": f_fall_through, "sticky": f_sticky,
            "read_repair": f_read_repair, "corrupt": f_corrupt,
            "merged": f_merged}


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("case", list(FAILOVER))
def test_failover_reads_alike(tmp_path, case, topology):
    got = check_alike(FAILOVER[case], topology, tmp_path)
    r = got["result"]
    if case == "fall_through":
        assert r["got"] == "k-fresh" and r["absent"] is None
    if case == "sticky":
        assert r["first"] == "only-b" and r["order"][0] == "<node0>"
        assert ("store_failover", "<node0>") in [tuple(t) for t in
                                                 got["timeline"]]
    if case == "read_repair":
        assert r["got"] == r["backfilled"] == "generation-bytes"
        assert got["metrics"]["pio_store_repair_total['read_repair']"] == 1
    if case == "corrupt":
        assert r["got"] == r["repaired"] == "good-bytes"
        kinds = [k for k, _ in got["timeline"]]
        assert kinds == ["store_read_corrupt", "store_read_repair"]
    if case == "merged":
        assert (r["latest"], r["merged"]) == ("new", ["new", "mid", "old"])


# -- anti-entropy --------------------------------------------------------------


def a_converges(run):
    server_a = run.server()
    rc = run.client([run.url(server_a)], W=1)
    app_id = rc.dao("apps").insert(run.C.base.App(id=0, name="demo"))
    rc.dao("channels").insert(run.C.base.Channel(id=0, name="ch",
                                                 appid=app_id))
    events = rc.dao("events")
    events.init(app_id)
    for i in range(7):
        events.insert(run.event(i), app_id)
    blob = b"model-bytes"
    rc.dao("models").insert(run.model("g1", blob))
    rc.dao("models").insert(run.model("g1.manifest", _manifest("g1", blob)))
    storage_b = run.mem(run.S)
    loop = run.loop(storage_b, [run.url(server_a)])
    first = loop.sync_once(horizon=0.0)
    second = loop.sync_once(horizon=0.0)
    status = loop.status()
    return {"first": first, "second": second, "status": status,
            "apps": [a.name for a in storage_b.get_meta_data_apps()
                     .get_all()],
            "events": sorted(e.event_id
                             for e in storage_b.get_events().find(app_id)),
            "model": storage_b.get_model_data_models().get("g1")
            .models.decode()}


def a_deferred(run):
    storage_a = run.mem(run.S)
    server_a = run.server(storage=storage_a)
    models = storage_a.get_model_data_models()
    Model = run.S.base.Model
    models.insert(Model(id="gX.manifest", models=json.dumps({"artifacts": [
        {"id": "gX", "sha256": "0" * 64, "bytes": 5}]}).encode()))
    models.insert(Model(id="gX", models=b"wrong-size-bytes"))
    storage_b = run.mem(run.S)
    loop = run.loop(storage_b, [run.url(server_a)])
    totals = loop.sync_once()
    b = storage_b.get_model_data_models()
    return {"totals": totals, "manifest": b.get("gX.manifest"),
            "blob": b.get("gX").models.decode()}


def a_healthz(run):
    server_a = run.server()
    server_b = run.server(peers=[run.url(server_a)], role="replica",
                          mods=run.C)
    client = run.C.httpstore.HTTPStoreClient({"URL": run.url(server_b)})
    payload = client.json("GET", "/healthz")
    plain = client.json("GET", "/")
    return {"replication": payload["replication"],
            "keys": sorted(payload), "status": plain}


ANTI = {"converges": a_converges, "deferred": a_deferred,
        "healthz": a_healthz}


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("case", list(ANTI))
def test_anti_entropy_alike(tmp_path, case, topology):
    got = check_alike(ANTI[case], topology, tmp_path)["result"]
    if case == "converges":
        assert got["first"] == {"metadata": 2, "events": 7, "models": 2}
        assert sum(got["second"].values()) == 0
        assert got["model"] == "model-bytes" and len(got["events"]) == 7
    if case == "deferred":
        assert got["manifest"] is None
    if case == "healthz":
        assert got["replication"]["role"] == "replica"
        assert len(got["replication"]["peers"]) == 1


def test_the_port_pulls_with_one_scan_where_jax_reads_per_event(tmp_path):
    """The same pull in both packages, counting the local point reads:
    the JAX loop makes one per peer event (on the event log each is a
    scan of the whole log), the port's none."""
    reads = {}
    pulled = {}
    for pkg in ("jax", "port"):
        run = Run(pkg, pkg, tmp_path / pkg)
        try:
            server_a = run.server()
            rc = run.client([run.url(server_a)], W=1)
            app_id = rc.dao("apps").insert(run.C.base.App(id=0, name="d"))
            rc.dao("events").init(app_id)
            rc.dao("events").insert_batch([run.event(i) for i in range(40)],
                                          app_id)
            storage_b = run.mem()
            dao = storage_b.get_events()
            dao.init(app_id)
            for i in range(10):
                dao.insert(run.event(i), app_id)
            counted = []
            real_get = dao.get
            dao.get = lambda *a, **k: counted.append(1) or real_get(*a, **k)
            loop = run.loop(storage_b, [run.url(server_a)])
            pulled[pkg] = loop.sync_once(horizon=0.0)
            reads[pkg] = len(counted)
            assert sorted(e.event_id for e in dao.find(app_id)) == [
                f"uev{i:04d}" for i in range(40)]
        finally:
            run.close()
    assert pulled["port"] == pulled["jax"] == {
        "metadata": 1, "events": 30, "models": 0}
    assert reads == {"jax": 40, "port": 0}


# -- the watermark cache, the env source --------------------------------------


def w_incremental(run):
    server = run.server()
    store_server = run.S.store_server
    dao = run.http_events(server)
    dao.init(1)
    ids = [dao.insert(run.event(0), 1)]
    marks = [dao.watermark(1)]
    entry = server.store_app.watermarks._entries[(1, None)]
    for i in range(1, 4):
        ids.append(dao.insert(run.event(i), 1))
    counted = entry["count"]
    marks.append(dao.watermark(1))
    deleted = dao.delete(ids[0], 1)
    dropped = (1, None) not in server.store_app.watermarks._entries
    marks.append(dao.watermark(1))
    return {"marks": marks, "counted": counted, "deleted": deleted,
            "dropped": dropped,
            "exact": [marks[0]["checksum"] == store_server.event_set_checksum(
                ids[:1]), marks[1]["checksum"] == store_server
                .event_set_checksum(ids), marks[2]["checksum"] ==
                store_server.event_set_checksum(ids[1:])]}


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_watermark_cache_is_incremental_and_exact_alike(tmp_path, topology):
    got = check_alike(w_incremental, topology, tmp_path)["result"]
    assert got["counted"] == 4 and got["dropped"] and all(got["exact"])
    assert [m["count"] for m in got["marks"]] == [1, 4, 3]


def e_binds(run):
    servers = [run.server() for _ in range(2)]
    storage = run.C.storage.Storage(env={
        "PIO_STORAGE_SOURCES_REPL_TYPE": "replicated",
        "PIO_STORAGE_SOURCES_REPL_URLS": ",".join(run.url(s)
                                                  for s in servers),
        "PIO_STORAGE_SOURCES_REPL_HINT_DIR": str(run.base / "hints"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "REPL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "REPL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "REPL"})
    run.clients.append(storage._client("REPL"))
    apps = storage.get_meta_data_apps()
    app_id = apps.insert(run.C.base.App(id=0, name="via-env"))
    return {"name": apps.get(app_id).name,
            "status": run.C.repl.replication_status(storage),
            "plain": run.C.repl.replication_status(
                run.C.storage.Storage(env=MEM_ENV))}


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_replicated_env_source_binds_alike(tmp_path, topology):
    got = check_alike(e_binds, topology, tmp_path)["result"]
    assert got["status"]["n"] == 2 and got["status"]["w"] == 2
    assert got["plain"] is None


@pytest.mark.parametrize("config", [
    {}, {"URLS": " , "}, {"URLS": "http://127.0.0.1:1", "W": "2"},
    {"URLS": "http://127.0.0.1:1", "W": "x"},
    {"URLS": "http://127.0.0.1:1", "W": "0"},
    {"URLS": "http://127.0.0.1:1", "HINT_LIMIT": "many"},
], ids=["no-urls", "blank-urls", "w-out-of-range", "w-not-int", "w-zero",
        "hint-limit"])
def test_replicated_config_is_validated_alike(tmp_path, config):
    got = {}
    for pkg, mods in MODS.items():
        conf = dict(config, HINT_DIR=str(tmp_path / pkg))
        got[pkg] = _raised(lambda: mods.repl.ReplicatedStoreClient(conf))
    assert got["port"] == got["jax"]
    assert got["port"]["raised"] == "StorageError"


# -- status --store-url -------------------------------------------------------


def _status_line(run, capsys, argv):
    capsys.readouterr()
    rc = run.C.cli.main(argv)
    out = capsys.readouterr()
    text = re.sub(r"last-sync=[\d.]+s ago", "last-sync=<t>s ago", out.out)
    text = re.sub(r"lag=[\d.]+s", "lag=<t>s", text)
    return {"rc": rc, "out": text,
            "err": [ln for ln in out.err.splitlines()
                    if ln.startswith("[ERROR]")]}


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("case", ["line", "standalone", "down"])
def test_status_store_url_alike(tmp_path, capsys, case, topology):
    def status_case(run):
        if case == "down":
            return _status_line(run, capsys, ["status", "--store-url",
                                              "http://127.0.0.1:1"])
        server_a = run.server()
        if case == "standalone":
            return _status_line(run, capsys, ["status", "--store-url",
                                              run.url(server_a)])
        server_b = run.server(peers=[run.url(server_a)], role="primary")
        server_b.store_app.replication.sync_once()
        return _status_line(run, capsys, [
            "status", "--store-url", run.url(server_b), "--store-url",
            run.url(server_a)])

    ref = observe(status_case, ("jax", "jax"), tmp_path / "ref")
    got = observe(status_case, TOPOLOGIES[topology], tmp_path)
    assert got == ref
    r = got["result"]
    if case == "line":
        assert r["rc"] == 0
        assert r["out"].splitlines()[0] == (
            "Store http://<node1>: ok role=primary peers=1 lag=<t>s "
            "last-sync=<t>s ago")
        assert "standalone" in r["out"].splitlines()[1]
    if case == "standalone":
        assert r["rc"] == 0 and "standalone (no replication)" in r["out"]
    if case == "down":
        assert r["rc"] == 1 and len(r["err"]) == 1


# -- across the packages: a port store server peering with a JAX one ----------


@pytest.mark.parametrize("puller", ["port", "jax"])
def test_a_store_server_peering_across_packages_converges(tmp_path, puller):
    """A store server of one package with ``peers=[<the other package's
    server>]``: its loop pulls the other's metadata, events and models,
    and a second round finds the two watermarks equal."""
    other = "jax" if puller == "port" else "port"
    run = Run(other, other, tmp_path)
    try:
        source = run.server()
        rc = run.client([run.url(source)], W=1)
        app_id = rc.dao("apps").insert(run.C.base.App(id=0, name="x"))
        rc.dao("access_keys").insert(run.C.base.AccessKey(key="kx",
                                                          appid=app_id))
        rc.dao("events").init(app_id)
        rc.dao("events").insert_batch([run.event(i) for i in range(12)],
                                      app_id)
        blob = b"x" * 1000
        rc.dao("models").insert(run.model("gx", blob))
        rc.dao("models").insert(run.model("gx.manifest",
                                          _manifest("gx", blob)))
        target = run.server(peers=[run.url(source)], mods=MODS[puller])
        loop = target.store_app.replication
        first = loop.sync_once(horizon=0.0)
        second = loop.sync_once(horizon=0.0)
        assert first == {"metadata": 2, "events": 12, "models": 2}
        assert second == {"metadata": 0, "events": 0, "models": 0}
        theirs = run.http_events(source).watermark(app_id)
        mine = run.http_events(target, mods=MODS[puller]).watermark(app_id)
        assert (mine["checksum"], mine["count"]) == (
            theirs["checksum"], theirs["count"])
        storage = target.store_app._storage
        assert storage.get_model_data_models().get("gx").models == blob
        assert storage.get_meta_data_access_keys().get("kx").appid == app_id
    finally:
        run.close()


# -- crash safety ---------------------------------------------------------------


def test_quorum_writer_sigkill_loses_no_acked_write(tmp_path):
    """The port's quorum writer (W = N = 2) prints ``ACK <i> <id>`` only
    after both peers acked; SIGKILLed after 25 acks, every acked event
    is on every peer."""
    run = Run("port", "port", tmp_path)
    proc = None
    try:
        servers = [run.server() for _ in range(2)]
        env = dict(os.environ, PYTHONPATH=ROOT,
                   PIO_FS_BASEDIR=str(tmp_path))
        proc = subprocess.Popen(
            [sys.executable, CHILD, str(tmp_path / "hints"),
             *[run.url(s) for s in servers]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        acked = []
        import selectors
        import time

        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        deadline = time.monotonic() + 60
        while len(acked) < 25 and time.monotonic() < deadline:
            if not sel.select(timeout=1):
                continue
            line = proc.stdout.readline()
            if not line:
                break
            m = re.match(r"ACK (\d+) (\S+)", line)
            if m:
                acked.append(m.group(2))
        assert len(acked) == 25, proc.stderr.read() if proc.poll() else acked
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
        for i, server in enumerate(servers):
            have = {e.event_id for e in run.http_events(server).find(1)}
            missing = [a for a in acked if a not in have]
            assert not missing, f"peer {i} lost acked writes: {missing}"
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        run.close()


# -- events → trained → served over the tier ----------------------------------


def test_events_trained_and_served_alike_over_the_tier(tmp_path):
    """Each package's ``run_train`` (the port's on the CPU) reads its
    events from a replicated storage over three of its store servers,
    one of them down for the whole run, and publishes through the
    quorum; both packages' engine servers then load the generation
    through the tier and answer alike."""
    from predictionio_tpu.core.workflow import run_train as jax_run_train
    from predictionio_tpu.data.storage import set_storage as jax_set
    from predictionio_tpu.models.recommendation import (
        recommendation_engine as jax_engine,
    )
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.storage import set_storage
    from predictionio_tpu_torch.models.recommendation import (
        recommendation_engine,
    )
    from predictionio_tpu_torch.parallel.mesh import ComputeContext
    from test_torch_train import (
        N_EVENTS,
        VARIANT,
        _assert_served_alike,
        _events,
        _start_checkpoint,
    )

    cpu = ComputeContext.create(device="cpu")
    events = _events(MODS["port"].event.Event)
    ckpt = tmp_path / "ckpt"
    _start_checkpoint(ckpt, len({e.entity_id for e in events}),
                      len({e.target_entity_id for e in events}))
    runs, stores, ids = {}, {}, {}
    try:
        for pkg in ("jax", "port"):
            run = runs[pkg] = Run(pkg, pkg, tmp_path / pkg)
            servers = [run.server() for _ in range(2)]
            urls = [run.url(s) for s in servers] + ["http://127.0.0.1:1"]
            storage = stores[pkg] = run.C.storage.Storage(env={
                "PIO_STORAGE_SOURCES_R_TYPE": "replicated",
                "PIO_STORAGE_SOURCES_R_URLS": ",".join(urls),
                "PIO_STORAGE_SOURCES_R_TIMEOUT": "2",
                "PIO_STORAGE_SOURCES_R_HINT_DIR": str(run.base / "hints"),
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "R",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "R"})
            run.clients.append(storage._client("R"))
            app_id = storage.get_meta_data_apps().insert(
                run.C.base.App(0, "shop"))
            storage.get_events().init(app_id)
            storage.get_events().insert_batch(_events(run.C.event.Event),
                                              app_id)
            kw = dict(checkpoint_dir=str(ckpt), resume=True, storage=storage)
            if pkg == "jax":
                engine = jax_engine()
                jax_set(storage)
                try:
                    ids[pkg] = jax_run_train(
                        engine, engine.params_from_variant(VARIANT), "rec",
                        **kw)
                finally:
                    jax_set(None)
            else:
                engine = recommendation_engine()
                set_storage(storage)
                try:
                    ids[pkg] = run_train(
                        engine, engine.params_from_variant(VARIANT), "rec",
                        ctx=cpu, watermark={"events": N_EVENTS}, **kw)
                finally:
                    set_storage(None)
            # the generation is on both live peers, and hinted for the
            # dead one: blob, then manifest, each through the quorum
            rc = storage._client("R")
            for peer in rc.peers[:2]:
                assert peer.models.get(ids[pkg]) is not None
            ops = [p["op"] for p in runs[pkg].hints(rc)[2]]
            assert ops.count("model") == 2, ops
        assert stores["port"].get_meta_data_engine_instances().get(
            ids["port"]).status == "COMPLETED"
        _assert_served_alike(stores["jax"], ids["jax"], stores["port"],
                             ids["port"],
                             sorted({e.entity_id for e in events}), cpu)
    finally:
        for run in runs.values():
            run.close()


def test_a_replayed_batch_is_checked_against_the_id_set(tmp_path,
                                                       monkeypatch):
    """A hinted batch replayed into a store server on the event log: the
    JAX server makes a point read per event (each a scan of the whole
    log), the port's looks each id up in its watermark cache's id set;
    both store the same events."""
    monkeypatch.setenv("PIO_EVENTLOG_FSYNC", "1")
    reads, held = {}, {}
    for pkg in ("jax", "port"):
        run = Run(pkg, pkg, tmp_path / pkg)
        try:
            server = _eventlog_server(run)
            dao = run.http_events(server)
            dao.init(1)
            dao.insert_batch([run.event(i) for i in range(30)], 1,
                             store_seq="w1:1")
            local = server.store_app._storage.get_events()
            counted = []
            real_get = local.get
            monkeypatch.setattr(local, "get", lambda *a, **k: counted.append(
                1) or real_get(*a, **k))
            acked = dao.insert_batch([run.event(i) for i in range(20, 50)],
                                     1, store_seq="w2:1", replay=True)
            reads[pkg] = len(counted)
            held[pkg] = (acked, sorted(e.event_id for e in dao.find(1)))
        finally:
            run.close()
    assert held["port"] == held["jax"]
    assert len(held["port"][1]) == 50
    assert reads == {"jax": 30, "port": 0}


@pytest.mark.parametrize("peer_pkg", ["port", "jax"])
def test_the_port_pulls_only_missing_events_from_a_port_peer(tmp_path,
                                                             peer_pkg):
    """The port's loop asks a port store server for its ids and pulls
    only the events it lacks; a JAX store server has no ids route (404),
    and the loop falls back to the JAX pull of the whole log. The same
    events land either way."""
    run = Run("port", peer_pkg, tmp_path)
    try:
        source = run.server()
        rc = run.client([run.url(source)], W=1, mods=MODS[peer_pkg])
        app_id = rc.dao("apps").insert(MODS[peer_pkg].base.App(0, "d"))
        rc.dao("events").init(app_id)
        rc.dao("events").insert_batch(
            [run.event(i, mods=MODS[peer_pkg]) for i in range(40)], app_id)
        target = run.server(mods=MODS["port"])
        local = target.store_app._storage.get_events()
        local.init(app_id)
        for i in range(10):
            local.insert(run.event(i, mods=MODS["port"]), app_id)
        loop = MODS["port"].repl.AntiEntropyLoop(
            storage=target.store_app._storage, peers=[run.url(source)],
            interval=3600, insert_lock=target.store_app.ingest_lock,
            watermarks=target.store_app.watermarks)
        run.loops.append(loop)
        events = loop.peers[0].events
        sent = {"find": 0, "pull": 0}
        real_find, real_pull = events.find, events.pull

        def find(*a, **k):
            out = list(real_find(*a, **k))
            sent["find"] += len(out)
            return iter(out)

        def pull(*a, **k):
            out = real_pull(*a, **k)
            sent["pull"] += len(out)
            return out

        events.find, events.pull = find, pull
        assert loop.sync_once(horizon=0.0)["events"] == 30
        assert sorted(e.event_id for e in local.find(app_id)) == [
            f"uev{i:04d}" for i in range(40)]
        theirs = run.http_events(source).watermark(app_id)
        assert target.store_app.watermarks.summary(
            app_id, None, local)["checksum"] == theirs["checksum"]
        assert sent == ({"find": 0, "pull": 30} if peer_pkg == "port"
                        else {"find": 40, "pull": 0})
    finally:
        run.close()
