"""Store server — network service for the metadata, model and event
repositories.

Counterpart of ``predictionio_tpu/serving/store_server.py``, with the
same routes, statuses and bodies. The console's ``storeserver`` exposes
any locally-configured backend (sqlite + localfs by default) over
JSON/HTTP so every other process — trainer, event server, engine
servers, dashboard — can point its repositories at one host via the
``httpstore`` backend type
(:mod:`predictionio_tpu_torch.data.storage.httpstore`, which also
defines the wire codecs used here).

Routes::

    GET    /                                    liveness + backing info
    POST   /meta/<kind>                         insert    -> {"id": ...}
    GET    /meta/<kind>                         list (query-param filters)
    GET    /meta/<kind>/<id>                    get       -> record | 404
    PUT    /meta/<kind>/<id>                    update    -> {"ok": bool}
    DELETE /meta/<kind>/<id>                    delete    -> {"ok": bool}
    GET/PUT/DELETE /meta/engine_manifests/<id>/<version>   (2-part key)
    GET    /models                              -> {"ids": [...]} | 501
    PUT    /models/<id>                         blob upload (octet-stream)
    GET    /models/<id>                         blob | 404
    DELETE /models/<id>                         -> {"ok": bool}
    PUT    /events/<app_id>                     init      -> {"ok": bool}
    DELETE /events/<app_id>                     remove    -> {"ok": bool}
    POST   /events/<app_id>                     insert    -> {"id": ...}
    POST   /events/<app_id>/batch               -> {"ids": [...]} | 409
    GET    /events/<app_id>                     find (query-param filters)
    GET    /events/<app_id>/watermark           event-set summary
    GET    /events/<app_id>/one/<event_id>      event | 404
    DELETE /events/<app_id>/one/<event_id>      -> {"ok": bool}

(``?channel_id=`` selects a channel on every /events route.) Event
inserts honor ``X-PIO-Store-Seq`` replay dedupe, and the replicated
tier's peers join via ``--peer``: ``/healthz`` then reports the
replication role and per-peer lag, and failover/repair transitions land
in ``/debug/timeline.json``.

Auth: optional — start with an access key (``--access-key`` or
``PIO_SERVER_ACCESS_KEY``) and every request must carry it
(``Authorization: Bearer <key>`` or ``?accessKey=``), the same
:class:`~predictionio_tpu_torch.serving.config.ServerConfig` contract the
dashboard uses.
"""

from __future__ import annotations

import collections
import datetime as _dt
import hashlib
import json
import threading
import urllib.parse

from predictionio_tpu_torch.data.event import Event, EventValidationError
from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.data.storage.base import (
    Model,
    PartialBatchError,
    StorageError,
)
from predictionio_tpu_torch.data.storage.httpstore import (
    STORE_REPLAY_HEADER,
    STORE_SEQ_HEADER,
    TRI_NULL,
    access_key_from_json,
    access_key_to_json,
    app_from_json,
    app_to_json,
    channel_from_json,
    channel_to_json,
    engine_instance_from_json,
    engine_instance_to_json,
    evaluation_instance_from_json,
    evaluation_instance_to_json,
    manifest_from_json,
    manifest_to_json,
)
from predictionio_tpu_torch.obs import MetricRegistry, get_registry
from predictionio_tpu_torch.obs import timeline as timeline_mod
from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.serving.config import ServerConfig
from predictionio_tpu_torch.serving.http import (
    HTTPError,
    HTTPServer,
    Request,
    Response,
    Router,
    install_metrics_routes,
)


def event_set_checksum(ids) -> str:
    """Order-independent digest of an event-id set: XOR-fold of each
    id's sha256 prefix. Two peers holding the same events report the
    same checksum regardless of insertion order — the cheap equality
    probe anti-entropy runs before deciding to stream a delta."""
    acc = 0
    n = 0
    for event_id in ids:
        digest = hashlib.sha256(event_id.encode()).digest()
        acc ^= int.from_bytes(digest[:8], "big")
        n += 1
    return f"{n}:{acc:016x}"


def _epoch(t: _dt.datetime | None) -> float | None:
    return None if t is None else t.timestamp()


class EventWatermarkCache:
    """Incrementally-maintained per-(app, channel) event-set summary.

    Without it every anti-entropy round is O(total events) on BOTH
    sides — the peer's ``/events/<app>/watermark`` handler and the
    local comparison each stream the full log — and the steady-state
    sync cost grows without bound as the log grows. Here the full log
    is scanned once per coordinate (cold start), after which every
    insert folds into the running XOR checksum (the fold is its own
    inverse, so the digest stays order-independent and matches
    :func:`event_set_checksum` exactly).

    Synchronization rides the server's ingest lock, which already
    serializes every event-log mutation: :meth:`record_insert_locked`
    must be called WITH the lock held (it takes none itself — the lock
    is not reentrant); :meth:`summary` and :meth:`invalidate` acquire
    it. Deletes and log drops invalidate the coordinate — they are
    rare, and the next :meth:`summary` rescans once.

    The entry also keeps the coordinate's ids, each with its creation
    time (:meth:`ids_locked`), so an existence check — a replay's, or
    anti-entropy's — is a lookup, and ``GET /events/<app>/ids`` hands a
    peer the list to diff against its own. The JAX package makes a point
    read there, and on the event log each point read is a scan of the
    whole log (ROADMAP.md §3).
    """

    def __init__(self, ingest_lock: threading.Lock):
        self._lock = ingest_lock
        self._entries: dict[tuple[int, int | None], dict] = {}

    @staticmethod
    def _fold(event_id: str) -> int:
        digest = hashlib.sha256(event_id.encode()).digest()
        return int.from_bytes(digest[:8], "big")

    def record_insert_locked(
        self, app_id: int, channel_id: int | None, event: Event
    ) -> None:
        """Fold one freshly-inserted event in. Caller holds the ingest
        lock (the same critical section as the DAO insert, so the scan
        in :meth:`summary` can never interleave and double-count)."""
        entry = self._entries.get((app_id, channel_id))
        if entry is None:
            return  # cold coordinate: the next summary() scan sees it
        entry["acc"] ^= self._fold(event.event_id)
        entry["count"] += 1
        ct = event.creation_time
        entry["ids"][event.event_id] = _epoch(ct)
        if ct is not None and (
            entry["latest"] is None or ct > entry["latest"]
        ):
            entry["latest"] = ct
            entry["latest_id"] = event.event_id

    def invalidate(self, app_id: int, channel_id: int | None) -> None:
        with self._lock:
            self.invalidate_locked(app_id, channel_id)

    def invalidate_locked(
        self, app_id: int, channel_id: int | None
    ) -> None:
        """:meth:`invalidate` for a caller that holds the ingest lock."""
        self._entries.pop((app_id, channel_id), None)

    def _entry_locked(self, app_id: int, channel_id: int | None, dao):
        entry = self._entries.get((app_id, channel_id))
        if entry is None:
            entry = {
                "acc": 0, "count": 0, "latest": None, "latest_id": None,
                "ids": {},
            }
            for e in dao.find(app_id, channel_id):
                entry["acc"] ^= self._fold(e.event_id)
                entry["count"] += 1
                entry["ids"][e.event_id] = _epoch(e.creation_time)
                if (
                    entry["latest"] is None
                    or e.creation_time > entry["latest"]
                ):
                    entry["latest"] = e.creation_time
                    entry["latest_id"] = e.event_id
            self._entries[(app_id, channel_id)] = entry
        return entry

    def ids_locked(self, app_id: int, channel_id: int | None, dao) -> dict:
        """The coordinate's event ids, each mapped to its creation time
        (epoch seconds); the caller holds the ingest lock (and must not
        change the dict). A cold coordinate is scanned once."""
        return self._entry_locked(app_id, channel_id, dao)["ids"]

    def summary(self, app_id: int, channel_id: int | None, dao) -> dict:
        """The coordinate's summary: ``count``, ``checksum``,
        ``latest`` (creation-time datetime | None), ``latestId``.
        Rebuilds from a full scan only when the coordinate is cold or
        was invalidated."""
        with self._lock:
            entry = self._entry_locked(app_id, channel_id, dao)
            return {
                "count": entry["count"],
                "checksum": f"{entry['count']}:{entry['acc']:016x}",
                "latest": entry["latest"],
                "latestId": entry["latest_id"],
            }


class StoreServer:
    """Key auth and TLS are server-level concerns: ``create_store_server``
    hands the :class:`ServerConfig` to :class:`HTTPServer`, which
    enforces the key on every route before dispatch."""

    def __init__(
        self,
        storage: Storage | None = None,
        registry: MetricRegistry | None = None,
        tracer: tracing.Tracer | None = None,
    ):
        self._storage = storage or get_storage()
        self.registry = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else tracing.get_tracer()
        self.timeline = timeline_mod.Timeline(registry=self.registry)
        timeline_mod.set_timeline(self.timeline)
        #: X-PIO-Store-Seq replay dedupe: writer -> (max_seq, window of
        #: seq -> (status, body)). A writer id is shared by every thread
        #: of one client process, so commits interleave: a torn seq-5
        #: retry can arrive after seq 6 committed, and a single
        #: last-seq slot would wave it through as "new". The window
        #: remembers recent responses per writer; anything at or below
        #: the high-water mark that misses the window falls back to the
        #: id-existence check. Bounded LRU on both axes so writer churn
        #: cannot grow it.
        self._seq_cache: collections.OrderedDict[
            str,
            tuple[int, collections.OrderedDict[int, tuple[int, object]]],
        ] = collections.OrderedDict()
        self._seq_lock = threading.Lock()
        #: serializes existence-check + append on the event routes with
        #: the anti-entropy pull — both are check-then-insert against an
        #: append-only log, and interleaving them lands duplicate
        #: records no repair pass can ever remove
        self.ingest_lock = threading.Lock()
        #: incremental per-(app, channel) watermark summaries, shared
        #: with the anti-entropy loop so steady-state sync rounds stay
        #: O(delta) instead of O(total events)
        self.watermarks = EventWatermarkCache(self.ingest_lock)
        #: set by create_store_server when --peer URLs are given; the
        #: /healthz payload and anti-entropy loop hang off it
        self.replication = None
        s = self._storage
        #: <kind> -> (dao getter, to_json, from_json, id parser);
        #: getters defer DAO construction to request time
        self._kinds = {
            "apps": (
                s.get_meta_data_apps, app_to_json, app_from_json, int
            ),
            "access_keys": (
                s.get_meta_data_access_keys,
                access_key_to_json,
                access_key_from_json,
                str,
            ),
            "channels": (
                s.get_meta_data_channels,
                channel_to_json,
                channel_from_json,
                int,
            ),
            "engine_instances": (
                s.get_meta_data_engine_instances,
                engine_instance_to_json,
                engine_instance_from_json,
                str,
            ),
            "evaluation_instances": (
                s.get_meta_data_evaluation_instances,
                evaluation_instance_to_json,
                evaluation_instance_from_json,
                str,
            ),
            "engine_manifests": (
                s.get_meta_data_engine_manifests,
                manifest_to_json,
                manifest_from_json,
                str,
            ),
        }
        self.router = Router()
        r = self.router
        install_metrics_routes(
            r, self.registry, self.tracer, timeline=self.timeline
        )
        r.healthz_extra = self._healthz_extra
        r.route("GET", "/", self._status)
        # events: fixed-tail routes before the parameterized ones so
        # ".../batch" and ".../watermark" never bind as an id
        r.route("POST", "/events/<app_id>/batch", self._event_batch)
        r.route("GET", "/events/<app_id>/watermark", self._event_watermark)
        r.route("GET", "/events/<app_id>/ids", self._event_ids)
        r.route("POST", "/events/<app_id>/pull", self._event_pull)
        r.route("GET", "/events/<app_id>/one/<event_id>", self._event_get)
        r.route("DELETE", "/events/<app_id>/one/<event_id>",
                self._event_delete)
        r.route("PUT", "/events/<app_id>", self._event_init)
        r.route("DELETE", "/events/<app_id>", self._event_remove)
        r.route("POST", "/events/<app_id>", self._event_insert)
        r.route("GET", "/events/<app_id>", self._event_find)
        r.route("GET", "/models", self._model_list)
        r.route("GET", "/meta/engine_manifests/<id>/<version>",
                self._manifest_get)
        r.route("PUT", "/meta/engine_manifests/<id>/<version>",
                self._manifest_update)
        r.route("DELETE", "/meta/engine_manifests/<id>/<version>",
                self._manifest_delete)
        for method, pattern, handler in (
            ("POST", "/meta/<kind>", self._insert),
            ("GET", "/meta/<kind>", self._list),
            ("GET", "/meta/<kind>/<id>", self._get),
            ("PUT", "/meta/<kind>/<id>", self._update),
            ("DELETE", "/meta/<kind>/<id>", self._delete),
        ):
            r.route(method, pattern, handler)
        r.route("PUT", "/models/<id>", self._model_put)
        r.route("GET", "/models/<id>", self._model_get)
        r.route("DELETE", "/models/<id>", self._model_delete)

    # -- plumbing ---------------------------------------------------------

    def _kind(self, request: Request):
        """Resolve <kind> → (dao, to_json, from_json, id-parser)."""
        kind = request.path_params["kind"]
        if kind not in self._kinds:
            raise HTTPError(404, f"unknown metadata kind {kind!r}")
        getter, to_json, from_json, id_parse = self._kinds[kind]
        try:
            dao = getter()
        except StorageError as e:
            raise HTTPError(500, str(e)) from e
        return kind, dao, to_json, from_json, id_parse

    @staticmethod
    def _parse_id(id_parse, raw: str):
        try:
            return id_parse(urllib.parse.unquote(raw))
        except ValueError as e:
            raise HTTPError(400, f"bad id {raw!r}") from e

    @staticmethod
    def _reject_manifest_single_key(kind: str) -> None:
        """Engine manifests are keyed by (id, version); the single-id
        routes would call their DAO with the wrong arity."""
        if kind == "engine_manifests":
            raise HTTPError(
                400,
                "engine_manifests is keyed by (id, version); use "
                "/meta/engine_manifests/<id>/<version>",
            )

    def _healthz_extra(self) -> dict:
        if self.replication is None:
            return {}
        return {"replication": self.replication.status()}

    # -- X-PIO-Store-Seq replay dedupe ------------------------------------

    @staticmethod
    def _parse_seq(raw: str) -> tuple[str, int] | None:
        writer, sep, seq = raw.rpartition(":")
        if not sep or not writer:
            return None
        try:
            return writer, int(seq)
        except ValueError:
            return None

    _SEQ_CACHE_MAX = 1024  # writers remembered
    _SEQ_WINDOW = 128  # responses remembered per writer

    def _seq_replay(self, request: Request):
        """Returns (token, cached Response | None, writer_known). A
        replay of a recently-committed sequence answers from the
        per-writer response window without touching the backend — the
        append-only eventlog would otherwise record the event twice.
        ``writer_known=False`` tells the insert path to fall back to an
        id-existence check; it is forced whenever the fast path cannot
        PROVE first contact:

        * cold cache — first write from this writer since the server
          started;
        * ``seq <= max_seq`` but outside the response window — the
          writer id is shared across client threads, so a torn seq-5
          retry can arrive after seq 6 committed (or after its own
          slot was evicted) and must not skip the id check;
        * ``X-PIO-Store-Replay`` — hinted-handoff replays arrive AFTER
          anti-entropy may have pulled the same events from a sibling,
          so even a fresh seq proves nothing for them.

        Only ``seq > max_seq`` without the replay marker (a send this
        server provably never committed) takes the fast path."""
        replay = bool(request.headers.get(STORE_REPLAY_HEADER))
        raw = (request.headers.get(STORE_SEQ_HEADER) or "").strip()
        if not raw:
            return None, None, not replay
        token = self._parse_seq(raw)
        if token is None:
            raise HTTPError(
                400, f"bad {STORE_SEQ_HEADER} {raw!r}; want <writer>:<seq>"
            )
        writer, seq = token
        with self._seq_lock:
            hit = self._seq_cache.get(writer)
            if hit is not None:
                self._seq_cache.move_to_end(writer)
                max_seq, window = hit
                slot = window.get(seq)
                if slot is not None:
                    status, body = slot
                    return token, Response(status, body), True
                if seq <= max_seq:
                    return token, None, False
                return token, None, not replay
        return token, None, False

    def _seq_commit(self, token, status: int, body) -> None:
        if token is None:
            return
        writer, seq = token
        with self._seq_lock:
            hit = self._seq_cache.get(writer)
            if hit is None:
                max_seq = seq
                window: collections.OrderedDict[int, tuple[int, object]] = (
                    collections.OrderedDict()
                )
            else:
                max_seq, window = hit
                max_seq = max(max_seq, seq)
            window[seq] = (status, body)
            window.move_to_end(seq)
            while len(window) > self._SEQ_WINDOW:
                window.popitem(last=False)
            self._seq_cache[writer] = (max_seq, window)
            self._seq_cache.move_to_end(writer)
            while len(self._seq_cache) > self._SEQ_CACHE_MAX:
                self._seq_cache.popitem(last=False)

    # -- routes -----------------------------------------------------------

    def _status(self, request: Request) -> Response:
        return Response(200, {"status": "alive", "service": "storeserver"})

    def _insert(self, request: Request) -> Response:
        kind, dao, _to_json, from_json, _ = self._kind(request)
        body = request.json()
        if not isinstance(body, dict):
            raise HTTPError(400, "record JSON object required")
        try:
            record = from_json(body)
        except (KeyError, TypeError, ValueError) as e:
            raise HTTPError(400, f"bad {kind} record: {e}") from e
        with tracing.span(f"dao/{kind}.insert"):
            out = dao.insert(record)
        # insert contracts differ by DAO: apps/channels → id|None on
        # conflict; access_keys → key|None; instances → id; manifests →
        # None (keyed by the record itself). Normalize to {"id": ...}.
        return Response(201, {"id": out})

    def _list(self, request: Request) -> Response:
        kind, dao, to_json, _f, _ = self._kind(request)
        q = request.query
        with tracing.span(f"dao/{kind}.list"):
            return self._list_inner(kind, dao, to_json, q)

    def _list_inner(self, kind, dao, to_json, q) -> Response:
        if kind == "apps" and "name" in q:
            app = dao.get_by_name(q["name"])
            return Response(200, [to_json(app)] if app else [])
        if kind in ("access_keys", "channels") and "app_id" in q:
            try:
                app_id = int(q["app_id"])
            except ValueError as e:
                raise HTTPError(400, "app_id must be an int") from e
            return Response(
                200, [to_json(r) for r in dao.get_by_app_id(app_id)]
            )
        if kind == "engine_instances" and q.get("completed"):
            key = (
                q.get("engine_id", ""),
                q.get("engine_version", ""),
                q.get("engine_variant", ""),
            )
            if q.get("latest") not in (None, "0"):
                latest = dao.get_latest_completed(*key)
                return Response(200, [to_json(latest)] if latest else [])
            return Response(
                200, [to_json(r) for r in dao.get_completed(*key)]
            )
        if kind == "evaluation_instances" and q.get("completed"):
            return Response(200, [to_json(r) for r in dao.get_completed()])
        return Response(200, [to_json(r) for r in dao.get_all()])

    def _get(self, request: Request) -> Response:
        kind, dao, to_json, _f, id_parse = self._kind(request)
        self._reject_manifest_single_key(kind)
        with tracing.span(f"dao/{kind}.get"):
            record = dao.get(
                self._parse_id(id_parse, request.path_params["id"])
            )
        if record is None:
            raise HTTPError(404, "not found")
        return Response(200, to_json(record))

    def _update(self, request: Request) -> Response:
        kind, dao, _t, from_json, _ = self._kind(request)
        self._reject_manifest_single_key(kind)
        body = request.json()
        if not isinstance(body, dict):
            raise HTTPError(400, "record JSON object required")
        try:
            record = from_json(body)
        except (KeyError, TypeError, ValueError) as e:
            raise HTTPError(400, f"bad {kind} record: {e}") from e
        with tracing.span(f"dao/{kind}.update"):
            return Response(200, {"ok": bool(dao.update(record))})

    def _delete(self, request: Request) -> Response:
        kind, dao, _t, _f, id_parse = self._kind(request)
        self._reject_manifest_single_key(kind)
        with tracing.span(f"dao/{kind}.delete"):
            ok = dao.delete(
                self._parse_id(id_parse, request.path_params["id"])
            )
        return Response(200, {"ok": bool(ok)})

    # -- engine manifests (two-part key) ----------------------------------

    def _manifests(self):
        try:
            return self._storage.get_meta_data_engine_manifests()
        except StorageError as e:
            raise HTTPError(500, str(e)) from e

    def _manifest_get(self, request: Request) -> Response:
        m = self._manifests().get(
            urllib.parse.unquote(request.path_params["id"]),
            urllib.parse.unquote(request.path_params["version"]),
        )
        if m is None:
            raise HTTPError(404, "not found")
        return Response(200, manifest_to_json(m))

    def _manifest_update(self, request: Request) -> Response:
        body = request.json()
        if not isinstance(body, dict):
            raise HTTPError(400, "record JSON object required")
        try:
            manifest = manifest_from_json(body)
        except (KeyError, TypeError, ValueError) as e:
            raise HTTPError(400, f"bad manifest record: {e}") from e
        upsert = request.query.get("upsert") not in (None, "0")
        try:
            self._manifests().update(manifest, upsert=upsert)
        except KeyError as e:
            # non-upsert update of a missing manifest: a contract error
            # the client re-raises as KeyError
            raise HTTPError(404, str(e)) from e
        return Response(200, {"ok": True})

    def _manifest_delete(self, request: Request) -> Response:
        ok = self._manifests().delete(
            urllib.parse.unquote(request.path_params["id"]),
            urllib.parse.unquote(request.path_params["version"]),
        )
        return Response(200, {"ok": bool(ok)})

    # -- model blobs ------------------------------------------------------

    def _models(self):
        try:
            return self._storage.get_model_data_models()
        except StorageError as e:
            raise HTTPError(500, str(e)) from e

    def _model_put(self, request: Request) -> Response:
        model_id = urllib.parse.unquote(request.path_params["id"])
        claimed = (request.headers.get("X-PIO-SHA256") or "").strip().lower()
        if claimed:
            # upload integrity (docs/training.md "Model generations"):
            # verify the digest over the bytes that actually arrived —
            # a transit flip or truncation is refused, never stored
            import hashlib

            actual = hashlib.sha256(request.body).hexdigest()
            if actual != claimed:
                raise HTTPError(
                    422,
                    f"model upload integrity failure: received sha256 "
                    f"{actual[:12]}… != claimed {claimed[:12]}…",
                )
        with tracing.span("dao/models.insert", bytes=len(request.body)):
            self._models().insert(Model(id=model_id, models=request.body))
        return Response(201, {"id": model_id})

    def _model_get(self, request: Request) -> Response:
        model_id = urllib.parse.unquote(request.path_params["id"])
        with tracing.span("dao/models.get"):
            model = self._models().get(model_id)
        if model is None:
            raise HTTPError(404, "not found")
        return Response(
            200, model.models, content_type="application/octet-stream"
        )

    def _model_delete(self, request: Request) -> Response:
        model_id = urllib.parse.unquote(request.path_params["id"])
        return Response(200, {"ok": bool(self._models().delete(model_id))})

    def _model_list(self, request: Request) -> Response:
        with tracing.span("dao/models.list_ids"):
            ids = self._models().list_ids()
        if ids is None:
            # backend without enumeration: anti-entropy skips the
            # model-repair pass rather than failing the peer
            raise HTTPError(501, "model backend cannot enumerate ids")
        return Response(200, {"ids": ids})

    # -- events -----------------------------------------------------------

    def _events(self):
        try:
            return self._storage.get_events()
        except StorageError as e:
            raise HTTPError(500, str(e)) from e

    @staticmethod
    def _event_coords(request: Request) -> tuple[int, int | None]:
        try:
            app_id = int(request.path_params["app_id"])
        except ValueError as e:
            raise HTTPError(400, "app_id must be an int") from e
        chan_raw = request.query.get("channel_id")
        if chan_raw in (None, ""):
            return app_id, None
        try:
            return app_id, int(chan_raw)
        except ValueError as e:
            raise HTTPError(400, "channel_id must be an int") from e

    def _event_init(self, request: Request) -> Response:
        app_id, channel_id = self._event_coords(request)
        with tracing.span("dao/events.init"):
            ok = self._events().init(app_id, channel_id)
        self.watermarks.invalidate(app_id, channel_id)
        return Response(200, {"ok": bool(ok)})

    def _event_remove(self, request: Request) -> Response:
        app_id, channel_id = self._event_coords(request)
        with tracing.span("dao/events.remove"):
            ok = self._events().remove(app_id, channel_id)
        self.watermarks.invalidate(app_id, channel_id)
        return Response(200, {"ok": bool(ok)})

    @staticmethod
    def _parse_event(d) -> Event:
        if not isinstance(d, dict):
            raise HTTPError(400, "event JSON object required")
        try:
            # stamp missing ids HERE so the response (and the seq
            # cache) can report concrete ids the client may replay
            return Event.from_json_dict(d).with_id(d.get("eventId"))
        except EventValidationError as e:
            raise HTTPError(400, f"bad event: {e}") from e

    def _event_insert(self, request: Request) -> Response:
        app_id, channel_id = self._event_coords(request)
        token, cached, writer_known = self._seq_replay(request)
        if cached is not None:
            return cached
        event = self._parse_event(request.json())
        dao = self._events()
        with self.ingest_lock:
            if not writer_known and event.event_id in (
                self.watermarks.ids_locked(app_id, channel_id, dao)
            ):
                # cold-cache replay (writer's first contact since this
                # server started): the id is already durable here
                self._seq_commit(token, 201, {"id": event.event_id})
                return Response(201, {"id": event.event_id})
            with tracing.span("dao/events.insert"):
                event_id = dao.insert(event, app_id, channel_id)
            self.watermarks.record_insert_locked(app_id, channel_id, event)
        self._seq_commit(token, 201, {"id": event_id})
        return Response(201, {"id": event_id})

    def _event_batch(self, request: Request) -> Response:
        app_id, channel_id = self._event_coords(request)
        token, cached, writer_known = self._seq_replay(request)
        if cached is not None:
            return cached
        body = request.json()
        if not isinstance(body, list):
            raise HTTPError(400, "event JSON array required")
        events = [self._parse_event(d) for d in body]
        all_ids = [e.event_id for e in events]
        dao = self._events()
        try:
            with self.ingest_lock:
                if not writer_known:
                    # cold-cache replay window: skip events already
                    # durable so the append-only eventlog never records
                    # one twice (the response still acks the FULL batch
                    # — they are all here)
                    have = self.watermarks.ids_locked(
                        app_id, channel_id, dao
                    )
                    events = [e for e in events if e.event_id not in have]
                with tracing.span(
                    "dao/events.insert_batch", n=len(events)
                ):
                    if events:
                        dao.insert_batch(events, app_id, channel_id)
                for ev in events:
                    self.watermarks.record_insert_locked(
                        app_id, channel_id, ev
                    )
        except PartialBatchError as e:
            # an unknown prefix of the batch landed: rescan on the
            # next watermark read rather than guess
            self.watermarks.invalidate(app_id, channel_id)
            # durable-prefix report on 409: a 5xx would be consumed by
            # the client transport before the prefix could be read.
            # Ids skipped as already-durable count as inserted.
            remaining = {ev.event_id for ev in events}
            durable = [i for i in all_ids if i not in remaining]
            durable.extend(e.inserted_ids)
            payload = {"error": str(e), "insertedIds": durable}
            self._seq_commit(token, 409, payload)
            return Response(409, payload)
        self._seq_commit(token, 201, {"ids": all_ids})
        return Response(201, {"ids": all_ids})

    def _event_find(self, request: Request) -> Response:
        app_id, channel_id = self._event_coords(request)
        q = request.query

        def _time(key: str) -> _dt.datetime | None:
            raw = q.get(key)
            if raw in (None, ""):
                return None
            try:
                return _dt.datetime.fromisoformat(raw)
            except ValueError as e:
                raise HTTPError(400, f"{key} not ISO-8601: {raw!r}") from e

        def _tri(key: str):
            raw = q.get(key)
            if raw is None:
                return ...
            return None if raw == TRI_NULL else raw

        event_names = None
        if q.get("event_names") not in (None, ""):
            try:
                event_names = json.loads(q["event_names"])
            except ValueError as e:
                raise HTTPError(
                    400, "event_names must be a JSON array"
                ) from e
        limit = None
        if q.get("limit") not in (None, ""):
            try:
                limit = int(q["limit"])
            except ValueError as e:
                raise HTTPError(400, "limit must be an int") from e
        with tracing.span("dao/events.find"):
            out = [
                e.to_json_dict()
                for e in self._events().find(
                    app_id,
                    channel_id,
                    start_time=_time("start_time"),
                    until_time=_time("until_time"),
                    entity_type=q.get("entity_type"),
                    entity_id=q.get("entity_id"),
                    event_names=event_names,
                    target_entity_type=_tri("target_entity_type"),
                    target_entity_id=_tri("target_entity_id"),
                    limit=limit,
                    reversed=q.get("reversed") not in (None, "", "0"),
                )
            ]
        return Response(200, out)

    def _event_watermark(self, request: Request) -> Response:
        app_id, channel_id = self._event_coords(request)
        with tracing.span("dao/events.watermark"):
            summary = self.watermarks.summary(
                app_id, channel_id, self._events()
            )
        latest = summary["latest"]
        summary["latest"] = latest.isoformat() if latest else None
        return Response(200, summary)

    def _event_ids(self, request: Request) -> Response:
        """``[[event id, creation epoch seconds], ...]`` of the
        coordinate, from the watermark cache: what a peer's
        anti-entropy diffs against its own ids before it asks for
        events with ``POST .../pull``. The port's addition: a JAX store
        server has neither route, and its peers pull whole logs."""
        app_id, channel_id = self._event_coords(request)
        with tracing.span("dao/events.ids"), self.ingest_lock:
            ids = list(self.watermarks.ids_locked(
                app_id, channel_id, self._events()
            ).items())
        return Response(200, {"ids": ids})

    def _event_pull(self, request: Request) -> Response:
        """The events of the coordinate whose ids the body names
        (``{"ids": [...]}``), in one scan of the log."""
        app_id, channel_id = self._event_coords(request)
        body = request.json()
        wanted = body.get("ids") if isinstance(body, dict) else None
        if not isinstance(wanted, list):
            raise HTTPError(400, "JSON object with an ids list required")
        wanted = {str(i) for i in wanted}
        with tracing.span("dao/events.pull", n=len(wanted)):
            out = [e.to_json_dict()
                   for e in self._events().find(app_id, channel_id)
                   if e.event_id in wanted]
        return Response(200, out)

    def _event_get(self, request: Request) -> Response:
        app_id, channel_id = self._event_coords(request)
        event_id = urllib.parse.unquote(request.path_params["event_id"])
        with tracing.span("dao/events.get"):
            event = self._events().get(event_id, app_id, channel_id)
        if event is None:
            raise HTTPError(404, "not found")
        return Response(200, event.to_json_dict())

    def _event_delete(self, request: Request) -> Response:
        app_id, channel_id = self._event_coords(request)
        event_id = urllib.parse.unquote(request.path_params["event_id"])
        with tracing.span("dao/events.delete"):
            ok = self._events().delete(event_id, app_id, channel_id)
        if ok:
            self.watermarks.invalidate(app_id, channel_id)
        return Response(200, {"ok": bool(ok)})


def create_store_server(
    host: str = "0.0.0.0",
    port: int = 7072,
    storage: Storage | None = None,
    server_config: ServerConfig | None = None,
    registry: MetricRegistry | None = None,
    tracer: tracing.Tracer | None = None,
    peers: list[str] | None = None,
    role: str = "replica",
) -> HTTPServer:
    """The store server on the HTTP tier, key auth and TLS from
    ``server_config``. ``peers`` (replica-set siblings, base URLs) turns
    on the anti-entropy loop: this node periodically compares event
    watermarks, model sets and metadata against each peer and pulls what
    it is missing, so a restarted node converges without operator
    action. ``role`` is reporting only — every node repairs itself;
    quorum placement is the client's job
    (:mod:`predictionio_tpu_torch.data.storage.replicated`)."""
    server = StoreServer(storage, registry=registry, tracer=tracer)
    http = HTTPServer(
        server.router,
        host=host,
        port=port,
        server_config=server_config,
        service="storeserver",
        registry=server.registry,
        tracer=server.tracer,
    )
    if peers:
        from predictionio_tpu_torch.data.storage.replicated import (
            AntiEntropyLoop,
        )

        loop = AntiEntropyLoop(
            storage=server._storage,
            peers=peers,
            role=role,
            registry=server.registry,
            timeline=server.timeline,
            key=(server_config.access_key if server_config else "") or None,
            insert_lock=server.ingest_lock,
            watermarks=server.watermarks,
        )
        server.replication = loop
        loop.start()
        http.add_drain_hook(loop.close)
    #: the app object, reachable from the HTTPServer handle (tests and
    #: the console reuse it for replication status)
    http.store_app = server
    return http
