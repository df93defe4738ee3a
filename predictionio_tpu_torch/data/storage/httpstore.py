"""HTTP store backend — metadata, model blobs and events over the network.

Counterpart of ``predictionio_tpu/data/storage/httpstore.py``, with the
same wire shapes. A storage *service* reached over the network, so the
metadata, model and event repositories can live on a different host
than the trainer, event server, and engine servers (the multi-host
topology's control plane).

The service side is :class:`predictionio_tpu_torch.serving.store_server
.StoreServer` (the console's ``storeserver``), which persists through
any *local* backend (sqlite + localfs by default). This module is the
client: DAO implementations that speak the JSON/HTTP protocol, plus the
record↔JSON codecs shared with the server so the wire shape has a
single definition.

Config keys (``PIO_STORAGE_SOURCES_<NAME>_*``):

* ``URL``  — base URL, e.g. ``http://10.0.0.5:7072`` (required)
* ``KEY``  — access key when the server was started with one
* ``TIMEOUT`` — per-request socket timeout in seconds (default 10)
* ``CACERT`` — CA bundle (PEM path) to trust for ``https`` URLs — the
  self-signed-cert workflow the serving tier documents
* ``VERIFY`` — set to ``false`` to skip https certificate verification
  (dev only)
"""

from __future__ import annotations

import datetime as _dt
import http.client
import json
import ssl
import threading
import urllib.parse
from typing import Any

from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.obs.context import get_request_id
from predictionio_tpu_torch.serving import admission, resilience
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    AccessKeysBackend,
    App,
    AppsBackend,
    Channel,
    ChannelsBackend,
    EngineInstance,
    EngineInstancesBackend,
    EngineManifest,
    EngineManifestsBackend,
    EvaluationInstance,
    EvaluationInstancesBackend,
    EventsBackend,
    Model,
    ModelsBackend,
    PartialBatchError,
    StorageError,
)
from predictionio_tpu_torch.data.storage.sql_common import from_iso, iso

#: write-sequencing header for event inserts: ``<writer-id>:<seq>``.
#: A torn send (connection died after the request left, before the
#: response arrived) is ambiguous for a POST — the server may or may
#: not have committed. A replay carrying the SAME sequence token lets
#: the server answer from its dedupe cache instead of inserting twice,
#: which matters for the append-only eventlog backend where a duplicate
#: id would otherwise land as a second record. Used by the replicated
#: store tier (docs/storage.md "Replication & failover").
STORE_SEQ_HEADER = "X-PIO-Store-Seq"
#: marks a hinted-handoff replay: the server must fall back to an
#: id-existence check even when it already knows the writer — by replay
#: time, anti-entropy may have pulled the same events from a sibling,
#: and the monotonic-seq shortcut alone would append them twice
STORE_REPLAY_HEADER = "X-PIO-Store-Replay"

#: wire encoding for the tri-state target-entity filters
#: (``Option[Option[String]]`` semantics, base.EventsBackend.find):
#: param absent = no filter (Ellipsis), this sentinel = "must be
#: absent" (None), anything else = "must match".
TRI_NULL = "__null__"

# --------------------------------------------------------------------------
# record ↔ JSON codecs (single wire-shape definition, used by both sides)
# --------------------------------------------------------------------------


def app_to_json(a: App) -> dict:
    return {"id": a.id, "name": a.name, "description": a.description}


def app_from_json(d: dict) -> App:
    return App(id=d["id"], name=d["name"], description=d.get("description"))


def access_key_to_json(k: AccessKey) -> dict:
    return {"key": k.key, "appid": k.appid, "events": list(k.events)}


def access_key_from_json(d: dict) -> AccessKey:
    return AccessKey(
        key=d["key"], appid=d["appid"], events=tuple(d.get("events", ()))
    )


def channel_to_json(c: Channel) -> dict:
    return {"id": c.id, "name": c.name, "appid": c.appid}


def channel_from_json(d: dict) -> Channel:
    return Channel(id=d["id"], name=d["name"], appid=d["appid"])


def manifest_to_json(m: EngineManifest) -> dict:
    return {
        "id": m.id,
        "version": m.version,
        "name": m.name,
        "description": m.description,
        "files": list(m.files),
        "engine_factory": m.engine_factory,
    }


def manifest_from_json(d: dict) -> EngineManifest:
    return EngineManifest(
        id=d["id"],
        version=d["version"],
        name=d["name"],
        description=d.get("description"),
        files=tuple(d.get("files", ())),
        engine_factory=d.get("engine_factory", ""),
    )


def engine_instance_to_json(e: EngineInstance) -> dict:
    return {
        "id": e.id,
        "status": e.status,
        "start_time": iso(e.start_time),
        "end_time": iso(e.end_time),
        "engine_id": e.engine_id,
        "engine_version": e.engine_version,
        "engine_variant": e.engine_variant,
        "engine_factory": e.engine_factory,
        "batch": e.batch,
        "env": dict(e.env),
        "mesh_conf": dict(e.mesh_conf),
        "data_source_params": e.data_source_params,
        "preparator_params": e.preparator_params,
        "algorithms_params": e.algorithms_params,
        "serving_params": e.serving_params,
    }


def engine_instance_from_json(d: dict) -> EngineInstance:
    return EngineInstance(
        id=d["id"],
        status=d["status"],
        start_time=from_iso(d["start_time"]),
        end_time=from_iso(d["end_time"]),
        engine_id=d["engine_id"],
        engine_version=d["engine_version"],
        engine_variant=d["engine_variant"],
        engine_factory=d["engine_factory"],
        batch=d.get("batch", ""),
        env=dict(d.get("env", {})),
        mesh_conf=dict(d.get("mesh_conf", {})),
        data_source_params=d.get("data_source_params", "{}"),
        preparator_params=d.get("preparator_params", "{}"),
        algorithms_params=d.get("algorithms_params", "[]"),
        serving_params=d.get("serving_params", "{}"),
    )


def evaluation_instance_to_json(e: EvaluationInstance) -> dict:
    return {
        "id": e.id,
        "status": e.status,
        "start_time": iso(e.start_time),
        "end_time": iso(e.end_time),
        "evaluation_class": e.evaluation_class,
        "engine_params_generator_class": e.engine_params_generator_class,
        "batch": e.batch,
        "env": dict(e.env),
        "evaluator_results": e.evaluator_results,
        "evaluator_results_html": e.evaluator_results_html,
        "evaluator_results_json": e.evaluator_results_json,
    }


def evaluation_instance_from_json(d: dict) -> EvaluationInstance:
    return EvaluationInstance(
        id=d["id"],
        status=d["status"],
        start_time=from_iso(d["start_time"]),
        end_time=from_iso(d["end_time"]),
        evaluation_class=d.get("evaluation_class", ""),
        engine_params_generator_class=d.get(
            "engine_params_generator_class", ""
        ),
        batch=d.get("batch", ""),
        env=dict(d.get("env", {})),
        evaluator_results=d.get("evaluator_results", ""),
        evaluator_results_html=d.get("evaluator_results_html", ""),
        evaluator_results_json=d.get("evaluator_results_json", ""),
    )


def _q(raw) -> str:
    """Percent-encode one path segment (ids may contain '/', '%', …);
    the server unquotes symmetrically."""
    return urllib.parse.quote(str(raw), safe="")


# --------------------------------------------------------------------------
# HTTP client
# --------------------------------------------------------------------------


class StoreCircuitOpen(StorageError, resilience.CircuitOpenError):
    """The store target's breaker is open: fail fast, don't connect.

    Doubly typed on purpose: DAO callers keep their ``StorageError``
    contract, while the HTTP layer's
    :class:`~predictionio_tpu_torch.serving.resilience.CircuitOpenError`
    mapping turns it into a retryable 503 instead of a 500."""

    def __init__(self, target: str):
        StorageError.__init__(
            self,
            f"store server {target} circuit open; "
            "fast-failing without a request",
        )
        self.target = target


class HTTPStoreClient:
    """Keep-alive JSON/HTTP client for one store server.

    One pooled connection per thread (serving and training code hit the
    DAOs from multiple threads); a request on a connection the server
    has since closed is retried once on a fresh socket.

    Resilience (docs/robustness.md): hops forward the caller's
    remaining ``X-PIO-Deadline`` budget (and cap their socket timeout
    by it); idempotent operations (GET/HEAD/PUT/DELETE — every DAO
    write here is a keyed upsert) retry transport errors and 5xx
    responses with jittered exponential backoff inside that budget; and
    the target sits behind a process-wide circuit breaker that
    fast-fails with :class:`StoreCircuitOpen` while the store is known
    to be down.
    """

    def __init__(self, config: dict):
        url = config.get("URL")
        if not url:
            raise StorageError(
                "httpstore source needs PIO_STORAGE_SOURCES_<NAME>_URL "
                "(e.g. http://host:7072)"
            )
        parsed = urllib.parse.urlsplit(url)
        if parsed.scheme not in ("http", "https") or not parsed.hostname:
            raise StorageError(f"httpstore URL not understood: {url!r}")
        self._scheme = parsed.scheme
        self._host = parsed.hostname
        self._port = parsed.port or (443 if parsed.scheme == "https" else 80)
        self._key = config.get("KEY")
        try:
            self._timeout = float(config.get("TIMEOUT", 10))
        except ValueError as e:
            raise StorageError(
                f"httpstore TIMEOUT not a number: {config.get('TIMEOUT')!r}"
            ) from e
        self._ssl_context = None
        if self._scheme == "https":
            cacert = config.get("CACERT")
            try:
                self._ssl_context = ssl.create_default_context(
                    cafile=cacert or None
                )
            except (OSError, ssl.SSLError) as e:
                raise StorageError(
                    f"httpstore CACERT {cacert!r} unusable: {e}"
                ) from e
            if str(config.get("VERIFY", "true")).lower() in (
                "false", "0", "no",
            ):
                self._ssl_context.check_hostname = False
                self._ssl_context.verify_mode = ssl.CERT_NONE
        self._local = threading.local()
        self._target = f"{self._host}:{self._port}"
        self._retry = resilience.RetryPolicy.from_env()
        self._breaker = resilience.get_breaker(self._target)

    def _connection(self) -> tuple[http.client.HTTPConnection, bool]:
        """Returns (connection, reused) — ``reused`` means the socket
        carried an earlier request and may have been idled-out by the
        server since."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            return conn, True
        if self._scheme == "https":
            conn = http.client.HTTPSConnection(
                self._host,
                self._port,
                timeout=self._timeout,
                context=self._ssl_context,
            )
        else:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self._timeout
            )
        self._local.conn = conn
        return conn, False

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            self._local.conn = None

    def request(
        self,
        method: str,
        path: str,
        *,
        params: dict[str, Any] | None = None,
        json_body: Any = None,
        raw_body: bytes | None = None,
        extra_headers: dict[str, str] | None = None,
    ) -> tuple[int, bytes]:
        """One HTTP round trip; returns (status, body bytes)."""
        route = path  # pre-query-string, for bounded span cardinality
        if params:
            qs = urllib.parse.urlencode(
                {k: v for k, v in params.items() if v is not None}
            )
            if qs:
                path = f"{path}?{qs}"
        headers = dict(extra_headers or {})
        if self._key:
            headers["Authorization"] = f"Bearer {self._key}"
        # the caller's request ID rides every store hop (even with
        # tracing off) so event-server → store-server logs correlate;
        # with a span open, the hop also joins the distributed trace
        rid = get_request_id()
        if rid:
            headers["X-Request-ID"] = rid
        criticality = admission.get_criticality()
        if criticality != admission.DEFAULT:
            # propagated like the deadline: the store hop sheds by the
            # ORIGINATING request's class under overload
            headers[admission.CRITICALITY_HEADER] = criticality
        if json_body is not None:
            body = json.dumps(json_body).encode("utf-8")
            headers["Content-Type"] = "application/json"
        elif raw_body is not None:
            body = raw_body
            headers["Content-Type"] = "application/octet-stream"
        else:
            body = None
        with tracing.span(
            f"httpstore {method} {route}", host=self._host
        ) as span:
            if span is not None:
                headers[tracing.PARENT_SPAN_HEADER] = span.span_id
            return self._roundtrip(method, path, body, headers, span)

    def _roundtrip(
        self, method, path, body, headers, span
    ) -> tuple[int, bytes]:
        idempotent = method in resilience.IDEMPOTENT_METHODS
        deadline = resilience.get_deadline()
        attempt = 0  # budgeted (backed-off) retries consumed
        stale_replayed = False
        while True:
            if deadline is not None and deadline.expired:
                raise resilience.DeadlineExceeded(
                    f"deadline expired before store hop {method} {path}"
                )
            breaker_state = self._breaker.state
            if span is not None and breaker_state != resilience.CLOSED:
                span.set("breaker", breaker_state)
            if not self._breaker.allow():
                raise StoreCircuitOpen(self._target)
            if deadline is not None:
                # the hop forwards what is LEFT of the budget — retries
                # carry smaller budgets, and the server's admission
                # check can reject work we would discard anyway
                headers[resilience.DEADLINE_HEADER] = deadline.to_header()
            conn, reused = self._connection()
            # cap the socket wait by the remaining budget (and restore
            # the configured timeout on budget-less requests — the
            # pooled connection outlives any one deadline)
            capped = (
                self._timeout
                if deadline is None
                else deadline.cap(self._timeout)
            )
            conn.timeout = capped
            sent = False
            try:
                # a dead pooled socket raises EBADF right here — inside
                # the try, so it takes the same stale-replay path as a
                # send-phase failure
                if conn.sock is not None:
                    conn.sock.settimeout(capped)
                conn.request(method, path, body=body, headers=headers)
                sent = True
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException) as e:
                self._drop_connection()
                # Stale keep-alive replay (free — the server cannot
                # have acted): a send-phase failure on a reused socket
                # (the request never arrived whole, any method), or a
                # response-phase disconnect/reset/garbage on a reused
                # socket for an *idempotent* method — the classic
                # first-request-after-server-restart race. After a
                # completed send, a bare disconnect is ambiguous for a
                # POST (the server may have committed the insert before
                # dying, and a replay would duplicate the row), so
                # non-idempotent methods surface the error instead.
                stale = reused and (
                    not sent
                    or (
                        idempotent
                        and isinstance(e, (
                            http.client.RemoteDisconnected,
                            http.client.BadStatusLine,
                            ConnectionResetError,
                        ))
                    )
                )
                if stale and not stale_replayed:
                    # no evidence about the target (the request never
                    # arrived whole) — release any half-open probe slot
                    # instead of leaving the breaker wedged half-open
                    self._breaker.release()
                    stale_replayed = True
                    continue
                if deadline is not None and deadline.expired:
                    # budget-starved timeout: OUR clock ran out, which
                    # says nothing about the target's health
                    self._breaker.release()
                    raise resilience.DeadlineExceeded(
                        f"deadline expired during store hop "
                        f"{method} {path}"
                    ) from e
                self._breaker.record_failure()
                # retry only while the breaker stayed closed: when THIS
                # failure tripped it, a backoff sleep followed by
                # "circuit open" would waste the wait and mask the
                # actual transport error
                if (
                    idempotent
                    and self._breaker.state == resilience.CLOSED
                    and self._retry.sleep_before_retry(attempt, deadline)
                ):
                    attempt += 1
                    continue
                raise StorageError(
                    f"store server {self._host}:{self._port} unreachable: "
                    f"{e}"
                ) from e
            if span is not None:
                span.set("status", resp.status)
                if attempt or stale_replayed:
                    span.set(
                        "retries", attempt + (1 if stale_replayed else 0)
                    )
            if resp.status >= 500:
                if resp.status == 504:
                    # the server ANSWERED — refusing our (expired)
                    # budget is the caller's fault, not the target's,
                    # and retrying an exhausted budget is pointless
                    self._breaker.record_success()
                    raise StorageError(
                        f"store server refused expired deadline "
                        f"(HTTP 504): "
                        f"{data[:200].decode('utf-8', 'replace')}"
                    )
                self._breaker.record_failure()
                if (
                    idempotent
                    and self._breaker.state == resilience.CLOSED
                    and self._retry.sleep_before_retry(attempt, deadline)
                ):
                    attempt += 1
                    continue
                raise StorageError(
                    f"store server error HTTP {resp.status}: "
                    f"{data[:200].decode('utf-8', 'replace')}"
                )
            self._breaker.record_success()
            if resp.status in (401, 403):
                raise StorageError(
                    "store server rejected the access key "
                    f"(HTTP {resp.status})"
                )
            return resp.status, data

    def json(
        self,
        method: str,
        path: str,
        *,
        params: dict[str, Any] | None = None,
        json_body: Any = None,
        not_found_ok: bool = False,
    ) -> Any:
        status, data = self.request(
            method, path, params=params, json_body=json_body
        )
        if status == 404 and not_found_ok:
            return None
        if not 200 <= status < 300:
            raise StorageError(
                f"store server: {method} {path} -> HTTP {status}: "
                f"{data[:200].decode('utf-8', 'replace')}"
            )
        return json.loads(data) if data else None

    def close(self) -> None:
        self._drop_connection()


# --------------------------------------------------------------------------
# DAO implementations
# --------------------------------------------------------------------------


class HTTPApps(AppsBackend):
    def __init__(self, client: HTTPStoreClient):
        self._c = client

    def insert(self, app: App) -> int | None:
        out = self._c.json("POST", "/meta/apps", json_body=app_to_json(app))
        return out.get("id")

    def get(self, app_id: int) -> App | None:
        d = self._c.json("GET", f"/meta/apps/{_q(app_id)}", not_found_ok=True)
        return app_from_json(d) if d else None

    def get_by_name(self, name: str) -> App | None:
        if not name:
            # a blank-valued query param would be dropped server-side
            # (parse_qs), turning this into get_all; no app can have an
            # empty name, so answer locally like every other backend
            return None
        out = self._c.json("GET", "/meta/apps", params={"name": name})
        return app_from_json(out[0]) if out else None

    def get_all(self) -> list[App]:
        return [app_from_json(d) for d in self._c.json("GET", "/meta/apps")]

    def update(self, app: App) -> bool:
        out = self._c.json(
            "PUT", f"/meta/apps/{_q(app.id)}", json_body=app_to_json(app)
        )
        return bool(out.get("ok"))

    def delete(self, app_id: int) -> bool:
        out = self._c.json("DELETE", f"/meta/apps/{_q(app_id)}")
        return bool(out.get("ok"))


class HTTPAccessKeys(AccessKeysBackend):
    def __init__(self, client: HTTPStoreClient):
        self._c = client

    def insert(self, access_key: AccessKey) -> str | None:
        out = self._c.json(
            "POST",
            "/meta/access_keys",
            json_body=access_key_to_json(access_key),
        )
        return out.get("id")

    def get(self, key: str) -> AccessKey | None:
        d = self._c.json(
            "GET", f"/meta/access_keys/{_q(key)}", not_found_ok=True
        )
        return access_key_from_json(d) if d else None

    def get_all(self) -> list[AccessKey]:
        return [
            access_key_from_json(d)
            for d in self._c.json("GET", "/meta/access_keys")
        ]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [
            access_key_from_json(d)
            for d in self._c.json(
                "GET", "/meta/access_keys", params={"app_id": app_id}
            )
        ]

    def update(self, access_key: AccessKey) -> bool:
        out = self._c.json(
            "PUT",
            f"/meta/access_keys/{_q(access_key.key)}",
            json_body=access_key_to_json(access_key),
        )
        return bool(out.get("ok"))

    def delete(self, key: str) -> bool:
        out = self._c.json("DELETE", f"/meta/access_keys/{_q(key)}")
        return bool(out.get("ok"))


class HTTPChannels(ChannelsBackend):
    def __init__(self, client: HTTPStoreClient):
        self._c = client

    def insert(self, channel: Channel) -> int | None:
        out = self._c.json(
            "POST", "/meta/channels", json_body=channel_to_json(channel)
        )
        return out.get("id")

    def get(self, channel_id: int) -> Channel | None:
        d = self._c.json(
            "GET", f"/meta/channels/{_q(channel_id)}", not_found_ok=True
        )
        return channel_from_json(d) if d else None

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [
            channel_from_json(d)
            for d in self._c.json(
                "GET", "/meta/channels", params={"app_id": app_id}
            )
        ]

    def delete(self, channel_id: int) -> bool:
        out = self._c.json("DELETE", f"/meta/channels/{_q(channel_id)}")
        return bool(out.get("ok"))


class HTTPEngineManifests(EngineManifestsBackend):
    def __init__(self, client: HTTPStoreClient):
        self._c = client

    def insert(self, manifest: EngineManifest) -> None:
        self._c.json(
            "POST",
            "/meta/engine_manifests",
            json_body=manifest_to_json(manifest),
        )

    def get(self, manifest_id: str, version: str) -> EngineManifest | None:
        d = self._c.json(
            "GET",
            f"/meta/engine_manifests/{_q(manifest_id)}/{_q(version)}",
            not_found_ok=True,
        )
        return manifest_from_json(d) if d else None

    def get_all(self) -> list[EngineManifest]:
        return [
            manifest_from_json(d)
            for d in self._c.json("GET", "/meta/engine_manifests")
        ]

    def update(self, manifest: EngineManifest, upsert: bool = False) -> None:
        status, data = self._c.request(
            "PUT",
            f"/meta/engine_manifests/{_q(manifest.id)}/{_q(manifest.version)}",
            params={"upsert": int(upsert)},
            json_body=manifest_to_json(manifest),
        )
        if status == 404:
            # the server maps the backend's KeyError (non-upsert update
            # of a missing manifest) to 404; restore the contract
            raise KeyError(
                f"engine manifest ({manifest.id}, {manifest.version}) "
                "not found"
            )
        if not 200 <= status < 300:
            raise StorageError(
                f"store server: manifest update -> HTTP {status}: "
                f"{data[:200].decode('utf-8', 'replace')}"
            )

    def delete(self, manifest_id: str, version: str) -> bool:
        out = self._c.json(
            "DELETE", f"/meta/engine_manifests/{_q(manifest_id)}/{_q(version)}"
        )
        return bool(out.get("ok"))


class HTTPEngineInstances(EngineInstancesBackend):
    def __init__(self, client: HTTPStoreClient):
        self._c = client

    def insert(self, instance: EngineInstance) -> str:
        out = self._c.json(
            "POST",
            "/meta/engine_instances",
            json_body=engine_instance_to_json(instance),
        )
        return out["id"]

    def get(self, instance_id: str) -> EngineInstance | None:
        d = self._c.json(
            "GET", f"/meta/engine_instances/{_q(instance_id)}", not_found_ok=True
        )
        return engine_instance_from_json(d) if d else None

    def get_all(self) -> list[EngineInstance]:
        return [
            engine_instance_from_json(d)
            for d in self._c.json("GET", "/meta/engine_instances")
        ]

    def _completed(
        self,
        engine_id: str,
        engine_version: str,
        engine_variant: str,
        latest: bool,
    ):
        return self._c.json(
            "GET",
            "/meta/engine_instances",
            params={
                "engine_id": engine_id,
                "engine_version": engine_version,
                "engine_variant": engine_variant,
                "completed": 1,
                "latest": int(latest),
            },
        )

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        out = self._completed(
            engine_id, engine_version, engine_variant, latest=True
        )
        return engine_instance_from_json(out[0]) if out else None

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        return [
            engine_instance_from_json(d)
            for d in self._completed(
                engine_id, engine_version, engine_variant, latest=False
            )
        ]

    def update(self, instance: EngineInstance) -> bool:
        out = self._c.json(
            "PUT",
            f"/meta/engine_instances/{_q(instance.id)}",
            json_body=engine_instance_to_json(instance),
        )
        return bool(out.get("ok"))

    def delete(self, instance_id: str) -> bool:
        out = self._c.json(
            "DELETE", f"/meta/engine_instances/{_q(instance_id)}"
        )
        return bool(out.get("ok"))


class HTTPEvaluationInstances(EvaluationInstancesBackend):
    def __init__(self, client: HTTPStoreClient):
        self._c = client

    def insert(self, instance: EvaluationInstance) -> str:
        out = self._c.json(
            "POST",
            "/meta/evaluation_instances",
            json_body=evaluation_instance_to_json(instance),
        )
        return out["id"]

    def get(self, instance_id: str) -> EvaluationInstance | None:
        d = self._c.json(
            "GET",
            f"/meta/evaluation_instances/{_q(instance_id)}",
            not_found_ok=True,
        )
        return evaluation_instance_from_json(d) if d else None

    def get_all(self) -> list[EvaluationInstance]:
        return [
            evaluation_instance_from_json(d)
            for d in self._c.json("GET", "/meta/evaluation_instances")
        ]

    def get_completed(self) -> list[EvaluationInstance]:
        return [
            evaluation_instance_from_json(d)
            for d in self._c.json(
                "GET", "/meta/evaluation_instances", params={"completed": 1}
            )
        ]

    def update(self, instance: EvaluationInstance) -> bool:
        out = self._c.json(
            "PUT",
            f"/meta/evaluation_instances/{_q(instance.id)}",
            json_body=evaluation_instance_to_json(instance),
        )
        return bool(out.get("ok"))

    def delete(self, instance_id: str) -> bool:
        out = self._c.json(
            "DELETE", f"/meta/evaluation_instances/{_q(instance_id)}"
        )
        return bool(out.get("ok"))


class HTTPModels(ModelsBackend):
    """Model blob store over HTTP (reference HDFSModels.scala:30-64:
    one opaque file per model id)."""

    def __init__(self, client: HTTPStoreClient):
        self._c = client

    def insert(self, model: Model) -> None:
        # end-to-end upload integrity: the server recomputes the digest
        # over the bytes it RECEIVED and refuses a mismatch with 422, so
        # a bit flipped in transit (or a truncation a proxy papered
        # over) never lands in the store. Read-side integrity is the
        # generation manifest's job (core/persistence.load_generation).
        import hashlib

        status, data = self._c.request(
            "PUT",
            f"/models/{_q(model.id)}",
            raw_body=model.models,
            extra_headers={
                "X-PIO-SHA256": hashlib.sha256(model.models).hexdigest()
            },
        )
        if not 200 <= status < 300:
            raise StorageError(
                f"store server: model put -> HTTP {status}: "
                f"{data[:200].decode('utf-8', 'replace')}"
            )

    def get(self, model_id: str) -> Model | None:
        status, data = self._c.request(
            "GET", f"/models/{_q(model_id)}"
        )
        if status == 404:
            return None
        if not 200 <= status < 300:
            raise StorageError(
                f"store server: model get -> HTTP {status}"
            )
        return Model(id=model_id, models=data)

    def delete(self, model_id: str) -> bool:
        out = self._c.json(
            "DELETE", f"/models/{_q(model_id)}"
        )
        return bool(out.get("ok"))

    def list_ids(self) -> list[str] | None:
        out = self._c.json("GET", "/models")
        ids = (out or {}).get("ids")
        return list(ids) if ids is not None else None


class HTTPEvents(EventsBackend):
    """Event DAO over the store server's ``/events`` routes.

    Completes the httpstore backend family for the replicated tier:
    a ``ReplicatedStore`` peer IS a store server, so event replication
    needs the event DAO to speak the same wire as metadata and models.
    Events are stamped with their UUID *client-side* before the POST —
    the server upserts by id on sqlite/memory and dedupes replays by
    ``X-PIO-Store-Seq`` on the append-only eventlog, so a retried send
    can never double-insert.
    """

    def __init__(self, client: HTTPStoreClient):
        self._c = client

    @staticmethod
    def _chan(channel_id: int | None) -> dict:
        return {} if channel_id is None else {"channel_id": channel_id}

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        out = self._c.json(
            "PUT", f"/events/{_q(app_id)}", params=self._chan(channel_id)
        )
        return bool(out.get("ok"))

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        out = self._c.json(
            "DELETE", f"/events/{_q(app_id)}", params=self._chan(channel_id)
        )
        return bool(out.get("ok"))

    def close(self) -> None:
        self._c.close()

    def _post(
        self,
        path: str,
        params: dict,
        json_body,
        store_seq: str | None,
        replay: bool = False,
    ) -> tuple[int, bytes]:
        headers = {}
        if store_seq:
            headers[STORE_SEQ_HEADER] = store_seq
        if replay:
            headers[STORE_REPLAY_HEADER] = "1"
        return self._c.request(
            "POST",
            path,
            params=params,
            json_body=json_body,
            extra_headers=headers or None,
        )

    def insert(
        self,
        event: Event,
        app_id: int,
        channel_id: int | None = None,
        *,
        store_seq: str | None = None,
        replay: bool = False,
    ) -> str:
        stamped = event.with_id(event.event_id)
        status, data = self._post(
            f"/events/{_q(app_id)}",
            self._chan(channel_id),
            stamped.to_json_dict(),
            store_seq,
            replay,
        )
        if not 200 <= status < 300:
            raise StorageError(
                f"store server: event insert -> HTTP {status}: "
                f"{data[:200].decode('utf-8', 'replace')}"
            )
        out = json.loads(data) if data else {}
        return out.get("id") or stamped.event_id

    def insert_batch(
        self,
        events,
        app_id: int,
        channel_id: int | None = None,
        *,
        store_seq: str | None = None,
        replay: bool = False,
    ) -> list[str]:
        if not events:
            return []
        stamped = [e.with_id(e.event_id) for e in events]
        status, data = self._post(
            f"/events/{_q(app_id)}/batch",
            self._chan(channel_id),
            [e.to_json_dict() for e in stamped],
            store_seq,
            replay,
        )
        out = json.loads(data) if data else {}
        if status == 409 and "insertedIds" in out:
            # the server's durable-prefix report (a PartialBatchError on
            # its backend) rides a 409 — 5xx would be swallowed by the
            # transport layer before the body could be parsed
            raise PartialBatchError(
                out.get("error", "partial batch insert"),
                list(out["insertedIds"]),
            )
        if not 200 <= status < 300:
            raise StorageError(
                f"store server: event batch insert -> HTTP {status}: "
                f"{data[:200].decode('utf-8', 'replace')}"
            )
        return list(out.get("ids") or [e.event_id for e in stamped])

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        d = self._c.json(
            "GET",
            f"/events/{_q(app_id)}/one/{_q(event_id)}",
            params=self._chan(channel_id),
            not_found_ok=True,
        )
        return Event.from_json_dict(d) if d else None

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        out = self._c.json(
            "DELETE",
            f"/events/{_q(app_id)}/one/{_q(event_id)}",
            params=self._chan(channel_id),
        )
        return bool(out.get("ok"))

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names=None,
        target_entity_type=...,
        target_entity_id=...,
        limit: int | None = None,
        reversed: bool = False,
    ):
        params: dict[str, Any] = dict(self._chan(channel_id))
        if start_time is not None:
            params["start_time"] = start_time.isoformat()
        if until_time is not None:
            params["until_time"] = until_time.isoformat()
        if entity_type is not None:
            params["entity_type"] = entity_type
        if entity_id is not None:
            params["entity_id"] = entity_id
        if event_names is not None:
            # JSON-encoded so names containing separators round-trip
            params["event_names"] = json.dumps(list(event_names))
        if target_entity_type is not ...:
            params["target_entity_type"] = (
                TRI_NULL if target_entity_type is None
                else target_entity_type
            )
        if target_entity_id is not ...:
            params["target_entity_id"] = (
                TRI_NULL if target_entity_id is None else target_entity_id
            )
        if limit is not None:
            params["limit"] = limit
        if reversed:
            params["reversed"] = 1
        out = self._c.json(
            "GET", f"/events/{_q(app_id)}", params=params
        )
        for d in out or []:
            yield Event.from_json_dict(d)

    def watermark(
        self, app_id: int, channel_id: int | None = None
    ) -> dict:
        """The server's event-set summary for one (app, channel) —
        ``{"count", "checksum", "latest"}``. Anti-entropy compares the
        order-independent checksum between peers; a mismatch triggers a
        full pull (docs/storage.md "Replication & failover")."""
        return self._c.json(
            "GET",
            f"/events/{_q(app_id)}/watermark",
            params=self._chan(channel_id),
        )
