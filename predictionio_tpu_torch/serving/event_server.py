"""Event server: REST event collection (default port 7070).

Counterpart of ``predictionio_tpu/serving/event_server.py``, with the
same routes, status codes and bodies:

* auth by ``accessKey`` query parameter or HTTP Basic user name, with an
  optional ``channel`` query parameter;
* ``GET  /``                     → alive status
* ``POST /events.json``          → 201 {"eventId"} (the access key's
  event-name whitelist enforced)
* ``GET  /events.json``          → filtered query (every filter, ``limit``,
  ``reversed``; ``targetEntity*=none`` means "must be absent")
* ``GET/DELETE /events/<id>.json``
* ``POST /batch/events.json``    → at most 50 events, a status per event
* ``GET  /stats.json``           → hourly counters (``stats=True``)
* ``POST /webhooks/<name>.json`` / ``.form`` → connector-mapped events
* ``GET  /webhooks/<name>.json`` / ``.form`` → connector probe, 200 / 404
* ``GET  /plugins.json``, ``/plugins/inputsniffer/<name>/<path>``
* ``GET  /metrics``, ``/metrics.json``, ``/debug/traces``,
  ``/debug/traces.json``, ``/debug/timeline.json`` (the process-global
  timeline)

Every event-API answer is counted into the ``registry`` (default: the
process registry) as ``pio_events_ingested_total{app_id,status}``, and
each store call is a ``store/*`` span of the request's trace.

The adaptive admission controller is on by default (``admission=True``,
``PIO_ADMISSION``), with fair shares keyed by the ``accessKey``, so one
hot app cannot starve the others' ingest; the HTTP tier adds deadlines,
the drain, ``PIO_CHAOS`` and SLO scoring.

``server_config`` (default: the environment's ``ServerConfig``) gives
the server TLS and key-auths its ``/debug`` routes; the event API keeps
its own per-app access keys, so the server key is never asked of it.

``reuse_port`` lets ``eventserver --workers N`` bind N processes to one
port. When the storage has a ``replicated`` source, ``/healthz`` carries
its client's quorum view under ``replication``.
"""

from __future__ import annotations

import base64
import datetime as _dt
import logging
import os
from typing import Callable

from predictionio_tpu_torch.data.event import Event, EventValidationError
from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.data.storage.base import PartialBatchError
from predictionio_tpu_torch.obs import MetricRegistry, get_registry
from predictionio_tpu_torch.obs import timeline as timeline_mod
from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.serving import admission as admission_mod
from predictionio_tpu_torch.serving.http import (
    HTTPError,
    HTTPServer,
    Request,
    Response,
    Router,
    install_metrics_routes,
)
from predictionio_tpu_torch.serving.plugins import (
    INPUT_SNIFFER,
    PluginContext,
    PluginRejection,
    install_plugin_routes,
)
from predictionio_tpu_torch.serving.stats import Stats
from predictionio_tpu_torch.serving.webhooks import (
    FORM_CONNECTORS,
    JSON_CONNECTORS,
    ConnectorError,
)

logger = logging.getLogger(__name__)

MAX_BATCH_SIZE = 50

#: input blocker: raise to reject an event before storage
InputBlocker = Callable[[Event, int, int | None], None]


class EventServer:
    def __init__(
        self,
        storage: Storage | None = None,
        stats: bool = False,
        input_blockers: list[InputBlocker] | None = None,
        plugins: PluginContext | None = None,
        registry: MetricRegistry | None = None,
        tracer: tracing.Tracer | None = None,
        server_config=None,
        admission: bool | admission_mod.AdmissionController = True,
    ):
        """``server_config`` key-auths the ``/debug`` routes; the event
        API itself stays on per-app access keys.

        ``admission`` turns on the adaptive overload controller; its
        fair shares are keyed by the ``accessKey`` query parameter."""
        self._storage = storage or get_storage()
        self.registry = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else tracing.get_tracer()
        # the hourly /stats.json view stays opt-in; the registry is fed
        # in _count (not inside Stats) so nothing double-counts
        self._stats = Stats() if stats else None
        self._ingested = self.registry.counter(
            "pio_events_ingested_total",
            "Event-API requests by app and response status",
            ("app_id", "status"),
        )
        self._input_blockers = list(input_blockers or [])
        self._plugins = plugins or PluginContext()
        self.router = Router()
        r = self.router
        install_metrics_routes(
            r, self.registry, self.tracer, server_config=server_config,
            # the process-global ring (not a private one): the
            # replicated-store client emits failover / hinted-handoff
            # events there, and /debug/timeline.json is where operators
            # go to see them
            timeline=timeline_mod.get_timeline(),
        )
        r.healthz_extra = self._healthz_extra
        r.route("GET", "/", self._status)
        r.route("POST", "/events.json", self._create_event)
        r.route("GET", "/events.json", self._find_events)
        r.route("GET", "/events/<event_id>.json", self._get_event)
        r.route("DELETE", "/events/<event_id>.json", self._delete_event)
        r.route("POST", "/batch/events.json", self._batch)
        r.route("GET", "/stats.json", self._stats_route)
        r.route("POST", "/webhooks/<name>.json", self._webhook_json)
        r.route("POST", "/webhooks/<name>.form", self._webhook_form)
        r.route("GET", "/webhooks/<name>.json", self._webhook_json_probe)
        r.route("GET", "/webhooks/<name>.form", self._webhook_form_probe)
        install_plugin_routes(r, self._plugins, INPUT_SNIFFER)
        if admission is True:
            r.admission = admission_mod.AdmissionController.from_env(
                "eventserver", registry=self.registry
            )
        elif isinstance(admission, admission_mod.AdmissionController):
            r.admission = admission

    # -- auth -------------------------------------------------------------
    def _auth(self, request: Request) -> tuple[int, int | None, tuple]:
        key = request.query.get("accessKey")
        if key is None:
            auth = request.headers.get("Authorization", "")
            if auth.startswith("Basic "):
                try:
                    decoded = base64.b64decode(auth[6:]).decode()
                    key = decoded.split(":", 1)[0]
                except ValueError:  # bad base64 or not UTF-8
                    key = None
        if not key:
            raise HTTPError(401, "Missing accessKey.")
        with tracing.span("store/get_access_key"):
            access_key = self._storage.get_meta_data_access_keys().get(key)
        if access_key is None:
            raise HTTPError(401, "Invalid accessKey.")
        channel_id = None
        channel_name = request.query.get("channel")
        if channel_name is not None:
            channels = self._storage.get_meta_data_channels().get_by_app_id(
                access_key.appid
            )
            match = next(
                (c for c in channels if c.name == channel_name), None
            )
            if match is None:
                raise HTTPError(400, "Invalid channel.")
            channel_id = match.id
        return access_key.appid, channel_id, tuple(access_key.events)

    def _count(
        self, app_id: int, status: int, event: Event | None = None
    ) -> None:
        """One ingest observation: always into the registry
        (``pio_events_ingested_total``), and into the hourly
        ``/stats.json`` view when ``stats`` is on."""
        self._ingested.labels(str(app_id), str(status)).inc()
        if self._stats:
            self._stats.update(app_id, status, event)

    # -- routes -----------------------------------------------------------
    def _status(self, request: Request) -> Response:
        # pid: which process answered (the JAX package's multi-worker
        # servers need it; kept so both packages answer alike)
        return Response(200, {"status": "alive", "pid": os.getpid()})

    def _healthz_extra(self) -> dict:
        """When ingest goes through a replicated store set, surface the
        client-side quorum view (per-peer breaker state, hint depth) in
        /healthz beside the admission fields."""
        from predictionio_tpu_torch.data.storage.replicated import (
            replication_status,
        )

        status = replication_status(self._storage)
        return {"replication": status} if status else {}

    def _validate(
        self, event: Event, app_id: int, channel_id, whitelist
    ) -> dict | None:
        """Everything that can reject an event, without storing it.
        Returns the event's JSON form when plugins are registered (the
        caller passes it to the sniffers after the store)."""
        if whitelist and event.event not in whitelist:
            raise HTTPError(
                403, f"{event.event} events are not allowed"
            )
        for blocker in self._input_blockers:
            blocker(event, app_id, channel_id)
        # only pay the JSON build when plugins are registered
        event_json = (
            event.to_json_dict() if self._plugins.plugins else None
        )
        if event_json is not None:
            try:
                self._plugins.block_input(
                    event_json, app_id, channel_id
                )
            except PluginRejection as e:
                raise HTTPError(e.status, str(e)) from e
        return event_json

    def _store(self, event: Event, app_id: int, channel_id, whitelist):
        event_json = self._validate(event, app_id, channel_id, whitelist)
        with tracing.span("store/insert_event", appId=app_id):
            event_id = self._storage.get_events().insert(
                event, app_id, channel_id
            )
        if event_json is not None:
            self._plugins.sniff_input(event_json, app_id, channel_id)
        return event_id

    def _create_event(self, request: Request) -> Response:
        app_id, channel_id, whitelist = self._auth(request)
        try:
            event = Event.from_json_dict(request.json() or {})
            event_id = self._store(event, app_id, channel_id, whitelist)
        except (EventValidationError, HTTPError) as e:
            status = e.status if isinstance(e, HTTPError) else 400
            self._count(app_id, status)
            if isinstance(e, HTTPError):
                raise
            raise HTTPError(400, str(e)) from e
        self._count(app_id, 201, event)
        return Response(201, {"eventId": event_id})

    def _parse_time(self, raw: str | None) -> _dt.datetime | None:
        if raw is None:
            return None
        try:
            t = _dt.datetime.fromisoformat(raw.replace("Z", "+00:00"))
        except ValueError as e:
            raise HTTPError(400, f"bad time {raw!r}: {e}") from e
        return t if t.tzinfo else t.replace(tzinfo=_dt.timezone.utc)

    def _find_events(self, request: Request) -> Response:
        app_id, channel_id, _ = self._auth(request)
        q = request.query
        # tri-state target filters: "none" means must-be-absent
        tet = q.get("targetEntityType", ...)
        tei = q.get("targetEntityId", ...)
        tet = None if tet == "none" else tet
        tei = None if tei == "none" else tei
        try:
            limit = int(q.get("limit", 20))
        except ValueError as e:
            raise HTTPError(400, f"bad limit: {e}") from e
        with tracing.span("store/find_events", appId=app_id):
            events = self._storage.get_events().find(
                app_id,
                channel_id,
                start_time=self._parse_time(q.get("startTime")),
                until_time=self._parse_time(q.get("untilTime")),
                entity_type=q.get("entityType"),
                entity_id=q.get("entityId"),
                event_names=[q["event"]] if "event" in q else None,
                target_entity_type=tet,
                target_entity_id=tei,
                limit=limit,
                reversed=q.get("reversed", "false").lower() == "true",
            )
        return Response(200, [e.to_json_dict() for e in events])

    def _get_event(self, request: Request) -> Response:
        app_id, channel_id, _ = self._auth(request)
        with tracing.span("store/get_event", appId=app_id):
            event = self._storage.get_events().get(
                request.path_params["event_id"], app_id, channel_id
            )
        if event is None:
            raise HTTPError(404, "event not found")
        return Response(200, event.to_json_dict())

    def _delete_event(self, request: Request) -> Response:
        app_id, channel_id, _ = self._auth(request)
        with tracing.span("store/delete_event", appId=app_id):
            found = self._storage.get_events().delete(
                request.path_params["event_id"], app_id, channel_id
            )
        if not found:
            raise HTTPError(404, "event not found")
        return Response(200, {"message": "deleted"})

    def _batch(self, request: Request) -> Response:
        """A status per event: validate every event first, then store the
        accepted ones in one ``insert_batch``."""
        app_id, channel_id, whitelist = self._auth(request)
        payload = request.json()
        if not isinstance(payload, list):
            raise HTTPError(400, "request body must be a JSON array")
        if len(payload) > MAX_BATCH_SIZE:
            raise HTTPError(
                400,
                f"Batch request must have less than or equal to "
                f"{MAX_BATCH_SIZE} events",
            )
        # one insert_batch: a backend pays its write lock or its
        # transaction once for the batch
        results: list[dict | None] = []
        accepted: list[tuple[int, Event, dict | None]] = []
        for item in payload:
            try:
                event = Event.from_json_dict(item)
                event_json = self._validate(
                    event, app_id, channel_id, whitelist
                )
                accepted.append((len(results), event, event_json))
                results.append(None)  # filled after the batch insert
            except (EventValidationError, HTTPError, TypeError) as e:
                status = e.status if isinstance(e, HTTPError) else 400
                results.append({"status": status, "message": str(e)})
                self._count(app_id, status)
        if accepted:
            try:
                with tracing.span(
                    "store/insert_batch",
                    appId=app_id, events=len(accepted),
                ):
                    ids = self._storage.get_events().insert_batch(
                        [e for _, e, _ in accepted], app_id, channel_id
                    )
            except Exception as exc:  # noqa: BLE001 - per-item contract
                # storage failed mid-batch: keep the per-event status
                # list (rejections already computed) instead of blowing
                # up the whole response with a bare 500. Only
                # PartialBatchError guarantees which prefix is durable;
                # other failures leave saved-ness unknown, and the
                # message must say so (a false "not saved" invites
                # duplicating retries).
                logger.exception("batch insert failed")
                if isinstance(exc, PartialBatchError):
                    saved = list(exc.inserted_ids)
                    fail_msg = "storage error; event was not saved"
                else:
                    saved = []
                    fail_msg = "storage error; event may not be saved"
                for i, (slot, event, event_json) in enumerate(accepted):
                    if i < len(saved):
                        results[slot] = {
                            "status": 201, "eventId": saved[i]
                        }
                        self._count(app_id, 201, event)
                        if event_json is not None:
                            self._plugins.sniff_input(
                                event_json, app_id, channel_id
                            )
                    else:
                        results[slot] = {
                            "status": 500, "message": fail_msg,
                        }
                        self._count(app_id, 500)
                return Response(200, results)
            for (slot, event, event_json), event_id in zip(accepted, ids):
                results[slot] = {"status": 201, "eventId": event_id}
                self._count(app_id, 201, event)
                if event_json is not None:
                    self._plugins.sniff_input(
                        event_json, app_id, channel_id
                    )
        return Response(200, results)

    def _stats_route(self, request: Request) -> Response:
        app_id, _, _ = self._auth(request)
        if self._stats is None:
            raise HTTPError(
                404, "stats are not enabled (run with stats=True)"
            )
        return Response(200, self._stats.snapshot(app_id))

    def _webhook_json(self, request: Request) -> Response:
        app_id, channel_id, whitelist = self._auth(request)
        connector = JSON_CONNECTORS.get(request.path_params["name"])
        if connector is None:
            raise HTTPError(404, "webhook connector not found")
        try:
            event = Event.from_json_dict(
                connector.to_event_json(request.json() or {})
            )
            event_id = self._store(event, app_id, channel_id, whitelist)
        except (ConnectorError, EventValidationError) as e:
            raise HTTPError(400, str(e)) from e
        self._count(app_id, 201, event)
        return Response(201, {"eventId": event_id})

    def _webhook_probe(self, request: Request, connectors) -> Response:
        """Connector probe: 200 Ok when registered, else 404; external
        services (segment.io) ping this before sending."""
        self._auth(request)
        if request.path_params["name"] not in connectors:
            raise HTTPError(
                404,
                f"webhooks connection for "
                f"{request.path_params['name']} is not supported.",
            )
        return Response(200, {"message": "Ok"})

    def _webhook_json_probe(self, request: Request) -> Response:
        return self._webhook_probe(request, JSON_CONNECTORS)

    def _webhook_form_probe(self, request: Request) -> Response:
        return self._webhook_probe(request, FORM_CONNECTORS)

    def _webhook_form(self, request: Request) -> Response:
        app_id, channel_id, whitelist = self._auth(request)
        connector = FORM_CONNECTORS.get(request.path_params["name"])
        if connector is None:
            raise HTTPError(404, "webhook connector not found")
        try:
            event = Event.from_json_dict(
                connector.to_event_json(request.form())
            )
            event_id = self._store(event, app_id, channel_id, whitelist)
        except (ConnectorError, EventValidationError) as e:
            raise HTTPError(400, str(e)) from e
        self._count(app_id, 201, event)
        return Response(201, {"eventId": event_id})

    def close(self) -> None:
        """Release the plugin sniffer dispatcher thread."""
        self._plugins.close()


def create_event_server(
    host: str = "0.0.0.0",
    port: int = 7070,
    storage: Storage | None = None,
    stats: bool = False,
    plugins: PluginContext | None = None,
    registry: MetricRegistry | None = None,
    tracer: tracing.Tracer | None = None,
    admission: bool = True,
    server_config=None,
    reuse_port: bool = False,
) -> HTTPServer:
    """An HTTP server on an :class:`EventServer` (default port 7070);
    ``start()`` it, and ``shutdown()`` (or ``drain()``) also releases
    the plugin dispatcher. ``registry`` and ``tracer`` default to the
    process's. TLS comes from ``server_config`` (default: the
    environment's ``ServerConfig``); the server key is never enforced on
    the event API. ``reuse_port`` binds with ``SO_REUSEPORT`` (the
    multi-worker front end)."""
    from predictionio_tpu_torch.serving.config import ServerConfig

    if server_config is None:
        server_config = ServerConfig.from_env()
    server = EventServer(storage=storage, stats=stats, plugins=plugins,
                         registry=registry, tracer=tracer,
                         server_config=server_config,
                         admission=admission)
    http = HTTPServer(server.router, host=host, port=port,
                      server_config=server_config, enforce_key=False,
                      reuse_port=reuse_port,
                      service="eventserver", registry=server.registry,
                      tracer=server.tracer)
    http.add_shutdown_hook(server.close)
    return http
