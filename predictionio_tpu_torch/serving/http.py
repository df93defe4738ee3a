"""Minimal threaded HTTP routing layer, with the telemetry and overload
surface.

Counterpart of ``Request``, ``Response``, ``HTTPError``, ``Router``,
``install_metrics_routes`` and ``HTTPServer`` in
``predictionio_tpu/serving/http.py``, on the standard library's
``ThreadingHTTPServer``: thread per connection, JSON bodies,
``X-Request-ID`` forwarded (when well-formed) or minted, access keys
blanked out of the access log. Before any handler runs a request meets,
in this order, as in the JAX package:

* ``GET /healthz``, answered before routing (``draining`` and 503 while
  the server drains), with ``Router.healthz_extra``'s dict merged in
  (``extra_error`` when the reporter raises);
* the drain: once :meth:`HTTPServer.begin_drain` ran, every request
  outside the telemetry routes gets 503 with ``Retry-After``;
* ``X-PIO-Deadline`` (milliseconds of budget): an expired budget is a
  504; the budget, ``X-PIO-Criticality`` and the tenant
  (``accessKey`` or ``X-PIO-Tenant``) ride contextvars down to the
  micro-batcher;
* the admission controller (``Router.admission``): 503 or 429 with
  ``Retry-After`` and ``X-PIO-Shed``;
* the chaos injector (``Router.chaos_middleware``, from ``PIO_CHAOS``);
* with a ``server_config`` whose key auth is enforced (and
  ``enforce_key``), the server key on every route.

With a ``server_config`` whose TLS is on, every connection is wrapped
in its SSL context, and the handshake runs in the connection's own
thread, so a client that stalls it holds no other connection.

With a ``registry`` every request is counted and timed
(``pio_http_requests_total``, ``pio_http_request_seconds``,
``pio_http_inflight_requests``, ``pio_http_rejected_total``,
``pio_server_draining``) and scored by an :class:`SLOMonitor`; every
request outside the telemetry routes is one root span of the tracer.

With ``reuse_port`` the listener sets ``SO_REUSEPORT``, so N worker
processes bind one port and the kernel spreads connections over them
(:mod:`~predictionio_tpu_torch.serving.workers`).
"""

from __future__ import annotations

import json
import logging
import os
import re
import socket
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qs, urlparse

from predictionio_tpu_torch.obs import MetricRegistry, set_request_id
from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.obs.context import log_json, redact_keys
from predictionio_tpu_torch.obs.slo import SLOMonitor
from predictionio_tpu_torch.serving import admission, resilience

logger = logging.getLogger(__name__)

#: structured access log: one JSON line per request (DEBUG on success,
#: INFO on 4xx, WARNING on 5xx) carrying the request ID
access_logger = logging.getLogger("predictionio_tpu_torch.access")

Handler = Callable[["Request"], "Response"]


class Request:
    def __init__(
        self,
        method: str,
        path: str,
        query: dict[str, str],
        headers,
        body: bytes,
        path_params: dict[str, str],
    ):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.path_params = path_params
        #: set by the server wrapper (forwarded X-Request-ID or minted)
        self.request_id: str | None = None
        #: remaining-budget deadline from X-PIO-Deadline (set by the
        #: server wrapper; None when the request carried no budget)
        self.deadline: resilience.Deadline | None = None
        #: the route PATTERN that matched (set by Router.dispatch) —
        #: bounded cardinality, unlike the raw path
        self.route: str | None = None
        #: criticality class from X-PIO-Criticality (set by the server
        #: wrapper; defaults to "default" for unlabeled requests)
        self.criticality: str = admission.DEFAULT
        #: "host:port" of the connecting client (set by the server
        #: wrapper): the serving router hashes it for affinity when a
        #: request carries no affinity key, tenant or body
        self.client_addr: str = ""

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))

    def form(self) -> dict[str, str]:
        data = parse_qs(self.body.decode("utf-8"))
        return {k: v[0] for k, v in data.items()}


class Response:
    def __init__(
        self,
        status: int = 200,
        body: Any = None,
        content_type: str = "application/json",
        headers: dict[str, str] | None = None,
    ):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}

    def payload(self) -> bytes:
        if self.body is None:
            return b""
        if isinstance(self.body, bytes):
            return self.body
        if isinstance(self.body, str):
            return self.body.encode("utf-8")
        return json.dumps(self.body).encode("utf-8")


class HTTPError(Exception):
    def __init__(
        self,
        status: int,
        message: str,
        headers: dict[str, str] | None = None,
    ):
        super().__init__(message)
        self.status = status
        self.message = message
        #: extra response headers (e.g. a computed ``Retry-After`` on a
        #: shed — the cooperative-backpressure contract)
        self.headers = headers or {}


class Router:
    """Method + regex path routing; ``<name>`` captures a segment and
    ``<name:path>`` captures the rest of the path (slashes included)."""

    def __init__(self):
        self._routes: list[tuple[str, re.Pattern, Handler, str]] = []
        #: fault injector applied before dispatch (attached by
        #: install_metrics_routes when PIO_CHAOS is set)
        self.chaos_middleware: resilience.ChaosMiddleware | None = None
        #: adaptive overload controller applied at admission (attached
        #: by the owning server BEFORE HTTPServer construction;
        #: docs/robustness.md "Overload & backpressure")
        self.admission: admission.AdmissionController | None = None
        #: optional zero-arg callable whose dict is merged into the
        #: ``/healthz`` payload (the store server reports replication
        #: role + peer lag here, the event server its client's quorum
        #: view). Must be cheap and non-blocking: health probes run on
        #: the admission path.
        self.healthz_extra: Callable[[], dict] | None = None

    def route(self, method: str, pattern: str, handler: Handler) -> None:
        # escape literal segments so '.' in '.json' doesn't match anything
        parts = re.split(r"<([a-zA-Z_]+(?::path)?)>", pattern)
        built = "".join(
            (
                f"(?P<{part.removesuffix(':path')}>.+)"
                if part.endswith(":path")
                else f"(?P<{part}>[^/]+)"
            )
            if i % 2
            else re.escape(part)
            for i, part in enumerate(parts)
        )
        self._routes.append(
            (method.upper(), re.compile(f"^{built}$"), handler, pattern)
        )

    def dispatch(self, request: Request) -> Response:
        path_matched = False
        for method, regex, handler, pattern in self._routes:
            m = regex.match(request.path)
            if not m:
                continue
            path_matched = True
            if method != request.method:
                continue
            request.path_params = dict(m.groupdict())
            request.route = pattern
            return handler(request)
        if path_matched:
            raise HTTPError(405, "method not allowed")
        raise HTTPError(404, "not found")

    def match_route(self, request: Request) -> str | None:
        """The route pattern that would handle ``request``, resolved
        without dispatching, so a refusal before dispatch (a spent
        deadline, a shed) still carries a real route label."""
        for method, regex, _handler, pattern in self._routes:
            if method == request.method and regex.match(request.path):
                return pattern
        return None


def install_metrics_routes(
    router: Router,
    registry: MetricRegistry,
    tracer: tracing.Tracer | None = None,
    server_config=None,
    federation=None,
    timeline=None,
) -> None:
    """The common telemetry surface: Prometheus text at ``GET
    /metrics``, the same registry as JSON at ``GET /metrics.json``
    (histograms with derived p50/p95/p99), and the tracing flight
    recorder at ``GET /debug/traces`` (Chrome trace-event JSON, loads in
    Perfetto; ``?traceId=`` picks one trace) and ``GET
    /debug/traces.json`` (raw span trees). ``timeline`` (an object with
    ``to_dict()``, a :class:`~predictionio_tpu_torch.obs.Timeline`)
    mounts its ring at ``GET /debug/timeline.json``. The router also
    gains the ``PIO_CHAOS`` fault injector
    (:meth:`~predictionio_tpu_torch.serving.resilience.ChaosMiddleware.from_env`).

    ``server_config`` key-auths the ``/debug`` routes when its key auth
    is enforced: traces and the timeline carry per-request data
    (request IDs, tenants, latencies) that a server whose other routes
    are open must not hand to anonymous clients. ``/metrics`` stays as
    open as the server: aggregates only.

    ``federation`` (an object with ``render_text()`` / ``to_dict()``,
    the serving router's fleet view) takes the place of the registry in
    both metrics bodies: every replica's series labeled
    ``replica=...`` beside exactly merged fleet counters and
    histograms, so one scrape sees the whole fleet."""
    tracer = tracer if tracer is not None else tracing.get_tracer()

    def _metrics(request: Request) -> Response:
        body = (
            federation.render_text()
            if federation is not None
            else registry.render_prometheus()
        )
        return Response(
            200,
            body,
            content_type="text/plain; version=0.0.4; charset=utf-8",
        )

    def _metrics_json(request: Request) -> Response:
        body = (
            federation.to_dict()
            if federation is not None
            else registry.to_dict()
        )
        return Response(200, body)

    def _traces(request: Request) -> Response:
        if server_config is not None:
            server_config.check_key(request)
        # serialized here with default=str: span attributes are caller-
        # supplied, and Response.payload() runs outside the handler's
        # error boundary
        return Response(
            200,
            json.dumps(
                tracer.chrome_trace(request.query.get("traceId")),
                default=str,
            ),
        )

    def _traces_json(request: Request) -> Response:
        if server_config is not None:
            server_config.check_key(request)
        return Response(200, json.dumps(tracer.to_dict(), default=str))

    def _timeline_json(request: Request) -> Response:
        if server_config is not None:
            server_config.check_key(request)
        return Response(200, json.dumps(timeline.to_dict(), default=str))

    router.route("GET", "/metrics", _metrics)
    router.route("GET", "/metrics.json", _metrics_json)
    router.route("GET", "/debug/traces", _traces)
    router.route("GET", "/debug/traces.json", _traces_json)
    if timeline is not None:
        router.route("GET", "/debug/timeline.json", _timeline_json)
    # every server that mounts the telemetry surface also gains the
    # env-driven fault injector (a no-op unless PIO_CHAOS is set)
    router.chaos_middleware = resilience.ChaosMiddleware.from_env(registry)


class HTTPServer:
    """Threaded server wrapping a Router; ``start()`` serves on a daemon
    thread, ``shutdown()`` stops it, closes the socket and runs the
    shutdown hooks, and ``drain()`` is the lossless stop: refuse new
    work, let in-flight requests finish, run the drain hooks, shut
    down."""

    def __init__(
        self,
        router: Router,
        host: str = "0.0.0.0",
        port: int = 0,
        server_config=None,
        enforce_key: bool = True,
        reuse_port: bool = False,
        service: str = "http",
        registry: MetricRegistry | None = None,
        tracer: tracing.Tracer | None = None,
        slo=None,
    ):
        """``server_config`` (a
        :class:`~predictionio_tpu_torch.serving.config.ServerConfig`):
        when its key auth is enforced every route requires the server
        key (``X-PIO-Server-Key``, ``Authorization: Bearer`` or the
        ``accessKey`` query param; reference
        KeyAuthentication.scala:30-58), and when TLS is enabled every
        connection is wrapped in its SSL context (TLS 1.2 or later).
        ``enforce_key=False`` keeps TLS but leaves auth to the handlers
        (the engine server key-auths only its admin routes).
        ``reuse_port`` sets ``SO_REUSEPORT`` before the bind (an
        ``OSError`` where the platform lacks it).

        ``registry`` turns on the telemetry wrapper: every request gets
        (or forwards) an ``X-Request-ID``, is timed into
        ``pio_http_request_seconds{service,route}``, counted into
        ``pio_http_requests_total{service,method,status}``, and emits a
        structured access-log line. Request-ID handling is always on —
        only the metrics need a registry.

        ``tracer`` (default: the process tracer) opens one root span
        per request — trace ID = request ID, remote parent from
        ``X-Parent-Span`` — so handlers, storage calls, and the
        micro-batcher hang child spans off it; scrape/debug routes
        themselves are not traced.

        ``slo``: None scores every served request into an
        :class:`SLOMonitor` on the registry (objectives from the
        environment), False turns scoring off, and a monitor passed in
        is shared."""
        router_ref = router
        config_ref = server_config if enforce_key else None
        tracer_ref = tracer if tracer is not None else tracing.get_tracer()
        chaos_ref = router.chaos_middleware
        admission_ref = router.admission
        state = resilience.DrainState()
        if registry is not None:
            requests_total = registry.counter(
                "pio_http_requests_total",
                "HTTP requests by service, method, and status",
                ("service", "method", "status"),
            )
            request_seconds = registry.histogram(
                "pio_http_request_seconds",
                "HTTP request latency by service and route pattern",
                ("service", "route"),
            )
            rejected_total = registry.counter(
                "pio_http_rejected_total",
                "Requests refused at admission, by reason "
                "(draining | deadline | overload)",
                ("service", "reason"),
            )
            # scrape-time functions: in a process that rebuilds servers
            # (tests, reload), the latest server's state wins the label
            registry.gauge(
                "pio_http_inflight_requests",
                "Requests currently being handled",
                ("service",),
            ).labels(service).set_function(lambda: float(state.inflight))
            registry.gauge(
                "pio_server_draining",
                "1 while the server is draining (stopped accepting work)",
                ("service",),
            ).labels(service).set_function(
                lambda: 1.0 if state.draining.is_set() else 0.0
            )
        else:
            requests_total = request_seconds = rejected_total = None
        # SLO scoring rides the same telemetry tail: slo=None auto-
        # creates a monitor on the registry (env-configured
        # objectives), slo=False disables it (the router scores fleet
        # traffic from federated counters instead — scoring its own
        # proxy hops too would double-count every request), and an
        # explicit SLOMonitor is shared (tests, embedding servers)
        if slo is False or registry is None:
            slo_ref = None
        elif slo is not None:
            slo_ref = slo
        else:
            slo_ref = SLOMonitor(registry)

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # response header+body go out in one write; without NODELAY
            # Nagle + delayed ACK adds ~40 ms to every keep-alive request
            disable_nagle_algorithm = True

            def setup(self):
                # the TLS handshake runs here, in the connection's own
                # thread, never in the accept loop, where a stalled
                # client would hold every other connection
                sock = self.request
                if isinstance(sock, ssl.SSLSocket):
                    sock.settimeout(10.0)
                    sock.do_handshake()
                    sock.settimeout(None)
                super().setup()

            def log_message(self, fmt, *args):  # route through logging
                line = redact_keys(fmt % args)
                logger.debug("%s %s", self.address_string(), line)

            def _admission(
                self, request, path, deadline, telemetry_path
            ) -> Response | None:
                """Work the server refuses before running any handler:
                the /healthz probe itself, everything while draining,
                and requests whose deadline already expired (admitting
                them would spend handler + device time computing an
                answer nobody is waiting for)."""
                if path == "/healthz" and self.command == "GET":
                    draining = state.draining.is_set()
                    request.route = "/healthz"
                    payload = {
                        "status": "draining" if draining else "ok",
                        "service": service,
                        "pid": os.getpid(),
                    }
                    extra = router_ref.healthz_extra
                    if extra is not None:
                        try:
                            payload.update(extra() or {})
                        except Exception as e:  # noqa: BLE001
                            # a broken reporter must not fail the probe
                            payload["extra_error"] = str(e)
                    return Response(503 if draining else 200, payload)
                if self._draining_at_entry and not telemetry_path:
                    request.route = "(draining)"
                    if rejected_total is not None:
                        rejected_total.labels(service, "draining").inc()
                    return Response(
                        503,
                        {
                            "message": "server is draining; "
                            "retry against another instance"
                        },
                        headers={"Retry-After": "1"},
                    )
                if deadline is not None and deadline.expired:
                    request.route = (
                        router_ref.match_route(request) or "(unmatched)"
                    )
                    if rejected_total is not None:
                        rejected_total.labels(service, "deadline").inc()
                    return Response(
                        504,
                        {"message": "deadline already expired at admission"},
                    )
                return None

            def _handle(self):
                # count the request in-flight for the WHOLE handler —
                # until the response bytes are written, so the process
                # does not exit mid-write. ORDER MATTERS: increment
                # BEFORE snapshotting the draining flag. Drain sets the
                # flag first and then samples inflight, so every
                # request is either visible to the drain's inflight
                # wait or sees the flag and is refused — there is no
                # window where a just-admitted request is invisible to
                # a concurrent drain. The snapshot (not a live read)
                # also means a request whose body was still streaming
                # when SIGTERM arrived is finished, not refused.
                state.begin_request()
                self._draining_at_entry = state.draining.is_set()
                try:
                    self._handle_inner()
                finally:
                    state.end_request()

            def _handle_inner(self):
                parsed = urlparse(self.path)
                query = {
                    k: v[0] for k, v in parse_qs(parsed.query).items()
                }
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                request = Request(
                    method=self.command,
                    path=parsed.path,
                    query=query,
                    headers=self.headers,
                    body=body,
                    path_params={},
                )
                try:
                    request.client_addr = "%s:%s" % self.client_address[:2]
                except (TypeError, IndexError):  # AF_UNIX and friends
                    request.client_addr = str(self.client_address)
                # forwarded or minted; installed in the thread context so
                # the batcher and log lines downstream can read it
                request.request_id = set_request_id(
                    self.headers.get("X-Request-ID")
                )
                # the remaining-budget deadline rides the same context;
                # set unconditionally — a keep-alive connection reuses
                # this thread, and a stale deadline must not leak into
                # the next request
                deadline = resilience.Deadline.from_header(
                    self.headers.get(resilience.DEADLINE_HEADER)
                )
                resilience.set_deadline(deadline)
                request.deadline = deadline
                # criticality rides the same contextvar discipline:
                # set unconditionally so a keep-alive thread cannot
                # leak one request's class into the next
                request.criticality = admission.parse_criticality(
                    self.headers.get(admission.CRITICALITY_HEADER)
                )
                admission.set_criticality(request.criticality)
                # tenant identity, same discipline: installed
                # unconditionally so the batcher downstream can
                # attribute device time, and so a keep-alive thread
                # cannot charge one tenant for the next request
                tenant = (
                    query.get("accessKey")
                    or self.headers.get(admission.TENANT_HEADER)
                    or ""
                )
                admission.set_tenant(tenant)
                # the operator's window into a sick server: never
                # drain-refused, never chaos-faulted
                telemetry_path = parsed.path == "/healthz" or (
                    parsed.path.startswith(("/metrics", "/debug/"))
                )
                t0 = time.perf_counter()
                early = self._admission(request, parsed.path, deadline,
                                        telemetry_path)
                # adaptive overload gate, AFTER drain/deadline refusals
                # (those must not consume limiter slots) and never for
                # the telemetry surface. Every admit is paired with
                # exactly one release below — including the chaos-reset
                # early return.
                admitted = False
                if (
                    early is None
                    and admission_ref is not None
                    and not telemetry_path
                ):
                    try:
                        admission_ref.try_acquire(
                            request.criticality, tenant
                        )
                        admitted = True
                    except admission.AdmissionRejected as rej:
                        request.route = (
                            router_ref.match_route(request)
                            or "(unmatched)"
                        )
                        if rejected_total is not None:
                            rejected_total.labels(
                                service, "overload"
                            ).inc()
                        early = Response(
                            rej.status,
                            {
                                "message": (
                                    "server overloaded"
                                    if rej.reason == "limit"
                                    else "tenant over fair share"
                                )
                                + "; retry after the hinted delay",
                                "reason": rej.reason,
                            },
                            headers={
                                "Retry-After": admission
                                .format_retry_after(rej.retry_after_s),
                                # refused BEFORE the handler: nothing
                                # ran, so even a POST replays safely
                                admission.SHED_HEADER: rej.reason,
                            },
                        )
                # True when the response carries NO verdict about this
                # server's capacity (dependency fast-fail, injected
                # fault): released without feeding the limiter
                no_verdict = False
                response: Response | None = None
                try:
                    if early is not None:
                        response = early
                    else:
                        # root span: trace ID = request ID; a forwarded
                        # X-Parent-Span makes this request a child in a
                        # distributed trace. Scrapes of the telemetry surface
                        # itself would drown real traffic in the recorder; a
                        # disabled tracer skips even the name/attribute builds.
                        span_cm = (
                            tracing.NOOP
                            if not tracer_ref.enabled
                            or parsed.path.startswith(("/metrics", "/debug/"))
                            else tracer_ref.trace(
                                f"{service} {self.command}",
                                trace_id=request.request_id,
                                parent_id=tracing.sanitize_id(
                                    self.headers.get(tracing.PARENT_SPAN_HEADER)
                                ),
                                attributes={
                                    "service": service,
                                    "method": self.command,
                                },
                            )
                        )
                        try:
                            with span_cm as root_span:
                                try:
                                    if (
                                        chaos_ref is not None
                                        and not telemetry_path
                                    ):
                                        chaos_ref.apply(parsed.path)
                                    if config_ref is not None:
                                        # the route label first, so a 401
                                        # counts against its real route
                                        request.route = (
                                            router_ref.match_route(request)
                                        )
                                        config_ref.check_key(request)
                                    response = router_ref.dispatch(request)
                                except resilience.ChaosReset:
                                    raise  # handled below: slam the socket
                                except HTTPError as e:
                                    response = Response(
                                        e.status,
                                        {"message": e.message},
                                        headers=dict(e.headers),
                                    )
                                except resilience.DeadlineExceeded as e:
                                    response = Response(
                                        504,
                                        {"message": f"deadline exceeded: {e}"},
                                    )
                                except resilience.ChaosError as e:
                                    # an injected fault says nothing about
                                    # this server's capacity — it must not
                                    # feed the limiter (a chaos rehearsal
                                    # would drag the limit to the floor on
                                    # an unloaded server)
                                    no_verdict = True
                                    response = Response(
                                        e.status, {"message": e.message}
                                    )
                                except resilience.CircuitOpenError as e:
                                    # a dependency's breaker is open: the
                                    # request CAN be retried elsewhere/
                                    # later. A fast-fail says nothing
                                    # about THIS server's capacity, so it
                                    # is flagged out of the limiter's
                                    # latency signal below.
                                    no_verdict = True
                                    response = Response(
                                        503,
                                        {"message": str(e)},
                                        headers={
                                            "Retry-After": (
                                                admission_ref
                                                .retry_after_header()
                                                if admission_ref is not None
                                                else "1"
                                            )
                                        },
                                    )
                                except json.JSONDecodeError as e:
                                    response = Response(
                                        400, {"message": f"bad JSON: {e}"}
                                    )
                                except Exception as e:  # noqa: BLE001 - server boundary
                                    logger.exception("handler error")
                                    response = Response(
                                        500, {"message": str(e)}
                                    )
                                if root_span is not None:
                                    root_span.set(
                                        "route", request.route or "(unmatched)"
                                    )
                                    root_span.set("status", response.status)
                        except resilience.ChaosReset:
                            # a slammed connection produced no verdict
                            # about capacity — the finally below
                            # releases without a latency sample
                            no_verdict = True
                            log_json(
                                access_logger, logging.INFO, "chaos_reset",
                                service=service, path=parsed.path,
                            )
                            self.close_connection = True
                            return
                finally:
                    # EVERY admitted request releases its slot exactly
                    # once — here, on all paths: normal responses, the
                    # chaos-reset early return, and anything escaping
                    # the handler machinery itself (which produced no
                    # response and therefore no capacity verdict).
                    # Outcome classification feeds the adaptive limit:
                    # sheds and deadline misses are the AIMD backoff
                    # signal; a circuit-open fast-fail is NO sample
                    # (its near-zero latency would inflate the limit);
                    # every real served request is a latency sample
                    elapsed = time.perf_counter() - t0
                    if admitted:
                        if no_verdict or response is None:
                            outcome = admission.OUTCOME_IGNORE
                        elif response.status in (429, 503, 504):
                            outcome = admission.OUTCOME_DROP
                        else:
                            outcome = admission.OUTCOME_OK
                        admission_ref.release(elapsed, outcome, tenant)
                if response.status >= 400 and isinstance(
                    response.body, dict
                ):
                    # error responses carry the ID so a client report
                    # can be joined against server logs
                    response.body = {
                        **response.body, "requestId": request.request_id
                    }
                payload = response.payload()
                route = request.route or "(unmatched)"
                if requests_total is not None:
                    requests_total.labels(
                        service, self.command, str(response.status)
                    ).inc()
                    request_seconds.labels(service, route).observe(
                        elapsed
                    )
                if slo_ref is not None and not telemetry_path:
                    # scrapes and debug pulls are operator traffic,
                    # not served load — they never burn the budget
                    slo_ref.observe(
                        request.criticality, response.status, elapsed
                    )
                log_json(
                    access_logger,
                    logging.WARNING if response.status >= 500
                    else logging.INFO if response.status >= 400
                    else logging.DEBUG,
                    "http_request",
                    service=service,
                    method=self.command,
                    path=parsed.path,
                    route=route,
                    status=response.status,
                    ms=round(elapsed * 1000, 3),
                )
                self.send_response(response.status)
                self.send_header("Content-Type", response.content_type)
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("X-Request-ID", request.request_id)
                for k, v in response.headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = do_DELETE = do_PUT = _handle

        ssl_context = (
            server_config.ssl_context() if server_config is not None else None
        )

        class _Server(ThreadingHTTPServer):
            # the default backlog of 5 drops connections under concurrent
            # bursts — the exact load the batcher exists for
            request_queue_size = 128
            daemon_threads = True

            def server_bind(self):
                # SO_REUSEPORT: N worker processes bind the same port
                # and the kernel spreads accepted connections over them.
                # Set here rather than through socketserver's
                # allow_reuse_port (3.11+ only), which would silently
                # do nothing on an older runtime
                if reuse_port:
                    if not hasattr(socket, "SO_REUSEPORT"):
                        raise OSError(
                            "SO_REUSEPORT is not supported on this "
                            "platform; run with --workers 1"
                        )
                    self.socket.setsockopt(
                        socket.SOL_SOCKET, socket.SO_REUSEPORT, 1
                    )
                super().server_bind()

            def handle_error(self, request, client_address):
                # connection-level failures (an aborted TLS handshake
                # among them) are expected noise
                logger.debug(
                    "connection error from %s", client_address,
                    exc_info=True,
                )

            def get_request(self):
                sock, addr = super().get_request()
                if ssl_context is not None:
                    # the handshake waits for the handler thread (setup)
                    sock = ssl_context.wrap_socket(
                        sock,
                        server_side=True,
                        do_handshake_on_connect=False,
                    )
                return sock, addr

        self._httpd = _Server((host, port), _Handler)
        self._thread: threading.Thread | None = None
        self._state = state
        self._service = service
        self._drain_hooks: list[Callable[[], None]] = []
        self._shutdown_hooks: list[Callable[[], None]] = []
        self._state_lock = threading.Lock()
        self._served = False
        self._shut = False
        self._shut_done = threading.Event()
        self.router = router
        #: the per-server SLO monitor (None when disabled), so tests and
        #: status routes can read burn rates directly
        self.slo = slo_ref

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # -- graceful drain ---------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._state.draining.is_set()

    @property
    def inflight(self) -> int:
        return self._state.inflight

    def add_drain_hook(self, hook: Callable[[], None]) -> None:
        """Run ``hook`` during drain, after in-flight requests finished
        and before the listener closes: where an engine server closes
        its micro-batchers so the batch on the card completes."""
        self._drain_hooks.append(hook)

    def begin_drain(self) -> None:
        """Stop accepting work now: ``/healthz`` answers ``draining``
        (503) and every request outside the telemetry routes gets 503
        with ``Retry-After``. In-flight requests keep running."""
        if not self._state.draining.is_set():
            self._state.draining.set()
            log_json(
                logger, logging.INFO, "drain_begin",
                service=self._service,
            )

    def drain(self, grace_s: float | None = None) -> bool:
        """The lossless stop: :meth:`begin_drain`, wait for in-flight
        requests (at most ``grace_s``, default ``PIO_DRAIN_GRACE_S``),
        run the drain hooks, shut the listener down. Returns True when
        every in-flight request finished inside the grace window."""
        grace = (
            grace_s if grace_s is not None else resilience.drain_grace_s()
        )
        self.begin_drain()
        deadline = time.monotonic() + grace
        while self._state.inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        clean = self._state.inflight == 0
        if not clean:
            log_json(
                logger, logging.WARNING, "drain_grace_exceeded",
                service=self._service,
                inflight=self._state.inflight,
                graceS=grace,
            )
        for hook in self._drain_hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 - drain must reach shutdown
                logger.exception("drain hook failed")
        log_json(
            logger, logging.INFO, "server_drained",
            service=self._service, clean=clean,
        )
        self.shutdown()
        return clean

    def start(self) -> None:
        self._served = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self._served = True
        self._httpd.serve_forever()

    def add_shutdown_hook(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` after the server has stopped taking requests."""
        self._shutdown_hooks.append(fn)

    def shutdown(self, wait_s: float = 60.0) -> None:
        """Stop serving, close the socket and run the shutdown hooks,
        once: a later call (``POST /stop`` racing a signal, or the
        owner's close after either) waits up to ``wait_s`` for the
        first to finish its hooks, so its caller never exits the
        process under a batcher still closing. A server never started
        is only closed."""
        with self._state_lock:
            first = not self._shut
            self._shut = True
        if not first:
            self._shut_done.wait(wait_s)
            return
        try:
            if self._served:
                self._httpd.shutdown()
            self._httpd.server_close()
            if self._thread is not None:
                self._thread.join(timeout=5)
            for fn in self._shutdown_hooks:
                fn()
        finally:
            self._shut_done.set()


def undeploy_existing(host: str, port: int, server_config=None) -> bool:
    """POST /stop to whatever occupies ``host:port`` before binding
    there (reference MasterActor.undeploy, CreateServer.scala:280-305).
    Returns True if an old server acknowledged the stop. It stops an
    engine server of either package; under ``server_config`` it speaks
    TLS when TLS is on (the old server's certificate is not verified:
    this is a localhost control handshake, not a trust decision) and
    sends the server key as ``accessKey``, as the JAX package does."""
    probe_host = "127.0.0.1" if host in ("0.0.0.0", "") else host
    ssl_enabled = bool(getattr(server_config, "ssl_enabled", False))
    scheme = "https" if ssl_enabled else "http"
    url = f"{scheme}://{probe_host}:{port}/stop"
    key = getattr(server_config, "access_key", "") or ""
    if key:
        url += "?" + urllib.parse.urlencode({"accessKey": key})
    tls_ctx = None
    if ssl_enabled:
        import ssl as _ssl

        tls_ctx = _ssl.create_default_context()
        tls_ctx.check_hostname = False
        tls_ctx.verify_mode = _ssl.CERT_NONE
    logger.info(
        "Undeploying any existing engine instance at %s:%d",
        probe_host, port,
    )
    try:
        with urllib.request.urlopen(
            urllib.request.Request(url, method="POST"),
            timeout=5,
            context=tls_ctx,
        ) as resp:
            if resp.status == 200:
                # give the old server a moment to release the socket
                time.sleep(1.0)
                return True
            logger.error(
                "Existing server at %s:%d answered HTTP %d to /stop; "
                "unable to undeploy",
                probe_host, port, resp.status,
            )
    except urllib.error.HTTPError as exc:
        logger.error(
            "Another process is using %s:%d (HTTP %d on /stop). "
            "Unable to undeploy.",
            probe_host, port, exc.code,
        )
    except OSError:
        logger.debug("Nothing at %s:%d", probe_host, port)
    return False
