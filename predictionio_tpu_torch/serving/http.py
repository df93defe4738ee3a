"""Minimal threaded HTTP routing layer, with the telemetry surface.

Counterpart of ``Request``, ``Response``, ``HTTPError``, ``Router``,
``install_metrics_routes`` and ``HTTPServer`` in
``predictionio_tpu/serving/http.py``, on the standard library's
``ThreadingHTTPServer``: thread per connection, JSON bodies,
``X-Request-ID`` forwarded (when well-formed) or minted, the base
``GET /healthz`` probe answered before routing, access keys blanked out
of the access log. With a ``registry`` every request is counted and
timed (``pio_http_requests_total``, ``pio_http_request_seconds``,
``pio_http_inflight_requests``); every request outside the telemetry
routes is one root span of the tracer (trace id = request id, parent
from ``X-Parent-Span``).

Not ported yet (ROADMAP.md, queue 1, item 5a): TLS and key auth of the
``/debug`` routes (``server_config``), admission control and
``pio_http_rejected_total``, deadlines, ``ChaosMiddleware`` /
``PIO_CHAOS``, draining and ``pio_server_draining``, SLO scoring and
the probe's extras.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qs, urlparse

from predictionio_tpu_torch.obs import MetricRegistry, set_request_id
from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.obs.context import log_json, redact_keys

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
        #: forwarded X-Request-ID or a minted one (set by the server)
        self.request_id: str | None = None
        #: the route pattern that matched (set by Router.dispatch)
        self.route: str | None = None

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
        self.headers = headers or {}


class Router:
    """Method + regex path routing; ``<name>`` captures a segment and
    ``<name:path>`` captures the rest of the path (slashes included)."""

    def __init__(self):
        self._routes: list[tuple[str, re.Pattern, Handler, str]] = []

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


def install_metrics_routes(
    router: Router,
    registry: MetricRegistry,
    tracer: tracing.Tracer | None = None,
    timeline=None,
) -> None:
    """The common telemetry surface: Prometheus text at ``GET
    /metrics``, the same registry as JSON at ``GET /metrics.json``
    (histograms with derived p50/p95/p99), and the tracing flight
    recorder at ``GET /debug/traces`` (Chrome trace-event JSON, loads in
    Perfetto; ``?traceId=`` picks one trace) and ``GET
    /debug/traces.json`` (raw span trees). ``timeline`` (an object with
    ``to_dict()``, a :class:`~predictionio_tpu_torch.obs.Timeline`)
    mounts its ring at ``GET /debug/timeline.json``.

    The JAX package's ``server_config`` (key auth of the ``/debug``
    routes) and ``federation`` (the fleet view) are not ported yet
    (ROADMAP.md, queue 1, items 5a and 5b)."""
    tracer = tracer if tracer is not None else tracing.get_tracer()

    def _metrics(request: Request) -> Response:
        return Response(
            200,
            registry.render_prometheus(),
            content_type="text/plain; version=0.0.4; charset=utf-8",
        )

    def _metrics_json(request: Request) -> Response:
        return Response(200, registry.to_dict())

    def _traces(request: Request) -> Response:
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
        return Response(200, json.dumps(tracer.to_dict(), default=str))

    def _timeline_json(request: Request) -> Response:
        return Response(200, json.dumps(timeline.to_dict(), default=str))

    router.route("GET", "/metrics", _metrics)
    router.route("GET", "/metrics.json", _metrics_json)
    router.route("GET", "/debug/traces", _traces)
    router.route("GET", "/debug/traces.json", _traces_json)
    if timeline is not None:
        router.route("GET", "/debug/timeline.json", _timeline_json)


class HTTPServer:
    """Threaded server wrapping a Router; ``start()`` serves on a daemon
    thread, ``shutdown()`` stops it and closes the socket.

    ``registry`` turns on the request metrics:
    ``pio_http_requests_total{service,method,status}``,
    ``pio_http_request_seconds{service,route}`` (the route pattern, not
    the raw path) and ``pio_http_inflight_requests{service}``.
    ``tracer`` (default: the process tracer) opens one root span per
    request — trace id = request id, remote parent from
    ``X-Parent-Span`` — so handlers and storage calls hang child spans
    off it; the telemetry routes themselves are not traced."""

    def __init__(
        self,
        router: Router,
        host: str = "0.0.0.0",
        port: int = 0,
        service: str = "http",
        registry: MetricRegistry | None = None,
        tracer: tracing.Tracer | None = None,
    ):
        router_ref = router
        tracer_ref = tracer if tracer is not None else tracing.get_tracer()
        inflight = [0]
        inflight_lock = threading.Lock()
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
            # a scrape-time function: in a process that rebuilds
            # servers, the latest server's count wins the label
            registry.gauge(
                "pio_http_inflight_requests",
                "Requests currently being handled",
                ("service",),
            ).labels(service).set_function(lambda: float(inflight[0]))
        else:
            requests_total = request_seconds = None

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # header and body go out in one write; without NODELAY Nagle
            # + delayed ACK add ~40 ms to every keep-alive request
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # route through logging
                line = redact_keys(fmt % args)
                logger.debug("%s %s", self.address_string(), line)

            def _handle(self):
                # in flight until the response bytes are written
                with inflight_lock:
                    inflight[0] += 1
                try:
                    self._handle_inner()
                finally:
                    with inflight_lock:
                        inflight[0] -= 1

            def _dispatch(self, request: Request, path: str) -> Response:
                if path == "/healthz" and self.command == "GET":
                    # the liveness probe answers before routing
                    request.route = "/healthz"
                    return Response(200, {
                        "status": "ok", "service": service,
                        "pid": os.getpid(),
                    })
                try:
                    return router_ref.dispatch(request)
                except HTTPError as e:
                    return Response(
                        e.status, {"message": e.message},
                        headers=dict(e.headers),
                    )
                except json.JSONDecodeError as e:
                    return Response(400, {"message": f"bad JSON: {e}"})
                except Exception as e:  # noqa: BLE001 - server boundary
                    logger.exception("handler error (%s)", service)
                    return Response(500, {"message": str(e)})

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
                # forwarded (when well-formed) or minted; installed in
                # the thread's context for log lines downstream
                request.request_id = set_request_id(
                    self.headers.get("X-Request-ID")
                )
                telemetry_path = parsed.path == "/healthz" or (
                    parsed.path.startswith(("/metrics", "/debug/"))
                )
                t0 = time.perf_counter()
                # root span: trace id = request id; a forwarded
                # X-Parent-Span makes this request a child in a
                # distributed trace. Scrapes of the telemetry surface
                # would drown real traffic in the recorder.
                span_cm = (
                    tracing.NOOP
                    if not tracer_ref.enabled or telemetry_path
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
                with span_cm as root_span:
                    response = self._dispatch(request, parsed.path)
                    if root_span is not None:
                        root_span.set(
                            "route", request.route or "(unmatched)"
                        )
                        root_span.set("status", response.status)
                elapsed = time.perf_counter() - t0
                if response.status >= 400 and isinstance(
                    response.body, dict
                ):
                    # error bodies carry the ID so a client report can
                    # be joined against server logs
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

        class _Server(ThreadingHTTPServer):
            # the default backlog of 5 drops connections under concurrent
            # bursts — the exact load the batcher exists for
            request_queue_size = 128
            daemon_threads = True

            def handle_error(self, request, client_address):
                logger.debug(
                    "connection error from %s", client_address,
                    exc_info=True,
                )

        self._httpd = _Server((host, port), _Handler)
        self._thread: threading.Thread | None = None
        self._shutdown_hooks: list[Callable[[], None]] = []
        self._state_lock = threading.Lock()
        self._served = False
        self._shut = False
        self._shut_done = threading.Event()
        self.router = router

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

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
