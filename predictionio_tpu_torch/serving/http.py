"""Minimal threaded HTTP routing layer.

Counterpart of ``Request``, ``Response``, ``HTTPError``, ``Router`` and
``HTTPServer`` in ``predictionio_tpu/serving/http.py``, on the standard
library's ``ThreadingHTTPServer``: thread per connection, JSON bodies,
``X-Request-ID`` forwarded or minted, the base ``GET /healthz`` probe
answered before routing, access keys blanked out of the access log.
TLS, SLO scoring, admission control, draining, the probe's extras and
the metrics routes come with later slices.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qs, urlparse

logger = logging.getLogger(__name__)

Handler = Callable[["Request"], "Response"]

#: keys travel in query strings; they must never land in logs
_ACCESS_KEY = re.compile(r"(accessKey=)[^&\s\"]+")


def redact_keys(text: str) -> str:
    """Blank accessKey values out of a URL or log line."""
    return _ACCESS_KEY.sub(r"\1[redacted]", text)


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


class HTTPServer:
    """Threaded server wrapping a Router; ``start()`` serves on a daemon
    thread, ``shutdown()`` stops it and closes the socket."""

    def __init__(
        self,
        router: Router,
        host: str = "0.0.0.0",
        port: int = 0,
        service: str = "http",
    ):
        router_ref = router

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # header and body go out in one write; without NODELAY Nagle
            # + delayed ACK add ~40 ms to every keep-alive request
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # route through logging
                line = redact_keys(fmt % args)
                logger.debug("%s %s", self.address_string(), line)

            def _handle(self):
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
                request.request_id = (
                    self.headers.get("X-Request-ID") or uuid.uuid4().hex
                )
                try:
                    if parsed.path == "/healthz" and self.command == "GET":
                        # the liveness probe answers before routing
                        response = Response(200, {
                            "status": "ok", "service": service,
                            "pid": os.getpid(),
                        })
                    else:
                        response = router_ref.dispatch(request)
                except HTTPError as e:
                    response = Response(
                        e.status, {"message": e.message},
                        headers=dict(e.headers),
                    )
                except json.JSONDecodeError as e:
                    response = Response(400, {"message": f"bad JSON: {e}"})
                except Exception as e:  # noqa: BLE001 - server boundary
                    logger.exception("handler error (%s)", service)
                    response = Response(500, {"message": str(e)})
                if response.status >= 400 and isinstance(
                    response.body, dict
                ):
                    # error bodies carry the ID so a client report can
                    # be joined against server logs
                    response.body = {
                        **response.body, "requestId": request.request_id
                    }
                payload = response.payload()
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
        self.router = router

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def add_shutdown_hook(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` after the server has stopped taking requests."""
        self._shutdown_hooks.append(fn)

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for fn in self._shutdown_hooks:
            fn()
