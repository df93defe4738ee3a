"""Evaluation dashboard (reference tools/.../dashboard/Dashboard.scala:44-158,
default port 9000): lists completed evaluation instances with their
metric results; per-instance drill-down renders the stored HTML report.

Counterpart of ``predictionio_tpu/serving/dashboard.py``, with the same
routes and pages, on the port's HTTP server, storage and registry; like
the reference (Dashboard.scala:44-60) it takes the environment's key
auth and TLS unless it is given a ``server_config``.
"""

from __future__ import annotations

import html

from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.obs import MetricRegistry, get_registry
from predictionio_tpu_torch.serving.http import (
    HTTPError,
    HTTPServer,
    Request,
    Response,
    Router,
    install_metrics_routes,
)


class Dashboard:
    def __init__(
        self,
        storage: Storage | None = None,
        registry: MetricRegistry | None = None,
        server_config=None,
    ):
        self._storage = storage or get_storage()
        self.registry = registry if registry is not None else get_registry()
        self.router = Router()
        install_metrics_routes(
            self.router, self.registry, server_config=server_config
        )
        self.router.route("GET", "/", self._index)
        self.router.route("GET", "/engine_instances/<iid>", self._detail)

    def _index(self, request: Request) -> Response:
        instances = (
            self._storage.get_meta_data_evaluation_instances().get_completed()
        )
        rows = "".join(
            f"<tr><td><a href='/engine_instances/{i.id}'>{i.id[:8]}</a></td>"
            f"<td>{html.escape(i.evaluation_class)}</td>"
            f"<td>{i.start_time.isoformat()}</td>"
            f"<td>{html.escape(i.evaluator_results)}</td></tr>"
            for i in instances
        )
        body = (
            "<html><head><title>PredictionIO-TPU Dashboard</title></head>"
            "<body><h1>Completed Evaluations</h1>"
            "<table border='1'><tr><th>id</th><th>evaluation</th>"
            f"<th>started</th><th>result</th></tr>{rows}</table>"
            "</body></html>"
        )
        return Response(200, body, content_type="text/html")

    def _detail(self, request: Request) -> Response:
        iid = request.path_params["iid"]
        inst = self._storage.get_meta_data_evaluation_instances().get(iid)
        if inst is None:
            raise HTTPError(404, "evaluation instance not found")
        body = (
            f"<html><body><h1>Evaluation {inst.id}</h1>"
            f"<p>{html.escape(inst.evaluator_results)}</p>"
            f"{inst.evaluator_results_html}"
            f"<h2>JSON</h2><pre>{html.escape(inst.evaluator_results_json)}"
            "</pre></body></html>"
        )
        return Response(200, body, content_type="text/html")


def create_dashboard(
    host: str = "0.0.0.0",
    port: int = 9000,
    storage: Storage | None = None,
    server_config=None,
    registry: MetricRegistry | None = None,
) -> HTTPServer:
    """An HTTP server on a :class:`Dashboard`; ``start()`` it. With
    ``server_config`` None the environment's key auth and TLS apply."""
    from predictionio_tpu_torch.serving.config import ServerConfig

    if server_config is None:
        server_config = ServerConfig.from_env()
    dashboard = Dashboard(
        storage, registry=registry, server_config=server_config
    )
    return HTTPServer(
        dashboard.router,
        host=host,
        port=port,
        server_config=server_config,
        service="dashboard",
        registry=dashboard.registry,
    )
