"""Admin REST API (reference tools/.../admin/AdminAPI.scala:73-157,
default port 7071): app management over HTTP, sharing logic with the
console's app commands (reference CommandClient.scala:64-174).

Counterpart of ``predictionio_tpu/serving/admin.py``, with the same
routes, statuses and bodies, on the port's HTTP server and
``cli/commands.py``.
"""

from __future__ import annotations

from predictionio_tpu_torch.cli.commands import (
    CommandError,
    create_app,
    delete_app,
    delete_app_data,
)
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


class AdminServer:
    def __init__(
        self,
        storage: Storage | None = None,
        registry: MetricRegistry | None = None,
    ):
        self._storage = storage or get_storage()
        self.registry = registry if registry is not None else get_registry()
        self.router = Router()
        r = self.router
        install_metrics_routes(r, self.registry)
        r.route("GET", "/", self._status)
        r.route("GET", "/cmd/app", self._list)
        r.route("POST", "/cmd/app", self._new)
        r.route("DELETE", "/cmd/app/<name>", self._delete)
        r.route("DELETE", "/cmd/app/<name>/data", self._data_delete)

    def _status(self, request: Request) -> Response:
        return Response(200, {"status": "alive"})

    def _list(self, request: Request) -> Response:
        apps = self._storage.get_meta_data_apps().get_all()
        keys = self._storage.get_meta_data_access_keys()
        return Response(
            200,
            [
                {
                    "name": a.name,
                    "id": a.id,
                    "accessKeys": [k.key for k in keys.get_by_app_id(a.id)],
                }
                for a in apps
            ],
        )

    def _new(self, request: Request) -> Response:
        body = request.json() or {}
        name = body.get("name")
        if not name:
            raise HTTPError(400, "app name is required")
        try:
            info = create_app(
                name,
                description=body.get("description"),
                storage=self._storage,
            )
        except CommandError as e:
            raise HTTPError(409, str(e)) from e
        return Response(
            201,
            {
                "name": name,
                "id": info["app_id"],
                "accessKey": info["access_key"],
            },
        )

    def _delete(self, request: Request) -> Response:
        try:
            delete_app(request.path_params["name"], storage=self._storage)
        except CommandError as e:
            raise HTTPError(404, str(e)) from e
        return Response(200, {"message": "deleted"})

    def _data_delete(self, request: Request) -> Response:
        try:
            delete_app_data(
                request.path_params["name"], storage=self._storage
            )
        except CommandError as e:
            raise HTTPError(404, str(e)) from e
        return Response(200, {"message": "data deleted"})


def create_admin_server(
    host: str = "0.0.0.0",
    port: int = 7071,
    storage: Storage | None = None,
    server_config=None,
) -> HTTPServer:
    """An HTTP server on an :class:`AdminServer`; ``start()`` it.
    ``server_config`` gives it TLS and key auth; the reference AdminAPI
    has neither, so unlike the dashboard nothing is read from the
    environment by default."""
    server = AdminServer(storage)
    return HTTPServer(
        server.router,
        host=host,
        port=port,
        server_config=server_config,
        service="adminserver",
        registry=server.registry,
    )
