"""Server plugins: input/output blockers and sniffers.

Counterpart of ``predictionio_tpu/serving/plugins.py``:

* event-server plugins: ``inputblocker`` plugins run before storage and
  may reject an event (:class:`PluginRejection`); ``inputsniffer``
  plugins observe accepted events off the request thread and may serve
  REST under ``/plugins/...``;
* engine-server plugins: ``outputblocker`` plugins fold over a
  prediction, ``outputsniffer`` plugins observe (query, prediction)
  pairs. The port's engine server does not take plugins yet (ROADMAP.md,
  queue 1, item 5).

Plugins are passed to :class:`PluginContext`, or named in ``PIO_PLUGINS``
(comma-separated ``module:attr`` specs).
"""

from __future__ import annotations

import importlib
import logging
import os
import queue
import threading
from typing import Any, Callable

logger = logging.getLogger(__name__)

# plugin_type values (reference EventServerPlugin.scala:25-26,
# EngineServerPlugin.scala:28-29)
INPUT_BLOCKER = "inputblocker"
INPUT_SNIFFER = "inputsniffer"
OUTPUT_BLOCKER = "outputblocker"
OUTPUT_SNIFFER = "outputsniffer"


class Plugin:
    """Base for all server plugins.

    Subclasses set ``plugin_name``, ``plugin_description`` and
    ``plugin_type`` (one of the four type constants), mirroring the
    reference's trait vals.
    """

    plugin_name: str = "plugin"
    plugin_description: str = ""
    plugin_type: str = INPUT_SNIFFER

    def start(self, context: dict[str, Any]) -> None:
        """Called once when the owning server starts."""

    def handle_rest(
        self, path: str, query: dict[str, str]
    ) -> Any:
        """Serve ``GET /plugins/<type>/<name>/<path>`` (sniffers)."""
        raise NotImplementedError(
            f"plugin {self.plugin_name} exposes no REST interface"
        )


class EventServerPlugin(Plugin):
    """Event-side plugin (reference EventServerPlugin.scala:21-40)."""

    def process(self, event_json: dict, app_id: int,
                channel_id: int | None) -> None:
        """Input blockers: raise :class:`PluginRejection` to reject the
        event before it reaches storage. Input sniffers: observe
        (called asynchronously off the request thread)."""


class EngineServerPlugin(Plugin):
    """Engine-side plugin (reference EngineServerPlugin.scala:21-40)."""

    def process(
        self, engine_info: dict, query: dict, prediction: Any
    ) -> Any:
        """Output blockers: return the (possibly modified) prediction —
        returns are folded in registration order
        (CreateServer.scala:603-606). Output sniffers: observe; the
        return value is ignored."""
        return prediction


class PluginRejection(Exception):
    """Raised by an input blocker to reject an event (HTTP 403)."""

    def __init__(self, message: str, status: int = 403):
        super().__init__(message)
        self.status = status


class PluginNotFound(LookupError):
    """No plugin with the requested type+name is registered."""


def load_plugin_spec(spec: str) -> Plugin:
    """Instantiate a plugin from a ``module:attr`` spec."""
    module_name, _, attr = spec.partition(":")
    if not attr:
        raise ValueError(
            f"plugin spec {spec!r} must look like 'module:attr'"
        )
    obj = getattr(importlib.import_module(module_name), attr)
    return obj() if isinstance(obj, type) else obj


def plugins_from_env(env_var: str = "PIO_PLUGINS") -> list[Plugin]:
    """Load plugins named in ``PIO_PLUGINS`` (comma-separated specs)."""
    raw = os.environ.get(env_var, "").strip()
    if not raw:
        return []
    plugins = []
    for spec in raw.split(","):
        spec = spec.strip()
        if not spec:
            continue
        try:
            plugins.append(load_plugin_spec(spec))
        except Exception:  # noqa: BLE001 - a bad plugin must not kill boot
            logger.exception("failed to load plugin %r", spec)
    return plugins


class _SnifferDispatcher:
    """Async fan-out to sniffer plugins — the PluginsActor analogue.

    Sniffer callbacks run on a single daemon thread so a slow or broken
    sniffer can never block the request hot path.
    """

    def __init__(self) -> None:
        self._queue: queue.Queue = queue.Queue(maxsize=10_000)
        self._thread: threading.Thread | None = None
        self._thread_lock = threading.Lock()
        self._closed = False

    def _ensure_thread(self) -> None:
        with self._thread_lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="plugin-sniffers",
                )
                self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:  # noqa: BLE001
                logger.exception("sniffer plugin failed")

    def submit(self, fn: Callable, *args) -> None:
        if self._closed:
            return
        self._ensure_thread()
        try:
            self._queue.put_nowait((fn, args))
        except queue.Full:
            logger.warning("sniffer queue full; dropping notification")

    def close(self) -> None:
        # shutdown contract: the sentinel lets already-queued sniffer
        # notifications drain, and the bounded join gives them a
        # window to finish — daemon=True remains the backstop so a
        # wedged sniffer callback can only cost close() the timeout,
        # never hang process exit
        self._closed = True
        with self._thread_lock:
            thread = self._thread
        if thread is not None and thread.is_alive():
            try:
                # never a blocking put: with the queue full AND the
                # drain thread wedged, close() would hang on the
                # sentinel before ever reaching the bounded join
                self._queue.put_nowait(None)
            except queue.Full:
                pass  # wedged + full — skip straight to the timed join
            thread.join(timeout=2.0)
            if thread.is_alive():
                logger.warning(
                    "sniffer thread still draining at close(); "
                    "abandoning it (daemon)"
                )


class PluginContext:
    """Holds a server's plugins, split by type.

    Reference: EventServerPluginContext.scala:30-60 /
    EngineServerPluginContext.scala:35-88 (there built from
    ServiceLoader; here from explicit lists + ``PIO_PLUGINS``).
    """

    def __init__(
        self,
        plugins: list[Plugin] | None = None,
        load_env: bool = True,
    ):
        self.plugins: list[Plugin] = list(plugins or [])
        if load_env:
            self.plugins.extend(plugins_from_env())
        self._dispatcher = _SnifferDispatcher()
        for p in self.plugins:
            try:
                p.start({})
            except Exception:  # noqa: BLE001
                logger.exception(
                    "plugin %s failed to start", p.plugin_name
                )

    def of_type(self, plugin_type: str) -> list[Plugin]:
        return [
            p for p in self.plugins if p.plugin_type == plugin_type
        ]

    @property
    def input_blockers(self) -> list[Plugin]:
        return self.of_type(INPUT_BLOCKER)

    @property
    def input_sniffers(self) -> list[Plugin]:
        return self.of_type(INPUT_SNIFFER)

    @property
    def output_blockers(self) -> list[Plugin]:
        return self.of_type(OUTPUT_BLOCKER)

    @property
    def output_sniffers(self) -> list[Plugin]:
        return self.of_type(OUTPUT_SNIFFER)

    # -- hot-path helpers -------------------------------------------------
    def block_input(
        self, event_json: dict, app_id: int, channel_id: int | None
    ) -> None:
        """Run input blockers synchronously; raises PluginRejection."""
        for p in self.input_blockers:
            p.process(event_json, app_id, channel_id)

    def sniff_input(
        self, event_json: dict, app_id: int, channel_id: int | None
    ) -> None:
        """Notify input sniffers asynchronously."""
        for p in self.input_sniffers:
            self._dispatcher.submit(
                p.process, event_json, app_id, channel_id
            )

    def block_output(
        self, engine_info: dict, query: dict, prediction: Any
    ) -> Any:
        """Fold output blockers over the prediction."""
        for p in self.output_blockers:
            prediction = p.process(engine_info, query, prediction)
        return prediction

    def sniff_output(
        self, engine_info: dict, query: dict, prediction: Any
    ) -> None:
        """Notify output sniffers asynchronously."""
        for p in self.output_sniffers:
            self._dispatcher.submit(
                p.process, engine_info, query, prediction
            )

    # -- REST surface -----------------------------------------------------
    def describe(self) -> dict:
        """``GET /plugins.json`` body (reference ServerActor:658-678)."""
        return {
            "plugins": {
                p.plugin_name: {
                    "name": p.plugin_name,
                    "description": p.plugin_description,
                    "class": type(p).__name__,
                    "type": p.plugin_type,
                }
                for p in self.plugins
            }
        }

    def handle_rest(
        self, plugin_type: str, name: str, path: str,
        query: dict[str, str],
    ) -> Any:
        """Dispatch ``GET /plugins/<type>/<name>/<path>``.

        Raises :class:`PluginNotFound` for an unknown plugin; plugin
        exceptions (including KeyError) propagate unchanged so they
        surface as plugin errors, not 404s.
        """
        for p in self.of_type(plugin_type):
            if p.plugin_name == name:
                break
        else:
            raise PluginNotFound(f"{plugin_type}/{name}")
        return p.handle_rest(path, query)

    def close(self) -> None:
        self._dispatcher.close()


def install_plugin_routes(
    router, plugins: PluginContext, sniffer_type: str
) -> None:
    """Register ``GET /plugins.json`` + ``GET /plugins/<type>/<name>/…``
    on a server router (shared by the event and engine servers;
    reference ServerActor:658-678 / EventServer plugin routes).
    ``sniffer_type`` is the plugin type whose REST surface this server
    exposes (inputsniffer vs outputsniffer).
    """
    from predictionio_tpu_torch.serving.http import HTTPError, Response

    def plugins_json(request):
        return Response(200, plugins.describe())

    def plugin_rest(request):
        p = request.path_params
        if p["ptype"] != sniffer_type:
            raise HTTPError(404, "unknown plugin type")
        try:
            body = plugins.handle_rest(
                p["ptype"], p["pname"], p["rest"], dict(request.query)
            )
        except PluginNotFound as e:
            raise HTTPError(404, "plugin not found") from e
        return Response(200, body)

    router.route("GET", "/plugins.json", plugins_json)
    router.route(
        "GET", "/plugins/<ptype>/<pname>/<rest:path>", plugin_rest
    )
