"""Env-var-driven storage for the three repositories.

Counterpart of ``Storage`` in ``predictionio_tpu/data/storage/__init__.py``
with the same variables: sources are declared with
``PIO_STORAGE_SOURCES_<NAME>_TYPE`` (+ per-source keys such as ``PATH``)
and bound with ``PIO_STORAGE_REPOSITORIES_<REPO>_SOURCE`` for METADATA
(apps, access keys, channels, engine manifests, engine and evaluation
instances), EVENTDATA (events) and MODELDATA (model blobs). Backend
types come from a registry (``register_backend`` with a
:class:`BackendSpec`, as in the JAX package); eight are built in:
``memory`` and ``sqlite`` (every DAO), ``localfs`` (models only),
``eventlog``, the native event log (events only), and the networked
ones, each serving every DAO: ``postgres`` (``URL`` or ``HOST``/``PORT``/
``DATABASE``/``USERNAME``/``PASSWORD``; a PostgreSQL server or the
:mod:`.minipg` dev server), ``mysql`` (the same keys; MySQL or
:mod:`.minimysql`) and ``httpstore`` (``URL``, ``KEY``, ``TIMEOUT``,
``CACERT``/``VERIFY``; a store server, ``storeserver``), and
``replicated`` over N store servers (``URLS``, ``W``, ``KEY``,
``TIMEOUT``, ``CACERT``, ``VERIFY``, ``HINT_DIR``, ``HINT_LIMIT``:
quorum writes, failover reads, hinted handoff; see :mod:`.replicated`).
With no source
declared, the wiring is the JAX package's: metadata and events in
``$PIO_FS_BASEDIR/pio.sqlite``, models under ``$PIO_FS_BASEDIR/models``
(default base ``~/.piotpu``).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Callable, Mapping

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import (
    eventlog,
    localfs,
    memory,
    sql_common,
    sqlite,
)
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
    StorageError,
)

__all__ = [
    "AccessKey", "AccessKeysBackend", "App", "AppsBackend", "BackendSpec",
    "Channel", "ChannelsBackend", "EngineInstance", "EngineInstancesBackend",
    "EngineManifest", "EngineManifestsBackend", "EvaluationInstance",
    "EvaluationInstancesBackend", "EventsBackend", "Model",
    "ModelsBackend", "Storage", "StorageError", "get_storage",
    "register_backend", "set_storage",
]


@dataclass
class BackendSpec:
    """Factories for one backend type: ``client(config)`` builds the
    source's client, and each DAO factory takes that client. A DAO left
    None means the backend does not serve that repository (``localfs``
    holds models only, ``eventlog`` events only)."""

    client: Callable[[dict], object]
    apps: Callable[[object], AppsBackend] | None = None
    access_keys: Callable[[object], AccessKeysBackend] | None = None
    channels: Callable[[object], ChannelsBackend] | None = None
    engine_instances: Callable[[object], EngineInstancesBackend] | None = None
    engine_manifests: Callable[[object], EngineManifestsBackend] | None = None
    evaluation_instances: (
        Callable[[object], EvaluationInstancesBackend] | None
    ) = None
    models: Callable[[object], ModelsBackend] | None = None
    events: Callable[[object], EventsBackend] | None = None


_BACKENDS: dict[str, BackendSpec] = {}


def register_backend(type_name: str, spec: BackendSpec) -> None:
    """Make ``PIO_STORAGE_SOURCES_<NAME>_TYPE=<type_name>`` build sources
    from ``spec`` (a later registration of the same name replaces the
    earlier one)."""
    _BACKENDS[type_name] = spec


class _MemoryClient:
    def __init__(self, config: dict):
        self.apps = memory.MemoryApps()
        self.access_keys = memory.MemoryAccessKeys()
        self.channels = memory.MemoryChannels()
        self.engine_instances = memory.MemoryEngineInstances()
        self.engine_manifests = memory.MemoryEngineManifests()
        self.evaluation_instances = memory.MemoryEvaluationInstances()
        self.models = memory.MemoryModels()
        self.events = memory.MemoryEvents()


_SQL_DAOS = {
    "apps": sql_common.SQLApps,
    "access_keys": sql_common.SQLAccessKeys,
    "channels": sql_common.SQLChannels,
    "engine_instances": sql_common.SQLEngineInstances,
    "engine_manifests": sql_common.SQLEngineManifests,
    "evaluation_instances": sql_common.SQLEvaluationInstances,
    "models": sql_common.SQLModels,
    "events": sql_common.SQLEvents,
}

register_backend("memory", BackendSpec(
    client=_MemoryClient,
    **{name: (lambda c, name=name: getattr(c, name)) for name in _SQL_DAOS},
))
register_backend("sqlite", BackendSpec(client=sqlite.SQLiteClient,
                                       **_SQL_DAOS))
register_backend("localfs", BackendSpec(
    client=lambda config: config,
    models=lambda config: localfs.LocalFSModels(config),
))
register_backend("eventlog", BackendSpec(
    client=eventlog.EventLogEvents, events=lambda client: client,
))


# the networked clients import lazily, so building the registry never
# probes for a driver
def _postgres_client(config: dict):
    from predictionio_tpu_torch.data.storage import postgres

    return postgres.PostgresClient(config)


def _mysql_client(config: dict):
    from predictionio_tpu_torch.data.storage import mysql

    return mysql.MySQLClient(config)


def _httpstore_client(config: dict):
    from predictionio_tpu_torch.data.storage import httpstore

    return httpstore.HTTPStoreClient(config)


def _http_dao(name: str):
    def factory(client):
        from predictionio_tpu_torch.data.storage import httpstore

        return getattr(httpstore, name)(client)

    return factory


register_backend("postgres", BackendSpec(client=_postgres_client,
                                         **_SQL_DAOS))
register_backend("mysql", BackendSpec(client=_mysql_client, **_SQL_DAOS))
register_backend("httpstore", BackendSpec(
    client=_httpstore_client,
    apps=_http_dao("HTTPApps"),
    access_keys=_http_dao("HTTPAccessKeys"),
    channels=_http_dao("HTTPChannels"),
    engine_instances=_http_dao("HTTPEngineInstances"),
    engine_manifests=_http_dao("HTTPEngineManifests"),
    evaluation_instances=_http_dao("HTTPEvaluationInstances"),
    models=_http_dao("HTTPModels"),
    events=_http_dao("HTTPEvents"),
))


# the replicated tier over N store servers: quorum writes, failover reads
# with read-repair, hinted handoff; one client owns the peer pool, every
# DAO is a fan-out wrapper
def _replicated_client(config: dict):
    from predictionio_tpu_torch.data.storage import replicated

    return replicated.ReplicatedStoreClient(config)


def _repl_dao(name: str):
    return lambda client: client.dao(name)


register_backend("replicated", BackendSpec(
    client=_replicated_client,
    apps=_repl_dao("apps"),
    access_keys=_repl_dao("access_keys"),
    channels=_repl_dao("channels"),
    engine_instances=_repl_dao("engine_instances"),
    engine_manifests=_repl_dao("engine_manifests"),
    evaluation_instances=_repl_dao("evaluation_instances"),
    models=_repl_dao("models"),
    events=_repl_dao("events"),
))

_REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")


class Storage:
    """One configured storage environment."""

    def __init__(self, env: Mapping[str, str] | None = None):
        self._env = dict(env if env is not None else os.environ)
        self._clients: dict[str, object] = {}
        self._daos: dict[tuple[str, str], object] = {}
        self._specs: dict[str, tuple[str, dict]] = {}
        self._repo_source: dict[str, str] = {}
        self._lock = threading.Lock()
        self._parse()

    def _parse(self) -> None:
        prefix = "PIO_STORAGE_SOURCES_"
        sources: dict[str, dict] = {}
        for k, v in self._env.items():
            if not k.startswith(prefix):
                continue
            name, _, key = k[len(prefix):].partition("_")
            sources.setdefault(name, {})[key] = v
        for name, conf in sources.items():
            type_name = conf.get("TYPE")
            if type_name is None:
                continue
            if type_name not in _BACKENDS:
                raise StorageError(
                    f"storage source {name}: unknown backend type "
                    f"{type_name!r} (registered: {sorted(_BACKENDS)})"
                )
            self._specs[name] = (type_name, conf)
        for repo in _REPOSITORIES:
            src = self._env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
            if src is not None:
                if src not in self._specs:
                    raise StorageError(
                        f"repository {repo} bound to undeclared source {src}"
                    )
                self._repo_source[repo] = src
        if not self._specs:
            self._default_wiring()

    def _default_wiring(self) -> None:
        """Zero-config default: sqlite for metadata and events, localfs
        models, under ``PIO_FS_BASEDIR`` (default ``~/.piotpu``)."""
        base = self._env.get(
            "PIO_FS_BASEDIR",
            os.path.join(os.path.expanduser("~"), ".piotpu"),
        )
        self._specs = {
            "SQLITE": (
                "sqlite",
                {"TYPE": "sqlite", "PATH": os.path.join(base, "pio.sqlite")},
            ),
            "LOCALFS": (
                "localfs",
                {"TYPE": "localfs", "PATH": os.path.join(base, "models")},
            ),
        }
        self._repo_source = {
            "METADATA": "SQLITE",
            "EVENTDATA": "SQLITE",
            "MODELDATA": "LOCALFS",
        }

    def _client(self, source: str):
        with self._lock:
            if source not in self._clients:
                type_name, conf = self._specs[source]
                self._clients[source] = _BACKENDS[type_name].client(conf)
            return self._clients[source]

    def _source_dao(self, source: str, attr: str, repo: str):
        type_name, _conf = self._specs[source]
        factory = getattr(_BACKENDS[type_name], attr)
        if factory is None:
            raise StorageError(
                f"storage source {source} does not support {attr} "
                f"(repository {repo})"
            )
        client = self._client(source)
        with self._lock:
            dao = self._daos.get((source, attr))
            if dao is None:
                dao = self._daos[(source, attr)] = factory(client)
            return dao

    def _dao(self, repo: str, attr: str):
        source = self._repo_source.get(repo)
        if source is None:
            if len(self._specs) == 1:
                source = next(iter(self._specs))
            else:
                raise StorageError(
                    f"repository {repo} is not bound to a source; set "
                    f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE to one of "
                    f"{sorted(self._specs)}"
                )
        return self._source_dao(source, attr, repo)

    def get_meta_data_apps(self) -> AppsBackend:
        return self._dao("METADATA", "apps")

    def get_meta_data_access_keys(self) -> AccessKeysBackend:
        return self._dao("METADATA", "access_keys")

    def get_meta_data_channels(self) -> ChannelsBackend:
        return self._dao("METADATA", "channels")

    def get_meta_data_engine_instances(self) -> EngineInstancesBackend:
        return self._dao("METADATA", "engine_instances")

    def get_meta_data_engine_manifests(self) -> EngineManifestsBackend:
        return self._dao("METADATA", "engine_manifests")

    def get_meta_data_evaluation_instances(
        self,
    ) -> EvaluationInstancesBackend:
        return self._dao("METADATA", "evaluation_instances")

    def get_model_data_models(self) -> ModelsBackend:
        return self._dao("MODELDATA", "models")

    def get_events(self) -> EventsBackend:
        return self._dao("EVENTDATA", "events")

    def backend_for_source(self, source: str) -> EventsBackend:
        """Events backend of one declared source, whatever the
        repository bindings (a migration reads one source, writes
        another)."""
        if source not in self._specs:
            raise StorageError(
                f"unknown storage source {source}; declared: "
                f"{sorted(self._specs)}"
            )
        return self._source_dao(source, "events", "EVENTDATA")

    def verify_all_data_objects(self) -> list[str]:
        """Build every DAO, then write and remove one event on app id 0;
        returns the problems found (empty = healthy)."""
        problems: list[str] = []
        for name in (
            "get_meta_data_apps",
            "get_meta_data_access_keys",
            "get_meta_data_channels",
            "get_meta_data_engine_instances",
            "get_meta_data_engine_manifests",
            "get_meta_data_evaluation_instances",
            "get_model_data_models",
        ):
            try:
                getattr(self, name)()
            except Exception as e:  # noqa: BLE001 - health check surface
                problems.append(f"{name}: {e}")
        try:
            events = self.get_events()
            events.init(0)
            eid = events.insert(
                Event(event="$set", entity_type="health", entity_id="0"), 0
            )
            events.delete(eid, 0)
            events.remove(0)
        except Exception as e:  # noqa: BLE001 - health check surface
            problems.append(f"events: {e}")
        return problems


_default_storage: Storage | None = None
_default_lock = threading.Lock()


def get_storage() -> Storage:
    """Process-default storage parsed from ``os.environ``."""
    global _default_storage
    with _default_lock:
        if _default_storage is None:
            _default_storage = Storage()
        return _default_storage


def set_storage(storage: Storage | None) -> None:
    """Override the process default (tests, embedded use)."""
    global _default_storage
    with _default_lock:
        _default_storage = storage
