"""Env-var-driven storage for the three repositories.

Counterpart of ``Storage`` in ``predictionio_tpu/data/storage/__init__.py``
with the same variables: sources are declared with
``PIO_STORAGE_SOURCES_<NAME>_TYPE`` (+ per-source keys such as ``PATH``)
and bound with ``PIO_STORAGE_REPOSITORIES_<REPO>_SOURCE`` for METADATA
(apps, channels, engine instances), EVENTDATA (events) and MODELDATA
(model blobs). The port knows two backend types: ``memory`` (all of
them) and ``localfs`` (models only); sqlite and the native event log
come with the event-server slice. With no source declared, metadata and
events live in memory and models under ``$PIO_FS_BASEDIR/models``
(default ``~/.piotpu/models``), the JAX package's model directory.
"""

from __future__ import annotations

import os
import threading
from typing import Mapping

from predictionio_tpu_torch.data.storage import localfs, memory
from predictionio_tpu_torch.data.storage.base import (
    App,
    AppsBackend,
    Channel,
    ChannelsBackend,
    EngineInstance,
    EngineInstancesBackend,
    EventsBackend,
    Model,
    ModelsBackend,
    StorageError,
)

__all__ = [
    "App", "AppsBackend", "Channel", "ChannelsBackend", "EngineInstance",
    "EngineInstancesBackend", "EventsBackend", "Model", "ModelsBackend",
    "Storage", "StorageError", "get_storage", "set_storage",
]


class _MemoryClient:
    def __init__(self, config: dict):
        self.apps = memory.MemoryApps()
        self.channels = memory.MemoryChannels()
        self.engine_instances = memory.MemoryEngineInstances()
        self.models = memory.MemoryModels()
        self.events = memory.MemoryEvents()


_MEMORY_DAOS = ("apps", "channels", "engine_instances", "models", "events")

#: type name → (client factory, {dao attribute: factory(client)})
_BACKENDS = {
    "memory": (
        _MemoryClient,
        {
            name: (lambda c, name=name: getattr(c, name))
            for name in _MEMORY_DAOS
        },
    ),
    "localfs": (
        lambda config: config,
        {"models": lambda config: localfs.LocalFSModels(config)},
    ),
}

_REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")


class Storage:
    """One configured storage environment."""

    def __init__(self, env: Mapping[str, str] | None = None):
        self._env = dict(env if env is not None else os.environ)
        self._clients: dict[str, object] = {}
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
                    f"{type_name!r} (this package knows: {sorted(_BACKENDS)})"
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
        base = self._env.get(
            "PIO_FS_BASEDIR",
            os.path.join(os.path.expanduser("~"), ".piotpu"),
        )
        self._specs = {
            "MEMORY": ("memory", {"TYPE": "memory"}),
            "LOCALFS": (
                "localfs",
                {"TYPE": "localfs", "PATH": os.path.join(base, "models")},
            ),
        }
        self._repo_source = {
            "METADATA": "MEMORY",
            "EVENTDATA": "MEMORY",
            "MODELDATA": "LOCALFS",
        }

    def _client(self, source: str):
        with self._lock:
            if source not in self._clients:
                type_name, conf = self._specs[source]
                self._clients[source] = _BACKENDS[type_name][0](conf)
            return self._clients[source]

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
        type_name, _conf = self._specs[source]
        factory = _BACKENDS[type_name][1].get(attr)
        if factory is None:
            raise StorageError(
                f"storage source {source} does not support {attr} "
                f"(repository {repo})"
            )
        return factory(self._client(source))

    def get_meta_data_apps(self) -> AppsBackend:
        return self._dao("METADATA", "apps")

    def get_meta_data_channels(self) -> ChannelsBackend:
        return self._dao("METADATA", "channels")

    def get_meta_data_engine_instances(self) -> EngineInstancesBackend:
        return self._dao("METADATA", "engine_instances")

    def get_model_data_models(self) -> ModelsBackend:
        return self._dao("MODELDATA", "models")

    def get_events(self) -> EventsBackend:
        return self._dao("EVENTDATA", "events")


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
