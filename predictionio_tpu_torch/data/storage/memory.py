"""In-process storage: every DAO with plain dicts behind a lock.

Counterpart of ``predictionio_tpu/data/storage/memory.py``: apps, access
keys, channels, engine manifests, engine and evaluation instances, model
blobs and events.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import itertools
import threading
import uuid
from typing import Iterator, Sequence

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
)


class MemoryApps(AppsBackend):
    def __init__(self, config=None):
        self._lock = threading.Lock()
        self._apps: dict[int, App] = {}
        self._next = itertools.count(1)

    def insert(self, app: App) -> int | None:
        with self._lock:
            app_id = app.id if app.id > 0 else next(self._next)
            if app_id in self._apps:
                return None
            if any(a.name == app.name for a in self._apps.values()):
                return None
            self._apps[app_id] = App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> App | None:
        return self._apps.get(app_id)

    def get_by_name(self, name: str) -> App | None:
        with self._lock:
            return next(
                (a for a in self._apps.values() if a.name == name), None
            )

    def get_all(self) -> list[App]:
        return sorted(self._apps.values(), key=lambda a: a.id)

    def update(self, app: App) -> bool:
        with self._lock:
            if app.id not in self._apps:
                return False
            self._apps[app.id] = app
            return True

    def delete(self, app_id: int) -> bool:
        with self._lock:
            return self._apps.pop(app_id, None) is not None


class MemoryAccessKeys(AccessKeysBackend):
    def __init__(self, config=None):
        self._lock = threading.Lock()
        self._keys: dict[str, AccessKey] = {}

    def insert(self, access_key: AccessKey) -> str | None:
        with self._lock:
            key = access_key.key or self.generate_key()
            if key in self._keys:
                return None
            self._keys[key] = AccessKey(
                key, access_key.appid, tuple(access_key.events)
            )
            return key

    def get(self, key: str) -> AccessKey | None:
        return self._keys.get(key)

    def get_all(self) -> list[AccessKey]:
        return list(self._keys.values())

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [k for k in self._keys.values() if k.appid == app_id]

    def update(self, access_key: AccessKey) -> bool:
        with self._lock:
            if access_key.key not in self._keys:
                return False
            self._keys[access_key.key] = access_key
            return True

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._keys.pop(key, None) is not None


class MemoryChannels(ChannelsBackend):
    def __init__(self, config=None):
        self._lock = threading.Lock()
        self._channels: dict[int, Channel] = {}
        self._next = itertools.count(1)

    def insert(self, channel: Channel) -> int | None:
        if not Channel.is_valid_name(channel.name):
            return None
        with self._lock:
            cid = channel.id if channel.id > 0 else next(self._next)
            if cid in self._channels:
                return None
            if any(
                c.appid == channel.appid and c.name == channel.name
                for c in self._channels.values()
            ):
                return None
            self._channels[cid] = Channel(cid, channel.name, channel.appid)
            return cid

    def get(self, channel_id: int) -> Channel | None:
        return self._channels.get(channel_id)

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [c for c in self._channels.values() if c.appid == app_id]

    def delete(self, channel_id: int) -> bool:
        with self._lock:
            return self._channels.pop(channel_id, None) is not None


class MemoryEngineInstances(EngineInstancesBackend):
    def __init__(self, config=None):
        self._lock = threading.Lock()
        self._instances: dict[str, EngineInstance] = {}

    def insert(self, instance: EngineInstance) -> str:
        with self._lock:
            iid = instance.id or uuid.uuid4().hex
            self._instances[iid] = dataclasses.replace(instance, id=iid)
            return iid

    def get(self, instance_id: str) -> EngineInstance | None:
        return self._instances.get(instance_id)

    def get_all(self) -> list[EngineInstance]:
        return list(self._instances.values())

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        out = [
            i
            for i in self._instances.values()
            if i.status == "COMPLETED"
            and i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        return sorted(out, key=lambda i: i.start_time, reverse=True)

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        completed = self.get_completed(
            engine_id, engine_version, engine_variant
        )
        return completed[0] if completed else None

    def update(self, instance: EngineInstance) -> bool:
        with self._lock:
            if instance.id not in self._instances:
                return False
            self._instances[instance.id] = instance
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._instances.pop(instance_id, None) is not None


class MemoryEngineManifests(EngineManifestsBackend):
    def __init__(self, config=None):
        self._lock = threading.Lock()
        self._manifests: dict[tuple[str, str], EngineManifest] = {}

    def insert(self, manifest: EngineManifest) -> None:
        with self._lock:
            self._manifests[(manifest.id, manifest.version)] = manifest

    def get(self, manifest_id: str, version: str) -> EngineManifest | None:
        return self._manifests.get((manifest_id, version))

    def get_all(self) -> list[EngineManifest]:
        return list(self._manifests.values())

    def update(self, manifest: EngineManifest, upsert: bool = False) -> None:
        with self._lock:
            key = (manifest.id, manifest.version)
            if key not in self._manifests and not upsert:
                raise KeyError(f"engine manifest {key} not found")
            self._manifests[key] = manifest

    def delete(self, manifest_id: str, version: str) -> bool:
        with self._lock:
            return (
                self._manifests.pop((manifest_id, version), None) is not None
            )


class MemoryEvaluationInstances(EvaluationInstancesBackend):
    def __init__(self, config=None):
        self._lock = threading.Lock()
        self._instances: dict[str, EvaluationInstance] = {}

    def insert(self, instance: EvaluationInstance) -> str:
        with self._lock:
            iid = instance.id or uuid.uuid4().hex
            self._instances[iid] = dataclasses.replace(instance, id=iid)
            return iid

    def get(self, instance_id: str) -> EvaluationInstance | None:
        return self._instances.get(instance_id)

    def get_all(self) -> list[EvaluationInstance]:
        return list(self._instances.values())

    def get_completed(self) -> list[EvaluationInstance]:
        out = [
            i for i in self._instances.values() if i.status == "EVALCOMPLETED"
        ]
        return sorted(out, key=lambda i: i.start_time, reverse=True)

    def update(self, instance: EvaluationInstance) -> bool:
        with self._lock:
            if instance.id not in self._instances:
                return False
            self._instances[instance.id] = instance
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._instances.pop(instance_id, None) is not None


class MemoryModels(ModelsBackend):
    def __init__(self, config=None):
        self._models: dict[str, Model] = {}

    def insert(self, model: Model) -> None:
        self._models[model.id] = model

    def get(self, model_id: str) -> Model | None:
        return self._models.get(model_id)

    def delete(self, model_id: str) -> bool:
        return self._models.pop(model_id, None) is not None

    def list_ids(self) -> list[str] | None:
        return sorted(self._models)


class MemoryEvents(EventsBackend):
    """Per-(app, channel) event tables behind one lock."""

    def __init__(self, config=None):
        self._lock = threading.Lock()
        self._store: dict[tuple[int, int | None], dict[str, Event]] = {}

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            self._store.setdefault((app_id, channel_id), {})
            return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        with self._lock:
            return self._store.pop((app_id, channel_id), None) is not None

    def close(self) -> None:
        pass

    def insert(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> str:
        stamped = event.with_id(event.event_id)
        with self._lock:
            table = self._store.setdefault((app_id, channel_id), {})
            table[stamped.event_id] = stamped
        return stamped.event_id

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        return self._store.get((app_id, channel_id), {}).get(event_id)

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        with self._lock:
            table = self._store.get((app_id, channel_id), {})
            return table.pop(event_id, None) is not None

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        with self._lock:
            events = list(self._store.get((app_id, channel_id), {}).values())
        events.sort(key=lambda e: e.event_time, reverse=reversed)
        # naive bounds are UTC, the same rule as Event.__post_init__
        if start_time is not None and start_time.tzinfo is None:
            start_time = start_time.replace(tzinfo=_dt.timezone.utc)
        if until_time is not None and until_time.tzinfo is None:
            until_time = until_time.replace(tzinfo=_dt.timezone.utc)
        names = set(event_names) if event_names is not None else None
        if limit is not None and limit == 0:
            return
        n = 0
        for e in events:
            if start_time is not None and e.event_time < start_time:
                continue
            if until_time is not None and e.event_time >= until_time:
                continue
            if entity_type is not None and e.entity_type != entity_type:
                continue
            if entity_id is not None and e.entity_id != entity_id:
                continue
            if names is not None and e.event not in names:
                continue
            if target_entity_type is not ... and (
                e.target_entity_type != target_entity_type
            ):
                continue
            if target_entity_id is not ... and (
                e.target_entity_id != target_entity_id
            ):
                continue
            yield e
            n += 1
            if limit is not None and 0 < limit <= n:
                return
