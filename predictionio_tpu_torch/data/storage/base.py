"""Storage records and DAO interfaces that training and deploy use.

Counterpart of ``predictionio_tpu/data/storage/base.py``: the ``App``,
``AccessKey``, ``Channel``, ``EngineManifest``, ``EngineInstance``,
``EvaluationInstance`` and ``Model`` records and one DAO interface for
each (the events one with a default ``aggregate_properties``), plus
``PartialBatchError`` for batch inserts that fail partway.
"""

from __future__ import annotations

import abc
import dataclasses
import datetime as _dt
import secrets
from typing import Iterable, Iterator, Sequence

from predictionio_tpu_torch.data import aggregation
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event


class StorageError(RuntimeError):
    """Unknown backend types, unbound repositories, unsupported DAOs."""


class PartialBatchError(StorageError):
    """A batch insert failed partway; ``inserted_ids`` are the events
    durably stored BEFORE the failure (an append-only backend cannot roll
    them back), so callers can report per-event success and clients
    resend only the unsaved suffix."""

    def __init__(self, message: str, inserted_ids: list[str]):
        super().__init__(message)
        self.inserted_ids = inserted_ids


@dataclasses.dataclass(frozen=True)
class App:
    id: int
    name: str
    description: str | None = None


@dataclasses.dataclass(frozen=True)
class AccessKey:
    """An app's event-API key; empty ``events`` allows every event."""

    key: str
    appid: int
    events: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Channel:
    """A named event channel of an app (name: 1-16 word characters)."""

    id: int
    name: str
    appid: int

    @staticmethod
    def is_valid_name(name: str) -> bool:
        return (
            0 < len(name) <= 16
            and all(c.isalnum() or c in "-_" for c in name)
        )


@dataclasses.dataclass(frozen=True)
class EngineManifest:
    """A registered engine build, keyed by (id, version)."""

    id: str
    version: str
    name: str
    description: str | None = None
    files: tuple[str, ...] = ()
    engine_factory: str = ""


@dataclasses.dataclass(frozen=True)
class EngineInstance:
    """A train/deploy run record."""

    id: str
    status: str  # INIT | TRAINING | COMPLETED | FAILED
    start_time: _dt.datetime
    end_time: _dt.datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    mesh_conf: dict[str, str] = dataclasses.field(default_factory=dict)
    data_source_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"


@dataclasses.dataclass(frozen=True)
class EvaluationInstance:
    """An evaluation run record."""

    id: str
    status: str  # INIT | EVALUATING | EVALCOMPLETED
    start_time: _dt.datetime
    end_time: _dt.datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclasses.dataclass(frozen=True)
class Model:
    """Serialized model blob."""

    id: str
    models: bytes


class AppsBackend(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> int | None:
        """Insert; ``app.id == 0`` means auto-assign. Returns assigned id."""

    @abc.abstractmethod
    def get(self, app_id: int) -> App | None: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> App | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeysBackend(abc.ABC):
    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> str | None:
        """Insert; empty ``key`` means generate one. Returns the key."""

    @abc.abstractmethod
    def get(self, key: str) -> AccessKey | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[AccessKey]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def update(self, access_key: AccessKey) -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...

    @staticmethod
    def generate_key() -> str:
        """64 url-safe random characters."""
        return secrets.token_urlsafe(48)


class ChannelsBackend(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> int | None: ...

    @abc.abstractmethod
    def get(self, channel_id: int) -> Channel | None: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


class EngineManifestsBackend(abc.ABC):
    @abc.abstractmethod
    def insert(self, manifest: EngineManifest) -> None: ...

    @abc.abstractmethod
    def get(self, manifest_id: str, version: str) -> EngineManifest | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineManifest]: ...

    @abc.abstractmethod
    def update(self, manifest: EngineManifest, upsert: bool = False) -> None: ...

    @abc.abstractmethod
    def delete(self, manifest_id: str, version: str) -> bool: ...


class EngineInstancesBackend(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str:
        """Insert; empty ``id`` means auto-assign. Returns the id."""

    @abc.abstractmethod
    def get(self, instance_id: str) -> EngineInstance | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        """Latest COMPLETED instance — what deploy picks up."""

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class EvaluationInstancesBackend(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> EvaluationInstance | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class ModelsBackend(abc.ABC):
    """Blob store for trained models. ``insert`` must be atomic per
    blob: a reader never observes a partially-written model."""

    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Model | None: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> bool: ...

    def list_ids(self) -> list[str] | None:
        """Enumerate stored blob ids, or ``None`` when the backend
        cannot (a plain KV store with no scan). The store server's
        ``GET /models`` lists them."""
        return None

    def quarantine(self, model_id: str) -> bool:
        """Move a corrupt blob aside so no later read can pick it up,
        keeping the bytes. Default: re-insert under a ``quarantined/``
        id and delete the original. Returns False when it is absent."""
        record = self.get(model_id)
        if record is None:
            return False
        self.insert(
            Model(id=f"quarantined/{model_id}", models=record.models)
        )
        self.delete(model_id)
        return True


class EventsBackend(abc.ABC):
    """Event DAO. Every method takes ``(app_id, channel_id)``;
    ``channel_id=None`` is the app's default channel."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        """Initialize storage for an (app, channel)."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        """Drop all events of an (app, channel)."""

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def insert(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> str:
        """Insert one event; returns the assigned event id."""

    def insert_batch(
        self,
        events: Sequence[Event],
        app_id: int,
        channel_id: int | None = None,
    ) -> list[str]:
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None: ...

    @abc.abstractmethod
    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool: ...

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None | type(...) = ...,
        target_entity_id: str | None | type(...) = ...,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        """Filtered scan, time-ascending (descending when ``reversed``).

        ``target_entity_type``/``target_entity_id`` are tri-state:
        ``...`` (Ellipsis) = no filter, ``None`` = must be absent, a
        string = must match.
        """

    def aggregate_properties(
        self,
        app_id: int,
        channel_id: int | None = None,
        *,
        entity_type: str,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        required: Iterable[str] | None = None,
    ) -> dict[str, PropertyMap]:
        """Fold the entity type's ``$set/$unset/$delete`` events into
        ``{entity_id: PropertyMap}``; with ``required``, only entities
        holding every one of those keys."""
        if not entity_type:
            raise ValueError("entity_type is required for aggregation")
        events = self.find(
            app_id,
            channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=["$set", "$unset", "$delete"],
        )
        result = aggregation.aggregate_properties(events)
        if required is not None:
            req = list(required)
            result = {
                eid: pm
                for eid, pm in result.items()
                if all(k in pm for k in req)
            }
        return result
