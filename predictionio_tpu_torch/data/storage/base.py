"""Storage records and DAO interfaces that deploy reads.

Counterpart of the ``EngineInstance`` and ``Model`` records and the
``EngineInstancesBackend`` / ``ModelsBackend`` interfaces of
``predictionio_tpu/data/storage/base.py``. Event storage, apps and keys
come with the event-server slice.
"""

from __future__ import annotations

import abc
import dataclasses
import datetime as _dt


class StorageError(RuntimeError):
    """Unknown backend types, unbound repositories, unsupported DAOs."""


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
class Model:
    """Serialized model blob."""

    id: str
    models: bytes


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


class ModelsBackend(abc.ABC):
    """Blob store for trained models. ``insert`` must be atomic per
    blob: a reader never observes a partially-written model."""

    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Model | None: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> bool: ...

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
