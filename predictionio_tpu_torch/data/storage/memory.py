"""In-process storage: engine instances and model blobs.

Counterpart of ``MemoryEngineInstances`` and ``MemoryModels`` in
``predictionio_tpu/data/storage/memory.py``.
"""

from __future__ import annotations

import dataclasses
import threading
import uuid

from predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    EngineInstancesBackend,
    Model,
    ModelsBackend,
)


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


class MemoryModels(ModelsBackend):
    def __init__(self, config=None):
        self._models: dict[str, Model] = {}

    def insert(self, model: Model) -> None:
        self._models[model.id] = model

    def get(self, model_id: str) -> Model | None:
        return self._models.get(model_id)

    def delete(self, model_id: str) -> bool:
        return self._models.pop(model_id, None) is not None
