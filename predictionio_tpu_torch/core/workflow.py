"""Workflow runtime — deploy-side model recovery.

Counterpart of ``load_deployment`` in ``predictionio_tpu/core/workflow.py``.
``run_train`` comes with the training slice.
"""

from __future__ import annotations

import logging
import pickle
from typing import Any, Sequence

from predictionio_tpu_torch.core.controller import PersistenceMode
from predictionio_tpu_torch.core.engine import Engine, EngineParams
from predictionio_tpu_torch.core.persistence import (
    ModelIntegrityError,
    deserialize_models,
    load_generation,
    quarantine_generation,
)
from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.parallel.mesh import ComputeContext

logger = logging.getLogger(__name__)


def load_deployment(
    engine: Engine,
    params: EngineParams,
    engine_id: str,
    engine_version: str = "1",
    engine_variant: str = "default",
    instance_id: str | None = None,
    ctx: ComputeContext | None = None,
    storage: Storage | None = None,
):
    """Recover ``(instance, algorithms, models, serving)`` for serving.

    ``instance_id=None`` picks the newest COMPLETED instance whose model
    blob passes checksum verification and unpickles: a corrupt or
    unloadable generation is quarantined (moved aside) and the NEXT
    newest COMPLETED generation serves instead (last-good fallback). An
    explicit ``instance_id`` never falls back: its failure raises after
    quarantining."""
    storage = storage or get_storage()
    instances = storage.get_meta_data_engine_instances()
    explicit = instance_id is not None
    if explicit:
        instance = instances.get(instance_id)
        if instance is None:
            raise RuntimeError(f"engine instance {instance_id} not found")
        candidates = [instance]
    else:
        candidates = instances.get_completed(
            engine_id, engine_version, engine_variant
        )
        if not candidates:
            raise RuntimeError(
                f"No COMPLETED engine instance for {engine_id} "
                f"{engine_version} {engine_variant}; run train first."
            )
    ctx = ctx or ComputeContext.create(batch=f"serving:{engine_id}")

    algorithms = engine.make_algorithms(params)
    needs_blob = any(
        a.persistence_mode == PersistenceMode.AUTO for a in algorithms
    )
    stored: Sequence[Any] | None
    instance = candidates[0]
    if needs_blob:
        models_backend = storage.get_model_data_models()
        stored = None
        last_error: Exception | None = None
        for candidate in candidates:
            try:
                blob = load_generation(models_backend, candidate.id)
                # a blob that passed (or predates) checksums can still be
                # an unreadable pickle: for fallback both are the same
                # failure — this generation cannot serve
                entries = deserialize_models(blob)
            except (
                ModelIntegrityError,
                pickle.UnpicklingError,
                ValueError,
                EOFError,
                KeyError,
            ) as e:
                last_error = e
                logger.error(
                    "model generation %s is unloadable (%s); "
                    "quarantining%s",
                    candidate.id, e,
                    "" if explicit else " and falling back to last-good",
                )
                quarantine_generation(models_backend, candidate.id)
                if explicit:
                    raise
                continue
            instance = candidate
            stored = [payload for _tag, payload in entries]
            break
        if stored is None:
            raise RuntimeError(
                f"no loadable model generation for {engine_id} "
                f"{engine_version} {engine_variant} "
                f"({len(candidates)} candidate(s) quarantined; last "
                f"error: {last_error})"
            )
    else:
        stored = [None] * len(algorithms)
    algorithms, models, serving = engine.prepare_deploy(
        ctx, params, instance.id, stored
    )
    return instance, algorithms, models, serving
