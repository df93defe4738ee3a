"""Core: DASE controller API, engine assembly and deploy runtime.

Counterpart of ``predictionio_tpu/core``.
"""

from predictionio_tpu_torch.core.controller import (
    Algorithm,
    AverageServing,
    DataSource,
    EmptyParams,
    FirstServing,
    IdentityPreparator,
    Params,
    PersistenceMode,
    Preparator,
    Serving,
)
from predictionio_tpu_torch.core.engine import Engine, EngineParams
from predictionio_tpu_torch.core.registry import (
    engine_registry,
    register_engine,
)

__all__ = [
    "Algorithm",
    "AverageServing",
    "DataSource",
    "EmptyParams",
    "Engine",
    "EngineParams",
    "FirstServing",
    "IdentityPreparator",
    "Params",
    "PersistenceMode",
    "Preparator",
    "Serving",
    "engine_registry",
    "register_engine",
]
