"""Core: DASE controller API, engine assembly and deploy runtime.

Counterpart of ``predictionio_tpu/core`` for the serving slice.
"""

from predictionio_tpu_torch.core.controller import (
    Algorithm,
    DataSource,
    EmptyParams,
    FirstServing,
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
    "DataSource",
    "EmptyParams",
    "Engine",
    "EngineParams",
    "FirstServing",
    "Params",
    "PersistenceMode",
    "Preparator",
    "Serving",
    "engine_registry",
    "register_engine",
]
