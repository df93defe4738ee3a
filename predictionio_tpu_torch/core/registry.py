"""Engine registry: factories register by name, or resolve by dotted
import path ``"package.module:factory"``.

Counterpart of ``predictionio_tpu/core/registry.py``.
"""

from __future__ import annotations

import importlib

from predictionio_tpu_torch.core.engine import EngineFactory

_REGISTRY: dict[str, EngineFactory] = {}


def register_engine(name: str, factory: EngineFactory | None = None):
    """Register an engine factory; usable as a decorator."""

    def _register(f: EngineFactory) -> EngineFactory:
        _REGISTRY[name] = f
        return f

    if factory is not None:
        return _register(factory)
    return _register


def engine_registry() -> dict[str, EngineFactory]:
    return dict(_REGISTRY)


def resolve_engine_factory(name: str) -> EngineFactory:
    """Look up a registered name, or import ``"pkg.module:attr"`` /
    ``"pkg.module.attr"`` dotted paths."""
    # built-in templates self-register on import
    import predictionio_tpu_torch.models  # noqa: F401

    if name in _REGISTRY:
        return _REGISTRY[name]
    module_name, sep, attr = name.partition(":")
    if not sep:
        module_name, _, attr = name.rpartition(".")
    if module_name:
        try:
            module = importlib.import_module(module_name)
            factory = getattr(module, attr)
        except (ImportError, AttributeError) as e:
            raise KeyError(
                f"engine factory {name!r} not registered and not importable: {e}"
            ) from e
        if name not in _REGISTRY:
            _REGISTRY[name] = factory
        return factory
    raise KeyError(
        f"engine factory {name!r} not registered; known: {sorted(_REGISTRY)}"
    )
