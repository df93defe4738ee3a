"""Engine — the DASE assembly and its deploy-time model recovery.

Counterpart of ``predictionio_tpu/core/engine.py`` for the serving
slice: component maps, ``prepare_deploy`` and ``params_from_variant``.
``train`` and ``eval`` come with the training slice.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Mapping, Sequence

from predictionio_tpu_torch.core.controller import (
    Algorithm,
    DataSource,
    EmptyParams,
    Params,
    ParamsError,
    PersistenceMode,
    Preparator,
    Serving,
    params_from_json,
)
from predictionio_tpu_torch.parallel.mesh import ComputeContext

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class WorkflowParams:
    batch: str = ""
    verbose: int = 2
    save_model: bool = True
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False


@dataclasses.dataclass
class EngineParams:
    """Named (component-name, params) selection."""

    data_source: tuple[str, Params] = ("", EmptyParams())
    preparator: tuple[str, Params] = ("", EmptyParams())
    algorithms: Sequence[tuple[str, Params]] = (("", EmptyParams()),)
    serving: tuple[str, Params] = ("", EmptyParams())


class Engine:
    """The DASE assembly. ``*_classes`` are name→class maps; a map with a
    single entry accepts the empty name ""."""

    def __init__(
        self,
        data_source_classes: (
            Mapping[str, type[DataSource]] | type[DataSource]
        ),
        preparator_classes: Mapping[str, type[Preparator]] | type[Preparator],
        algorithm_classes: Mapping[str, type[Algorithm]] | type[Algorithm],
        serving_classes: Mapping[str, type[Serving]] | type[Serving],
    ):
        def _as_map(x, base):
            if isinstance(x, Mapping):
                return dict(x)
            if isinstance(x, type) and issubclass(x, base):
                return {"": x}
            raise TypeError(f"expected class or name→class map, got {x!r}")

        self.data_source_classes = _as_map(data_source_classes, DataSource)
        self.preparator_classes = _as_map(preparator_classes, Preparator)
        self.algorithm_classes = _as_map(algorithm_classes, Algorithm)
        self.serving_classes = _as_map(serving_classes, Serving)

    def _one(self, classes: Mapping[str, type], name: str, kind: str):
        if name in classes:
            return classes[name]
        if name == "" and len(classes) == 1:
            return next(iter(classes.values()))
        raise ParamsError(
            f"unknown {kind} {name!r}; available: {sorted(classes)}"
        )

    def make_data_source(self, params: EngineParams) -> DataSource:
        name, p = params.data_source
        return self._one(self.data_source_classes, name, "data source")(p)

    def make_preparator(self, params: EngineParams) -> Preparator:
        name, p = params.preparator
        return self._one(self.preparator_classes, name, "preparator")(p)

    def make_algorithms(self, params: EngineParams) -> list[Algorithm]:
        return [
            self._one(self.algorithm_classes, name, "algorithm")(p)
            for name, p in params.algorithms
        ]

    def make_serving(self, params: EngineParams) -> Serving:
        name, p = params.serving
        return self._one(self.serving_classes, name, "serving")(p)

    def prepare_deploy(
        self,
        ctx: ComputeContext,
        params: EngineParams,
        instance_id: str,
        stored_models: Sequence[Any],
    ) -> tuple[list[Algorithm], list[Any], Serving]:
        algorithms = self.make_algorithms(params)
        if len(stored_models) != len(algorithms):
            raise RuntimeError(
                f"engine params declare {len(algorithms)} algorithm(s) but "
                f"instance {instance_id} persisted {len(stored_models)} "
                f"model(s); retrain with the current params"
            )
        models: list[Any] = []
        for i, (algo, stored) in enumerate(zip(algorithms, stored_models)):
            mode = algo.persistence_mode
            if mode == PersistenceMode.AUTO:
                models.append(stored)
            elif mode == PersistenceMode.MANUAL:
                models.append(algo.load_model(instance_id, ctx))
            else:  # RETRAIN: re-run the pipeline for this algorithm
                logger.info(
                    "algorithm %d (%s) uses RETRAIN persistence; re-training",
                    i, type(algo).__name__,
                )
                td = self.make_data_source(params).read_training(ctx)
                pd = self.make_preparator(params).prepare(ctx, td)
                models.append(algo.train(ctx, pd))
        # stage every model onto the device once — serving must never
        # pay a per-request host→device model transfer
        models = [
            algo.stage_model(ctx, model)
            for algo, model in zip(algorithms, models)
        ]
        return algorithms, models, self.make_serving(params)

    def params_from_variant(self, variant: Mapping[str, Any]) -> EngineParams:
        """engine.json variant → :class:`EngineParams`."""

        def _component(key: str, classes: Mapping[str, type]) -> tuple[str, Params]:
            node = variant.get(key) or {}
            name = node.get("name", "")
            cls = self._one(classes, name, key)
            return (name, params_from_json(
                getattr(cls, "params_class", EmptyParams), node.get("params")
            ))

        algo_nodes = variant.get("algorithms")
        if algo_nodes:
            algorithms = []
            for node in algo_nodes:
                name = node.get("name", "")
                cls = self._one(self.algorithm_classes, name, "algorithm")
                algorithms.append(
                    (
                        name,
                        params_from_json(
                            getattr(cls, "params_class", EmptyParams),
                            node.get("params"),
                        ),
                    )
                )
        else:
            algorithms = [("", EmptyParams())]
        return EngineParams(
            data_source=_component("datasource", self.data_source_classes),
            preparator=_component("preparator", self.preparator_classes),
            algorithms=algorithms,
            serving=_component("serving", self.serving_classes),
        )


#: An engine factory is any zero-arg callable returning an Engine.
EngineFactory = Callable[[], Engine]
