"""Engine — the DASE assembly, its training pipeline and its
deploy-time model recovery.

Counterpart of ``predictionio_tpu/core/engine.py``: component maps,
``train`` (read → sanity check → prepare → sanity check → per-algorithm
train → sanity check, with the stop-after-read / stop-after-prepare
interruptions), ``eval`` (per fold: prepare, train, stage the model on
the card, one ``batch_predict`` for every query of the fold, serve),
``prepare_deploy`` and ``params_from_variant``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Callable, Mapping, Sequence

from predictionio_tpu_torch.core.controller import (
    Algorithm,
    DataSource,
    EmptyParams,
    Params,
    ParamsError,
    PersistenceMode,
    Preparator,
    SanityCheck,
    Serving,
    params_from_json,
)
from predictionio_tpu_torch.parallel.mesh import ComputeContext

logger = logging.getLogger(__name__)


class StopAfterReadInterruption(Exception):
    pass


class StopAfterPrepareInterruption(Exception):
    pass


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


@contextlib.contextmanager
def _timed(timer, name: str):
    """Record the block's wall clock into ``timer`` without opening a
    span, so a training run's trace holds the JAX package's span tree
    (``pio_train`` → ``train/total`` → the algorithm's own steps)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        timer.record(name, time.perf_counter() - t0)


def _sanity(obj: Any, stage: str, skip: bool) -> None:
    if skip:
        return
    if isinstance(obj, SanityCheck):
        logger.debug("sanity_check %s (%s)", stage, type(obj).__name__)
        obj.sanity_check()


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

    def train(
        self,
        ctx: ComputeContext,
        params: EngineParams,
        workflow: WorkflowParams | None = None,
        algorithms: list[Algorithm] | None = None,
        timer=None,
    ) -> list[Any]:
        """``algorithms`` may be pre-built so callers (run_train) keep the
        same instances for MANUAL-persistence ``save_model`` calls. A
        ``timer`` (:class:`~predictionio_tpu_torch.utils.profiling.StepTimer`)
        records the read, prepare and per-algorithm train steps."""
        workflow = workflow or WorkflowParams()

        def step(name):
            return _timed(timer, name) if timer else contextlib.nullcontext()

        # resolve every component up front (fail fast on bad names/params)
        data_source = self.make_data_source(params)
        preparator = self.make_preparator(params)
        if algorithms is None:
            algorithms = self.make_algorithms(params)
        with step("train/read"):
            td = data_source.read_training(ctx)
        _sanity(td, "training data", workflow.skip_sanity_check)
        if workflow.stop_after_read:
            raise StopAfterReadInterruption()

        with step("train/prepare"):
            pd = preparator.prepare(ctx, td)
        _sanity(pd, "prepared data", workflow.skip_sanity_check)
        if workflow.stop_after_prepare:
            raise StopAfterPrepareInterruption()

        models: list[Any] = []
        for i, algo in enumerate(algorithms):
            logger.info(
                "training algorithm %d/%d (%s)",
                i + 1, len(algorithms), type(algo).__name__,
            )
            with step("train/algorithm"):
                model = algo.train(ctx, pd)
            _sanity(model, f"model[{i}]", workflow.skip_sanity_check)
            models.append(model)
        return models

    def eval(
        self,
        ctx: ComputeContext,
        params: EngineParams,
        workflow: WorkflowParams | None = None,
    ) -> list[tuple[Any, list[tuple[Any, Any, Any]]]]:
        """Per evaluation fold: (evalInfo, [(query, prediction, actual)]).
        Each fold's trained model is staged on ``ctx.device`` before its
        one ``batch_predict``, so the fold's factors go to the card once
        and the batch runs where the context says."""
        workflow = workflow or WorkflowParams()
        data_source = self.make_data_source(params)
        preparator = self.make_preparator(params)
        algorithms = self.make_algorithms(params)
        serving = self.make_serving(params)

        results = []
        for fold, (td, eval_info, qa) in enumerate(
            data_source.read_eval(ctx)
        ):
            _sanity(td, f"fold[{fold}] training data",
                    workflow.skip_sanity_check)
            pd = preparator.prepare(ctx, td)
            _sanity(pd, f"fold[{fold}] prepared data",
                    workflow.skip_sanity_check)
            queries = [serving.supplement(q) for q, _ in qa]
            actuals = [a for _, a in qa]
            per_algo: list[list[Any]] = []
            for algo in algorithms:
                model = algo.stage_model(ctx, algo.train(ctx, pd))
                per_algo.append(list(algo.batch_predict(model, queries)))
            qpa = [
                (q, serving.serve(q, [preds[i] for preds in per_algo]), a)
                for i, (q, a) in enumerate(zip(queries, actuals))
            ]
            results.append((eval_info, qpa))
        return results

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
