"""Workflow runtime — train and publish, evaluate, and deploy-side model
recovery.

Counterpart of ``apply_checkpoint_params``, ``latest_completed_id``,
``run_train``, ``run_evaluation`` and ``load_deployment`` in
``predictionio_tpu/core/workflow.py``. A training run is one trace of
the process tracer (``pio_train``, trace id = the instance id) whose
spans are the ``StepTimer`` steps, ALS's stages, the checkpoints and
``train/persist_model``; with ``PIO_TRACE_DIR`` set it is written there
as ``pio_train_<id>.trace.json`` (a failed run's too), beside the
``torch.profiler`` trace of the training step, on that trace's time
base, and its spans of the profiled window are merged into the profiler
trace. The step times join the process registry as
``pio_train_step_seconds``.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import os
import pickle
import time
from typing import Any, Sequence

import torch

from predictionio_tpu_torch.core.controller import PersistenceMode
from predictionio_tpu_torch.core.engine import (
    Engine,
    EngineParams,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    WorkflowParams,
)
from predictionio_tpu_torch.core.evaluation import (
    MetricEvaluator,
    MetricEvaluatorResult,
)
from predictionio_tpu_torch.core.fasteval import FastEvalEngine
from predictionio_tpu_torch.core.persistence import (
    ModelIntegrityError,
    deserialize_models,
    load_generation,
    publish_generation,
    quarantine_generation,
    serialize_models,
)
from predictionio_tpu_torch.data.storage import (
    EngineInstance,
    EvaluationInstance,
    Storage,
    get_storage,
)
from predictionio_tpu_torch.obs import get_registry, tracing
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.utils.profiling import StepTimer, trace

logger = logging.getLogger(__name__)


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def _write_train_trace(
    tracer, trace_id: str | None, instance_id: str, profiled=None
) -> None:
    """Persist the run's span timeline as Chrome trace-event JSON in
    ``PIO_TRACE_DIR`` (the directory :func:`~predictionio_tpu_torch.
    utils.profiling.trace` writes the profiler's trace to), as
    ``pio_train_<instance id>.trace.json``; beside the profiler trace
    ``profiled`` (a :class:`~predictionio_tpu_torch.utils.profiling.
    ProfilerTrace`) it is placed on that trace's time base and its
    spans of the profiled window merged into it. Best-effort: a full
    disk must not fail a COMPLETED run."""
    trace_dir = os.environ.get("PIO_TRACE_DIR")
    if not trace_dir or trace_id is None:
        return
    try:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(
            trace_dir, f"pio_train_{instance_id}.trace.json"
        )
        timeline = tracer.chrome_trace(trace_id=trace_id)
        if profiled is not None:
            timeline = profiled.overlay(timeline)
        with open(path, "w") as f:
            # default=str: span attributes are caller-supplied (numpy
            # scalars, shapes, ...) and must not fail a COMPLETED run
            json.dump(timeline, f, default=str)
        if timeline["traceEvents"]:
            logger.info("wrote training span timeline to %s", path)
        else:
            # the recorder can abandon a very long run's open trace at
            # its cap — an empty timeline must not pass for a full one
            logger.warning(
                "training trace %s has no spans (recorder abandoned "
                "it?); wrote empty timeline to %s", trace_id, path,
            )
    except (OSError, TypeError, ValueError) as e:
        # best-effort: a serialization surprise in the finally must
        # neither fail a COMPLETED run nor mask a training error
        logger.warning("could not write training trace: %s", e)


def apply_checkpoint_params(
    algorithms: Sequence[Any],
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> int:
    """Thread checkpoint settings into every algorithm whose params
    dataclass declares ``checkpoint_dir``/``checkpoint_every``/``resume``
    (the ``ops/als.py`` contract). Returns how many were rewired; 0
    means the flags are inert (logged, not an error)."""
    if not checkpoint_dir:
        return 0
    rewired = 0
    for algo in algorithms:
        p = algo.params
        if not dataclasses.is_dataclass(p):
            continue
        names = {f.name for f in dataclasses.fields(p)}
        if not {"checkpoint_dir", "checkpoint_every", "resume"} <= names:
            continue
        algo.params = dataclasses.replace(
            p,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            resume=resume,
        )
        rewired += 1
    if rewired == 0:
        logger.warning(
            "checkpoint_dir=%s requested but no algorithm supports "
            "checkpointing; training runs without restore points",
            checkpoint_dir,
        )
    return rewired


def latest_completed_id(
    storage: Storage,
    engine_id: str,
    engine_version: str = "1",
    engine_variant: str = "default",
) -> str | None:
    """Id of the current latest COMPLETED instance (the parent of the
    next published generation), or None for a first train."""
    latest = storage.get_meta_data_engine_instances().get_latest_completed(
        engine_id, engine_version, engine_variant
    )
    return latest.id if latest is not None else None


def _device_conf(ctx: ComputeContext) -> dict[str, str]:
    """The card a run trained on, for its instance record."""
    dev = ctx.device
    name = (
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    )
    return {"platform": dev.type, "device": name,
            "devices": str(ctx.n_devices)}


def run_train(
    engine: Engine,
    params: EngineParams,
    engine_id: str,
    engine_version: str = "1",
    engine_variant: str = "default",
    engine_factory: str = "",
    workflow: WorkflowParams | None = None,
    ctx: ComputeContext | None = None,
    storage: Storage | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    watermark: dict | None = None,
) -> str:
    """Train, publish, and return the EngineInstance id.

    The instance is INIT on entry and COMPLETED only after the model
    generation is published (blob first, checksum manifest last), so
    deploy never picks a half-written run; FAILED on an error,
    INTERRUPTED on a stop-after-read/prepare. The manifest records the
    parent generation (the latest COMPLETED one before this run) and the
    ``watermark`` the data was read at. ``checkpoint_*`` thread through
    :func:`apply_checkpoint_params`. ``ctx=None`` takes the current CUDA
    device and raises, before any record is written, without one."""
    workflow = workflow or WorkflowParams()
    storage = storage or get_storage()
    ctx = ctx or ComputeContext.create(batch=workflow.batch or engine_id)
    instances = storage.get_meta_data_engine_instances()
    instance_id = instances.insert(EngineInstance(
        id="",
        status="INIT",
        start_time=_now(),
        end_time=_now(),
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        engine_factory=engine_factory,
        batch=workflow.batch,
    ))
    instance = instances.get(instance_id)
    tracer = tracing.get_tracer()
    # the whole run is one trace (trace id = instance id): the StepTimer
    # steps inside engine.train are its child spans, and its timeline is
    # written to PIO_TRACE_DIR in the finally, because the timeline of a
    # FAILED run is the one most worth keeping
    root_trace_id = None
    profiled = None
    try:
        with tracer.trace(
            "pio_train",
            trace_id=instance_id,
            attributes={
                "engineId": engine_id,
                "engineVersion": engine_version,
                "engineVariant": engine_variant,
            },
        ) as root_span:
            if root_span is not None:
                root_trace_id = root_span.trace_id
            instance = dataclasses.replace(
                instance, mesh_conf=_device_conf(ctx)
            )
            instances.update(instance)
            # the SAME algorithm objects train and (MANUAL persistence)
            # save
            algorithms = engine.make_algorithms(params)
            apply_checkpoint_params(
                algorithms,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every,
                resume=resume,
            )
            parent_generation = latest_completed_id(
                storage, engine_id, engine_version, engine_variant
            )
            timer = StepTimer()
            for algo in algorithms:
                algo.timer = timer
            with timer.step("train/total"), trace() as profiled:
                models = engine.train(
                    ctx, params, workflow, algorithms=algorithms,
                    timer=timer,
                )
            if workflow.save_model:
                with tracing.span("train/persist_model"):
                    t0 = time.perf_counter()
                    blob = serialize_models(instance_id, algorithms, models)
                    publish_generation(
                        storage.get_model_data_models(),
                        instance_id,
                        blob,
                        watermark=watermark,
                        parent=parent_generation,
                    )
                    timer.record("train/persist", time.perf_counter() - t0)
                logger.info(
                    "persisted %d model(s) for instance %s (%d bytes)",
                    len(models), instance_id, len(blob),
                )
            timer.log_summary(prefix=f"[{engine_id}] ")
            # train-time telemetry joins the process registry: a trainer
            # that also serves /metrics scrapes both as one
            timer.publish(get_registry())
            instance = dataclasses.replace(
                instance, env={"timing": timer.to_json()}
            )
            instances.update(dataclasses.replace(
                instance, status="COMPLETED", end_time=_now()
            ))
        return instance_id
    except (StopAfterReadInterruption, StopAfterPrepareInterruption):
        instances.update(
            dataclasses.replace(instance, status="INTERRUPTED", end_time=_now())
        )
        raise
    except Exception:
        instances.update(
            dataclasses.replace(instance, status="FAILED", end_time=_now())
        )
        raise
    finally:
        # the root span finalized when the with-block unwound, so the
        # trace is in the ring even when train raised
        _write_train_trace(tracer, root_trace_id, instance_id, profiled)


def run_evaluation(
    evaluation,
    batch: str = "",
    workflow: WorkflowParams | None = None,
    ctx: ComputeContext | None = None,
    storage: Storage | None = None,
) -> tuple[str, MetricEvaluatorResult]:
    """Run an :class:`~predictionio_tpu_torch.core.evaluation.Evaluation`;
    returns ``(instance_id, MetricEvaluatorResult)``.

    The EvaluationInstance is INIT on entry, then EVALCOMPLETED with the
    one-liner, HTML and JSON results, or FAILED on an error. A plain
    ``Engine`` is wrapped in :class:`FastEvalEngine` (unless
    ``evaluation.fast_eval`` is False) so a grid sweep reads, prepares
    and trains each distinct prefix once; a subclass keeps its own
    ``eval``. ``ctx=None`` takes the current CUDA device and raises,
    before any record is written, without one."""
    workflow = workflow or WorkflowParams()
    storage = storage or get_storage()
    ctx = ctx or ComputeContext.create(batch=batch or "evaluation")
    instances = storage.get_meta_data_evaluation_instances()
    instance_id = instances.insert(EvaluationInstance(
        id="",
        status="INIT",
        start_time=_now(),
        end_time=_now(),
        evaluation_class=type(evaluation).__name__,
        batch=batch,
    ))
    instance = instances.get(instance_id)
    try:
        engine = evaluation.engine
        if getattr(evaluation, "fast_eval", True) and type(engine) is Engine:
            engine = FastEvalEngine.from_engine(engine)
        evaluator = MetricEvaluator(
            metric=evaluation.metric,
            other_metrics=evaluation.other_metrics,
            output_path=evaluation.output_path,
            parallelism=getattr(evaluation, "parallelism", None),
        )
        result = evaluator.evaluate(
            ctx, engine, evaluation.engine_params_list, workflow
        )
    except Exception:
        instances.update(
            dataclasses.replace(instance, status="FAILED", end_time=_now())
        )
        raise
    instances.update(dataclasses.replace(
        instance,
        status="EVALCOMPLETED",
        end_time=_now(),
        evaluator_results=result.to_one_liner(),
        evaluator_results_html=result.to_html(),
        evaluator_results_json=result.to_json(),
    ))
    return instance_id, result


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
