"""Evaluation and tuning: the metric library, MetricEvaluator, Evaluation.

Counterpart of ``predictionio_tpu/core/evaluation.py``:

* the ``Metric`` hierarchy (Average / OptionAverage / Sum / Stdev /
  OptionStdev / Zero) over (evalInfo, query, prediction, actual)
  tuples, computed as host floats (the heavy part, batch prediction,
  already ran on the card);
* ``MetricEvaluator`` scores every candidate ``EngineParams`` in up to
  four threads (``PIO_EVAL_PARALLELISM``), keeps the best by the
  metric's ordering and optionally writes its variant JSON
  (``output_path``, e.g. ``best.json``);
* ``Evaluation`` (engine + metric + grid) is what
  :func:`~predictionio_tpu_torch.core.workflow.run_evaluation` runs.
"""

from __future__ import annotations

import abc
import dataclasses
import json
import logging
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Generic, Sequence, TypeVar

import numpy as np

from predictionio_tpu_torch.core.controller import params_to_json
from predictionio_tpu_torch.core.engine import (
    Engine,
    EngineParams,
    WorkflowParams,
)
from predictionio_tpu_torch.parallel.mesh import ComputeContext

logger = logging.getLogger(__name__)

R = TypeVar("R")

#: eval output shape: per fold, (evalInfo, [(query, prediction, actual)])
EvalData = Sequence[tuple[Any, Sequence[tuple[Any, Any, Any]]]]


def kfold_indices(n: int, k: int):
    """Index-modulo k-fold split: yields ``(fold, train_idx, test_idx)``
    int arrays. The shared split used by every template's
    ``read_eval``."""
    if k <= 1:
        raise ValueError("eval_k must be >= 2 for evaluation")
    idx = np.arange(n)
    for fold in range(k):
        test = idx % k == fold
        yield fold, idx[~test], idx[test]


class Metric(abc.ABC, Generic[R]):
    """Score one engine-params candidate from its eval output."""

    #: ordering: larger is better
    higher_is_better: bool = True

    @property
    def header(self) -> str:
        return type(self).__name__

    @abc.abstractmethod
    def calculate(self, eval_data: EvalData) -> R: ...

    def compare(self, a: R, b: R) -> int:
        sign = 1 if self.higher_is_better else -1
        return sign * ((a > b) - (a < b))


class PointMetric(Metric[float]):
    """Base for per-(q, p, a) point metrics."""

    @abc.abstractmethod
    def calculate_point(self, eval_info, query, prediction, actual) -> (
        float | None
    ): ...

    def _points(self, eval_data: EvalData) -> list[float]:
        out = []
        for eval_info, qpa in eval_data:
            for q, p, a in qpa:
                point = self.calculate_point(eval_info, q, p, a)
                if point is not None:
                    out.append(float(point))
        return out


class AverageMetric(PointMetric):
    """Mean of points (no points: -inf)."""

    def calculate(self, eval_data: EvalData) -> float:
        points = self._points(eval_data)
        return sum(points) / len(points) if points else float("-inf")


class OptionAverageMetric(AverageMetric):
    """calculate_point may return None to exclude a point."""


class SumMetric(PointMetric):
    def calculate(self, eval_data: EvalData) -> float:
        return sum(self._points(eval_data))


class StdevMetric(PointMetric):
    higher_is_better = False

    def calculate(self, eval_data: EvalData) -> float:
        points = self._points(eval_data)
        if len(points) < 2:
            return 0.0
        mean = sum(points) / len(points)
        return math.sqrt(
            sum((x - mean) ** 2 for x in points) / len(points)
        )


class OptionStdevMetric(StdevMetric):
    pass


class ZeroMetric(Metric[float]):
    """Always 0 (a placeholder for eval-only runs)."""

    def calculate(self, eval_data: EvalData) -> float:
        return 0.0


@dataclasses.dataclass
class MetricScores:
    score: Any
    other_scores: list[Any]


@dataclasses.dataclass
class MetricEvaluatorResult:
    """The scores of every candidate and the best one; its three
    renderings are byte-equal to the JAX package's."""

    best_score: MetricScores
    best_engine_params: EngineParams
    best_idx: int
    metric_header: str
    other_metric_headers: list[str]
    engine_params_scores: list[tuple[EngineParams, MetricScores]]

    def to_one_liner(self) -> str:
        return (
            f"[{self.metric_header}] best: {self.best_score.score} "
            f"(candidate {self.best_idx + 1}/"
            f"{len(self.engine_params_scores)})"
        )

    def to_json(self) -> str:
        return json.dumps(
            {
                "metricHeader": self.metric_header,
                "bestScore": self.best_score.score,
                "bestIdx": self.best_idx,
                "bestEngineParams": _engine_params_json(
                    self.best_engine_params
                ),
                "scores": [
                    s.score for _p, s in self.engine_params_scores
                ],
            }
        )

    def to_html(self) -> str:
        rows = "".join(
            f"<tr><td>{i}</td><td>{s.score}</td></tr>"
            for i, (_p, s) in enumerate(self.engine_params_scores)
        )
        return (
            f"<h3>{self.metric_header}</h3><p>best: "
            f"{self.best_score.score} (candidate {self.best_idx})</p>"
            f"<table>{rows}</table>"
        )


def _engine_params_json(params: EngineParams) -> dict:
    return {
        "datasource": {
            "name": params.data_source[0],
            "params": params_to_json(params.data_source[1]),
        },
        "preparator": {
            "name": params.preparator[0],
            "params": params_to_json(params.preparator[1]),
        },
        "algorithms": [
            {"name": n, "params": params_to_json(p)}
            for n, p in params.algorithms
        ],
        "serving": {
            "name": params.serving[0],
            "params": params_to_json(params.serving[1]),
        },
    }


class MetricEvaluator:
    """Score every candidate, pick the best.

    Candidates are evaluated concurrently: threads suffice because the
    heavy work (ALS training, the batch top-k) runs in torch ops and
    kernel launches that release the GIL, and FastEvalEngine's caches
    are single-flight thread-safe. Every thread launches on the same
    card (the kernel build and the launch counts are locked).
    ``parallelism=1`` (or env ``PIO_EVAL_PARALLELISM=1``) forces the
    sequential path.
    """

    def __init__(
        self,
        metric: Metric,
        other_metrics: Sequence[Metric] = (),
        output_path: str | None = None,
        parallelism: int | None = None,
    ):
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.output_path = output_path
        self.parallelism = parallelism

    def _eval_parallelism(self, n_candidates: int) -> int:
        if self.parallelism is not None:
            return max(1, self.parallelism)
        env = os.environ.get("PIO_EVAL_PARALLELISM", "")
        if env:
            return max(1, int(env))
        return min(4, n_candidates)

    def evaluate(
        self,
        ctx: ComputeContext,
        engine: Engine,
        engine_params_list: Sequence[EngineParams],
        workflow: WorkflowParams | None = None,
    ) -> MetricEvaluatorResult:
        if not engine_params_list:
            raise ValueError("engine_params_list must not be empty")
        n = len(engine_params_list)
        workers = self._eval_parallelism(n)
        if workers > 1 and n > 1:
            with ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="pio-eval"
            ) as pool:
                eval_datas = list(
                    pool.map(
                        lambda p: engine.eval(ctx, p, workflow),
                        engine_params_list,
                    )
                )
        else:
            eval_datas = [
                engine.eval(ctx, p, workflow) for p in engine_params_list
            ]
        scores: list[tuple[EngineParams, MetricScores]] = []
        for i, (params, eval_data) in enumerate(
            zip(engine_params_list, eval_datas)
        ):
            score = MetricScores(
                score=self.metric.calculate(eval_data),
                other_scores=[
                    m.calculate(eval_data) for m in self.other_metrics
                ],
            )
            logger.info(
                "candidate %d/%d: %s = %s",
                i + 1,
                n,
                self.metric.header,
                score.score,
            )
            scores.append((params, score))
        best_idx = 0
        for i in range(1, len(scores)):
            if (
                self.metric.compare(
                    scores[i][1].score, scores[best_idx][1].score
                )
                > 0
            ):
                best_idx = i
        result = MetricEvaluatorResult(
            best_score=scores[best_idx][1],
            best_engine_params=scores[best_idx][0],
            best_idx=best_idx,
            metric_header=self.metric.header,
            other_metric_headers=[m.header for m in self.other_metrics],
            engine_params_scores=scores,
        )
        if self.output_path:
            with open(self.output_path, "w") as f:
                json.dump(
                    _engine_params_json(result.best_engine_params),
                    f,
                    indent=2,
                )
            logger.info("best engine params written to %s", self.output_path)
        return result


@dataclasses.dataclass
class Evaluation:
    """Engine + metric + candidate grid (the grid is a plain list; an
    :data:`EngineParamsGenerator` is any callable producing it)."""

    engine: Engine
    metric: Metric
    engine_params_list: Sequence[EngineParams]
    other_metrics: Sequence[Metric] = ()
    output_path: str | None = None
    #: memoize pipeline prefixes across candidates (run_evaluation wraps
    #: plain Engines in FastEvalEngine); set False to force re-runs
    fast_eval: bool = True
    #: candidate-evaluation thread count (None → PIO_EVAL_PARALLELISM
    #: env or min(4, n_candidates))
    parallelism: int | None = None


#: a zero-argument callable returning the candidate grid
EngineParamsGenerator = Callable[[], Sequence[EngineParams]]
