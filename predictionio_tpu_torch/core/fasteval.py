"""FastEvalEngine: pipeline-prefix memoization for tuning sweeps.

Counterpart of ``predictionio_tpu/core/fasteval.py``. When a grid of
``EngineParams`` is evaluated, candidates sharing a pipeline prefix
(the same data-source params; the same plus preparator params; the same
plus algorithm params) reuse the earlier stage's output: read, prepare,
train and batch-predict each run once per distinct prefix. Cache keys
are the (name, params) tuples themselves; controller params are frozen
dataclasses, so equality and hashing are structural.

The caches are thread-safe with single-flight semantics:
:class:`~predictionio_tpu_torch.core.evaluation.MetricEvaluator` scores
candidates in threads, so two candidates racing on a shared prefix
compute it exactly once (the loser blocks on the winner's future).
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import Future
from typing import Any

from predictionio_tpu_torch.core.engine import (
    Engine,
    EngineParams,
    WorkflowParams,
)
from predictionio_tpu_torch.parallel.mesh import ComputeContext

logger = logging.getLogger(__name__)


def _freeze(pairs) -> tuple:
    return tuple((name, params) for name, params in pairs)


class FastEvalEngine(Engine):
    """Engine whose ``eval`` memoizes pipeline prefixes across calls.

    Use one instance per tuning run; caches live on the instance.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lock = threading.Lock()
        self._data_source_cache: dict[Any, Future] = {}
        self._preparator_cache: dict[Any, Future] = {}
        self._algorithms_cache: dict[Any, Future] = {}
        self._predict_cache: dict[Any, Future] = {}
        self.cache_hits = {
            "data_source": 0,
            "preparator": 0,
            "algorithms": 0,
            "predict": 0,
        }

    @classmethod
    def from_engine(cls, engine: Engine) -> "FastEvalEngine":
        """Wrap a plain Engine's component maps in a fresh FastEval
        instance (used by ``run_evaluation`` to memoize by default)."""
        return cls(
            engine.data_source_classes,
            engine.preparator_classes,
            engine.algorithm_classes,
            engine.serving_classes,
        )

    def _memo(self, cache: dict, key, hit_name: str, compute):
        """Single-flight memoization: first caller computes, concurrent
        callers for the same key block on its future; failures are not
        cached (a transient error should not poison the sweep)."""
        with self._lock:
            fut = cache.get(key)
            if fut is None:
                fut = Future()
                cache[key] = fut
                owner = True
            else:
                self.cache_hits[hit_name] += 1
                owner = False
        if owner:
            try:
                fut.set_result(compute())
            except BaseException as exc:
                with self._lock:
                    cache.pop(key, None)
                fut.set_exception(exc)
                raise
        return fut.result()

    def _folds(self, ctx, params: EngineParams):
        return self._memo(
            self._data_source_cache,
            ("ds", params.data_source),
            "data_source",
            lambda: self.make_data_source(params).read_eval(ctx),
        )

    def _prepared(self, ctx, params: EngineParams, fold: int):
        return self._memo(
            self._preparator_cache,
            ("prep", params.data_source, params.preparator, fold),
            "preparator",
            lambda: self.make_preparator(params).prepare(
                ctx, self._folds(ctx, params)[fold][0]
            ),
        )

    def _model(self, ctx, params: EngineParams, algo_pair, fold: int):
        def compute():
            name, p = algo_pair
            algo = self._one(self.algorithm_classes, name, "algorithm")(p)
            # staged once on the card: every candidate sharing this
            # prefix predicts against the same device-resident model
            model = algo.train(ctx, self._prepared(ctx, params, fold))
            return algo, algo.stage_model(ctx, model)

        return self._memo(
            self._algorithms_cache,
            ("algo", params.data_source, params.preparator, algo_pair, fold),
            "algorithms",
            compute,
        )

    def _predictions(
        self, ctx, params: EngineParams, algo_pair, fold: int, queries
    ):
        # serving is part of the key: supplement() may rewrite queries
        def compute():
            algo, model = self._model(ctx, params, algo_pair, fold)
            return list(algo.batch_predict(model, queries))

        return self._memo(
            self._predict_cache,
            (
                "pred",
                params.data_source,
                params.preparator,
                algo_pair,
                params.serving,
                fold,
            ),
            "predict",
            compute,
        )

    def eval(
        self,
        ctx: ComputeContext,
        params: EngineParams,
        workflow: WorkflowParams | None = None,
    ):
        serving = self.make_serving(params)
        results = []
        folds = self._folds(ctx, params)
        for fold, (_td, eval_info, qa) in enumerate(folds):
            queries = [serving.supplement(q) for q, _ in qa]
            per_algo = [
                self._predictions(ctx, params, algo_pair, fold, queries)
                for algo_pair in _freeze(params.algorithms)
            ]
            qpa = [
                (
                    q,
                    serving.serve(q, [preds[i] for preds in per_algo]),
                    a,
                )
                for i, (q, (_q0, a)) in enumerate(zip(queries, qa))
            ]
            results.append((eval_info, qpa))
        return results
