"""Linear-regression template: gradient descent or the exact solve.

Counterpart of ``predictionio_tpu/models/regression.py``. Training data
is (features, label) points from "point" events (``label`` and
``features`` properties) or a whitespace-separated ``label f1 f2 ...``
file. ``solver="sgd"`` runs full-batch gradient descent on the device,
one ``[N, d] x [d]`` product pair a step; ``solver="normal"`` solves the
normal equations with one Cholesky factorization. Queries
``{"features": [...]}`` answer a number; ``AverageServing`` averages the
engine's algorithms (the example's three "SGD" step sizes).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from predictionio_tpu_torch.core import (
    Algorithm,
    AverageServing,
    DataSource,
    Engine,
    IdentityPreparator,
    Params,
    register_engine,
)
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.parallel.mesh import ComputeContext


@dataclasses.dataclass(frozen=True)
class RegressionDataSourceParams(Params):
    app_name: str = ""       # "point" events with label/features, or
    filepath: str = ""       # "label f1 f2 ..." lines
    event_name: str = "point"
    eval_k: int = 0          # >=2 enables k-fold read_eval
    seed: int = 9527


@dataclasses.dataclass
class RegressionTrainingData:
    features: np.ndarray  # [N, d] float32
    labels: np.ndarray    # [N] float32


class RegressionDataSource(DataSource):
    params_class = RegressionDataSourceParams

    def _points(self) -> RegressionTrainingData:
        p = self.params
        feats, labels = [], []
        if p.filepath:
            with open(p.filepath) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    labels.append(float(parts[0]))
                    feats.append([float(x) for x in parts[1:]])
        else:
            for event in EventStore().find(
                p.app_name, event_names=[p.event_name]
            ):
                labels.append(float(event.properties.get("label")))
                feats.append(
                    [float(x) for x in event.properties.get("features")]
                )
        if not labels:
            raise ValueError("no regression points found")
        return RegressionTrainingData(
            features=np.asarray(feats, np.float32),
            labels=np.asarray(labels, np.float32),
        )

    def read_training(self, ctx: ComputeContext) -> RegressionTrainingData:
        return self._points()

    def read_eval(self, ctx: ComputeContext):
        """k folds, each point's fold drawn from ``seed``: ``(train,
        {"fold": i}, [(query, label)])``."""
        p = self.params
        if p.eval_k <= 1:
            raise ValueError("eval_k must be >= 2 for evaluation")
        data = self._points()
        rng = np.random.default_rng(p.seed)
        fold_of = rng.integers(0, p.eval_k, len(data.labels))
        folds = []
        for fold in range(p.eval_k):
            test = fold_of == fold
            train = RegressionTrainingData(
                features=data.features[~test], labels=data.labels[~test]
            )
            qa = [
                ({"features": f.tolist()}, float(y))
                for f, y in zip(data.features[test], data.labels[test])
            ]
            folds.append((train, {"fold": fold}, qa))
        return folds


@dataclasses.dataclass(frozen=True)
class RegressionAlgorithmParams(Params):
    num_iterations: int = 200
    step_size: float = 0.1
    solver: str = "sgd"      # "sgd" | "normal" (exact)
    l2: float = 0.0
    fit_intercept: bool = True


@dataclasses.dataclass
class RegressionModel:
    weights: np.ndarray    # [d]
    intercept: float


def sgd_fit(X: torch.Tensor, y: torch.Tensor, iters: int, step: float,
            l2: float) -> torch.Tensor:
    """``iters`` full-batch gradient steps from zero weights, on the
    tensors' device: ``w -= step * (Xᵀ(Xw - y)/n + l2·w)``."""
    n = X.shape[0]
    w = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    for _ in range(iters):
        grad = X.T @ (X @ w - y) / n + l2 * w
        w = w - step * grad
    return w


def normal_fit(X: torch.Tensor, y: torch.Tensor, l2: float) -> torch.Tensor:
    """The normal equations ``(XᵀX + l2·I) w = Xᵀy`` by Cholesky."""
    d = X.shape[1]
    gram = X.T @ X + l2 * torch.eye(d, dtype=X.dtype, device=X.device)
    rhs = X.T @ y
    chol = torch.linalg.cholesky(gram)
    return torch.cholesky_solve(rhs[:, None], chol)[:, 0]


class RegressionAlgorithm(Algorithm):
    params_class = RegressionAlgorithmParams

    def train(
        self, ctx: ComputeContext, pd: RegressionTrainingData
    ) -> RegressionModel:
        p = self.params
        X = pd.features
        y = pd.labels
        if p.fit_intercept:
            X = np.concatenate([X, np.ones((len(X), 1), X.dtype)], axis=1)
        Xd = torch.as_tensor(X, device=ctx.device)
        yd = torch.as_tensor(y, device=ctx.device)
        if p.solver == "normal":
            w = normal_fit(Xd, yd, p.l2)
        else:
            w = sgd_fit(Xd, yd, p.num_iterations, p.step_size, p.l2)
        w = w.cpu().numpy()
        if p.fit_intercept:
            return RegressionModel(weights=w[:-1], intercept=float(w[-1]))
        return RegressionModel(weights=w, intercept=0.0)

    def predict(self, model: RegressionModel, query: dict) -> float:
        x = np.asarray(query["features"], np.float32)
        return float(x @ model.weights + model.intercept)

    def batch_predict(self, model: RegressionModel, queries) -> list[float]:
        X = np.asarray([q["features"] for q in queries], np.float32)
        return (X @ model.weights + model.intercept).tolist()


def regression_engine() -> Engine:
    return Engine(
        RegressionDataSource,
        IdentityPreparator,
        {"SGD": RegressionAlgorithm},
        AverageServing,
    )


register_engine("regression", regression_engine)
