"""Lead-scoring template: conversion probability by logistic regression.

Counterpart of ``predictionio_tpu/models/leadscoring.py``. Users carry
``$set`` numeric attributes and a boolean conversion label; a query
``{"features": [...]}`` answers ``{"score": p, "converted": p >=
threshold}``. Features are standardized at the preparator, with the
moments carried into the model so serving normalizes alike; the rows
are placed over the mesh's ``data`` axis, as in the JAX package.
Training is ``steps`` full-batch Adam steps on the home device
(``torch.optim.Adam``: the optax defaults b1 0.9, b2 0.999, eps 1e-8
added outside the square root after bias correction) on the masked mean
of the logistic loss plus ``l2·‖w‖²``. Each step's gradient is the
closed form, ``Σ xᵢ (σ(zᵢ) − yᵢ) mᵢ / max(Σ mᵢ, 1) + 2·l2·w`` (and the
same sum without ``xᵢ`` for the bias): each row block gives its partial
sums, added on the home device in block order
(:func:`~predictionio_tpu_torch.parallel.mesh.sum_over_data`).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    Params,
    Preparator,
    register_engine,
)
from predictionio_tpu_torch.core.controller import SanityCheck
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.parallel.mesh import (
    ComputeContext,
    ShardedTensor,
    sum_over_data,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class LeadDataSourceParams(Params):
    app_name: str = "MyApp"
    entity_type: str = "user"
    attributes: tuple[str, ...] = ("sessions", "pages", "minutes")
    label_property: str = "converted"
    eval_k: int = 0  # >0 enables k-fold read_eval


@dataclasses.dataclass
class LeadTrainingData(SanityCheck):
    x: np.ndarray  # float32 [n, d]
    y: np.ndarray  # float32 [n] in {0, 1}

    def sanity_check(self) -> None:
        if len(self.x) == 0:
            raise ValueError("no labeled leads found — seed data first")
        if not np.isfinite(self.x).all():
            # one NaN attribute would poison the standardization moments
            # and every trained weight: fail at read, not at serve
            raise ValueError("lead features contain NaN/inf values")
        if len(np.unique(self.y)) < 2:
            raise ValueError(
                "need both converted and unconverted leads to fit"
            )


class LeadDataSource(DataSource[LeadTrainingData, dict, dict, list]):
    params_class = LeadDataSourceParams

    def _read(self) -> LeadTrainingData:
        p = self.params
        props = EventStore().aggregate_properties(
            p.app_name, p.entity_type,
            required=[*p.attributes, p.label_property],
        )
        rows, labels = [], []
        for entity_id, pm in props.items():
            rows.append([float(pm[a]) for a in p.attributes])
            raw = pm[p.label_property]
            # bool/0/1 only: bool("false") is True, so a string label
            # would invert the training signal
            if not isinstance(raw, bool) and raw not in (0, 1):
                raise ValueError(
                    f"label {p.label_property!r} of entity "
                    f"{entity_id!r} must be a boolean, got {raw!r}"
                )
            labels.append(1.0 if raw else 0.0)
        return LeadTrainingData(
            x=np.asarray(rows, np.float32).reshape(
                len(rows), len(p.attributes)
            ),
            y=np.asarray(labels, np.float32),
        )

    def read_training(self, ctx: ComputeContext) -> LeadTrainingData:
        return self._read()

    def read_eval(self, ctx: ComputeContext):
        from predictionio_tpu_torch.core.evaluation import kfold_indices

        full = self._read()
        folds = []
        for fold, train_idx, test_idx in kfold_indices(
            len(full.x), self.params.eval_k
        ):
            td = LeadTrainingData(x=full.x[train_idx], y=full.y[train_idx])
            qa = [
                ({"features": full.x[i].tolist()}, bool(full.y[i]))
                for i in test_idx
            ]
            folds.append((td, {"fold": fold}, qa))
        return folds


@dataclasses.dataclass
class LeadPrepared:
    x: ShardedTensor     # [n_pad, d] standardized, split over data
    y: ShardedTensor     # float32 [n_pad]
    mask: ShardedTensor  # float32 [n_pad]
    mean: np.ndarray   # [d] training-fold feature means
    std: np.ndarray    # [d] training-fold feature stds (>= eps)


class LeadPreparator(Preparator[LeadTrainingData, LeadPrepared]):
    """Standardize on the host and place the rows over the mesh's
    ``data`` axis; the moments ride along so serving normalizes queries
    alike."""

    def prepare(
        self, ctx: ComputeContext, td: LeadTrainingData
    ) -> LeadPrepared:
        mean = td.x.mean(axis=0)
        std = np.maximum(td.x.std(axis=0), 1e-6)
        x = (td.x - mean) / std
        return LeadPrepared(
            x=ctx.shard_rows(x.astype(np.float32)),
            y=ctx.shard_rows(td.y),
            mask=ctx.shard_rows(np.ones(len(td.x), np.float32)),
            mean=mean.astype(np.float32),
            std=std.astype(np.float32),
        )


@dataclasses.dataclass(frozen=True)
class LeadScoringParams(Params):
    learning_rate: float = 0.1
    steps: int = 500
    l2: float = 1e-3
    #: classification cut for the boolean "converted" answer
    threshold: float = 0.5
    seed: int = 7


@dataclasses.dataclass
class LeadModel:
    w: np.ndarray      # [d]
    b: float
    mean: np.ndarray   # [d]
    std: np.ndarray    # [d]
    threshold: float

    def score(self, features: np.ndarray) -> np.ndarray:
        z = ((features - self.mean) / self.std) @ self.w + self.b
        return 1.0 / (1.0 + np.exp(-z))


Rows = torch.Tensor | ShardedTensor


def lead_loss(w: torch.Tensor, b: torch.Tensor, x: Rows, y: Rows,
              mask: Rows, l2: float) -> torch.Tensor:
    """The masked mean of the logistic loss plus ``l2·‖w‖²``: each row
    block's ``Σ bce·mask`` and ``Σ mask``, summed in block order."""

    def block(xb, yb, mb):
        bce = torch.nn.functional.binary_cross_entropy_with_logits(
            xb @ w.to(xb.device) + b.to(xb.device), yb, reduction="none")
        return (bce * mb).sum(), mb.sum()

    total, count = sum_over_data(block, x, y, mask)
    return total / torch.clamp(count, min=1.0) + l2 * (w ** 2).sum()


def fit_logistic(x: Rows, y: Rows, mask: Rows, learning_rate: float,
                 steps: int, l2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``steps`` Adam steps from zero weights on the rows' (home) device;
    returns ``(w [d], b [])``. The gradient is the closed form: each row
    block gives ``Σ x·r`` and ``Σ r`` with ``r = (σ(x·w + b) − y)·mask``,
    the blocks are summed in order, and the sum is divided by ``max(Σ
    mask, 1)`` before ``2·l2·w`` is added."""
    home = x.device
    w = torch.zeros(x.shape[1], dtype=torch.float32, device=home)
    b = torch.zeros((), dtype=torch.float32, device=home)
    opt = torch.optim.Adam([w, b], lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    count = torch.clamp(sum_over_data(lambda mb: mb.sum(), mask), min=1.0)

    def block(xb, yb, mb):
        r = (torch.sigmoid(xb @ w.to(xb.device) + b.to(xb.device)) - yb) * mb
        return xb.T @ r, r.sum()

    for _ in range(steps):
        gw, gb = sum_over_data(block, x, y, mask)
        w.grad = gw / count + 2.0 * l2 * w
        b.grad = gb / count
        opt.step()
    return w, b


class LeadScoringAlgorithm(Algorithm[LeadPrepared, LeadModel, dict, dict]):
    params_class = LeadScoringParams

    def train(self, ctx: ComputeContext, data: LeadPrepared) -> LeadModel:
        p = self.params
        w, b = fit_logistic(data.x, data.y, data.mask, p.learning_rate,
                            p.steps, p.l2)
        logger.info(
            "lead-scoring logistic regression: d=%d, %d steps",
            data.mean.shape[0], p.steps,
        )
        return LeadModel(
            w=w.cpu().numpy(),
            b=float(b),
            mean=data.mean,
            std=data.std,
            threshold=p.threshold,
        )

    def predict(self, model: LeadModel, query: dict) -> dict:
        return self.batch_predict(model, [query])[0]

    def batch_predict(self, model: LeadModel, queries) -> list[dict]:
        if not queries:
            return []
        x = np.asarray([q["features"] for q in queries], np.float32)
        scores = model.score(x)
        # the deploy-time params cut the boolean: editing engine.json and
        # redeploying takes effect without a retrain (model.threshold
        # records what the training run used)
        threshold = self.params.threshold
        return [
            {"score": float(s), "converted": bool(s >= threshold)}
            for s in scores
        ]

    def warmup_query(self) -> dict | None:
        return None  # the feature width is data-dependent: serve cold


def leadscoring_engine() -> Engine:
    return Engine(
        LeadDataSource,
        LeadPreparator,
        {"logreg": LeadScoringAlgorithm},
        FirstServing,
    )


register_engine("leadscoring", leadscoring_engine)
