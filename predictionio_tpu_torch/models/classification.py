"""Classification template: naive Bayes over entity properties.

Counterpart of ``predictionio_tpu/models/classification.py``. Entities
carry numeric attribute properties and a label property (``$set``
events); the rows are placed over the mesh's ``data`` axis, and
training fits multinomial naive Bayes with one matrix product per row
block, summed on the home device (:func:`ops.naive_bayes.fit_multinomial`);
a query
``{"features": [...]}`` answers ``{"label": ..., "scores": {...}}``, and
the micro-batcher's two-phase path answers ``{"label": ...}`` for a
batch from one launch.
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
from predictionio_tpu_torch.ops import naive_bayes as nb
from predictionio_tpu_torch.parallel.mesh import ComputeContext, ShardedTensor
from predictionio_tpu_torch.utils.bimap import BiMap

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ClassificationDataSourceParams(Params):
    app_name: str = "MyApp"
    entity_type: str = "user"
    attributes: tuple[str, ...] = ("attr0", "attr1", "attr2")
    label: str = "plan"
    eval_k: int = 0  # >0 enables k-fold read_eval


@dataclasses.dataclass
class ClassificationTrainingData(SanityCheck):
    x: np.ndarray            # [n, d] float32
    y: np.ndarray            # [n] int32 label codes
    label_map: BiMap

    def sanity_check(self) -> None:
        if len(self.x) == 0:
            raise ValueError("training data is empty")
        if not np.isfinite(self.x).all():
            raise ValueError("training features contain NaN/inf")
        if (self.x < 0).any():
            raise ValueError(
                "multinomial NB requires non-negative features"
            )


class ClassificationDataSource(
    DataSource[ClassificationTrainingData, dict, dict, str]
):
    params_class = ClassificationDataSourceParams

    def _read(self) -> ClassificationTrainingData:
        p = self.params
        props = EventStore().aggregate_properties(
            p.app_name,
            entity_type=p.entity_type,
            required=list(p.attributes) + [p.label],
        )
        rows, labels = [], []
        for _eid, pm in props.items():
            rows.append([pm.get_float(a) for a in p.attributes])
            labels.append(str(pm.get_required(p.label)))
        label_map, y = BiMap.string_int_with_codes(
            np.asarray(labels, dtype=np.str_)
        ) if labels else (BiMap(np.asarray([], dtype=np.str_)),
                          np.zeros(0, np.int32))
        return ClassificationTrainingData(
            x=np.asarray(rows, dtype=np.float32).reshape(
                len(rows), len(p.attributes)
            ),
            y=y,
            label_map=label_map,
        )

    def read_training(self, ctx: ComputeContext) -> ClassificationTrainingData:
        return self._read()

    def read_eval(self, ctx: ComputeContext):
        """k folds by index modulo k (:func:`core.evaluation.kfold_indices`)."""
        from predictionio_tpu_torch.core.evaluation import kfold_indices

        full = self._read()
        folds = []
        for fold, train_idx, test_idx in kfold_indices(
            len(full.x), self.params.eval_k
        ):
            td = ClassificationTrainingData(
                x=full.x[train_idx], y=full.y[train_idx],
                label_map=full.label_map,
            )
            qa = [
                (
                    {"features": full.x[i].tolist()},
                    full.label_map.inverse(int(full.y[i])),
                )
                for i in test_idx
            ]
            folds.append((td, {"fold": fold}, qa))
        return folds


@dataclasses.dataclass
class PreparedClassificationData:
    x: ShardedTensor     # [n_pad, d] split over data
    y: ShardedTensor     # [n_pad]
    mask: ShardedTensor  # [n_pad] 1.0 real / 0.0 padding
    label_map: BiMap
    n_classes: int


class ClassificationPreparator(
    Preparator[ClassificationTrainingData, PreparedClassificationData]
):
    """Rows padded to the data-axis multiple and placed over the mesh's
    ``data`` axis, as in the JAX package."""

    def prepare(
        self, ctx: ComputeContext, td: ClassificationTrainingData
    ) -> PreparedClassificationData:
        return PreparedClassificationData(
            x=ctx.shard_rows(td.x),
            y=ctx.shard_rows(td.y),
            mask=ctx.shard_rows(np.ones(len(td.x), np.float32)),
            label_map=td.label_map,
            n_classes=max(len(td.label_map), 1),
        )


@dataclasses.dataclass(frozen=True)
class NaiveBayesParams(Params):
    lambda_: float = 1.0


@dataclasses.dataclass
class NaiveBayesModel:
    nb: nb.MultinomialNBModel
    label_map: BiMap


def stage_nb(ctx: ComputeContext, model: nb.MultinomialNBModel):
    """A naive Bayes model's tables as float32 tensors on ``ctx.device``
    (a model loaded from the model store holds numpy arrays)."""
    def staged(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        return x.to(ctx.device, torch.float32)

    return nb.MultinomialNBModel(pi=staged(model.pi),
                                 theta=staged(model.theta))


class NaiveBayesAlgorithm(
    Algorithm[PreparedClassificationData, NaiveBayesModel, dict, dict]
):
    params_class = NaiveBayesParams

    def train(
        self, ctx: ComputeContext, pd: PreparedClassificationData
    ) -> NaiveBayesModel:
        model = nb.fit_multinomial(
            pd.x,
            pd.y,
            n_classes=pd.n_classes,
            alpha=self.params.lambda_,
            mask=pd.mask,
        )
        return NaiveBayesModel(nb=model, label_map=pd.label_map)

    def stage_model(
        self, ctx: ComputeContext, model: NaiveBayesModel
    ) -> NaiveBayesModel:
        return dataclasses.replace(model, nb=stage_nb(ctx, model.nb))

    def _features(self, model: NaiveBayesModel, queries) -> torch.Tensor:
        x = np.asarray([q["features"] for q in queries], np.float32)
        return torch.as_tensor(x).to(model.nb.theta.device)

    def predict(self, model: NaiveBayesModel, query: dict) -> dict:
        scores = nb.log_scores(model.nb, self._features(model, [query]))[0]
        scores = scores.cpu().numpy()
        best = int(np.argmax(scores))
        return {
            "label": model.label_map.inverse(best),
            "scores": {
                model.label_map.inverse(c): float(scores[c])
                for c in range(model.nb.n_classes)
            },
        }

    def batch_predict(self, model: NaiveBayesModel, queries) -> list[dict]:
        if not queries:
            return []
        return self.batch_predict_collect(
            model, self.batch_predict_launch(model, queries), queries
        )

    def batch_predict_launch(self, model: NaiveBayesModel, queries):
        """Upload the features and enqueue the scoring; the handle is the
        class indices the card is still computing."""
        if not queries:
            return None
        return nb.predict_classes(model.nb, self._features(model, queries))

    def batch_predict_collect(
        self, model: NaiveBayesModel, handle, queries
    ) -> list[dict]:
        if handle is None:
            return []
        best = handle.cpu().numpy()  # waits for the card
        return [
            {"label": model.label_map.inverse(int(b))} for b in best
        ]


def classification_engine() -> Engine:
    return Engine(
        ClassificationDataSource,
        ClassificationPreparator,
        {"naive": NaiveBayesAlgorithm},
        FirstServing,
    )


register_engine("classification", classification_engine)
