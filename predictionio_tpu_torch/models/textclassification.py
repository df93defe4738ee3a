"""Text-classification template: hashed bag of words + multinomial NB.

Counterpart of ``predictionio_tpu/models/textclassification.py``.
Documents arrive as ``$set`` events on a ``document`` entity carrying
``text`` and ``label`` properties; a query ``{"text": "..."}`` answers
``{"label": ..., "scores": {...}}``. Tokens are feature-hashed (FNV-1a,
64-bit) into a fixed-width count vector, so the matrix shape
``[n_docs, n_features]`` does not depend on the corpus vocabulary; the
fit is the one-product multinomial NB of ``ops/naive_bayes.py`` and a
batch of queries is scored with one product on the device.
"""

from __future__ import annotations

import dataclasses
import logging
import re

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
from predictionio_tpu_torch.models.classification import stage_nb
from predictionio_tpu_torch.ops import naive_bayes as nb
from predictionio_tpu_torch.parallel.mesh import ComputeContext, ShardedTensor
from predictionio_tpu_torch.utils.bimap import BiMap

logger = logging.getLogger(__name__)

_TOKEN = re.compile(r"[a-z0-9']+")


def tokenize(text: str) -> list[str]:
    return _TOKEN.findall(text.lower())


_FNV_OFFSET = 14695981039346656037
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


def hash_counts(
    tokens: list[str], n_features: int, seed: int = 0
) -> np.ndarray:
    """Feature hashing: token → a stable bucket. Python's ``hash()`` is
    salted per process, so FNV-1a with explicit 64-bit wraparound keeps
    a model scoring alike across restarts and across both packages."""
    vec = np.zeros(n_features, np.float32)
    for tok in tokens:
        h = (_FNV_OFFSET + seed) & _MASK64
        for byte in tok.encode("utf-8"):
            h = ((h ^ byte) * _FNV_PRIME) & _MASK64
        vec[h % n_features] += 1.0
    return vec


@dataclasses.dataclass(frozen=True)
class TextDataSourceParams(Params):
    app_name: str = "MyApp"
    entity_type: str = "document"
    text_property: str = "text"
    label_property: str = "label"
    eval_k: int = 0  # >0 enables k-fold read_eval


@dataclasses.dataclass
class TextTrainingData(SanityCheck):
    texts: list[str]
    labels: list[str]

    def sanity_check(self) -> None:
        if not self.texts:
            raise ValueError("no labeled documents found — seed data first")
        if len(set(self.labels)) < 2:
            raise ValueError(
                "need at least two distinct labels to classify"
            )


class TextDataSource(DataSource[TextTrainingData, dict, dict, list]):
    params_class = TextDataSourceParams

    def read_training(self, ctx: ComputeContext) -> TextTrainingData:
        p = self.params
        props = EventStore().aggregate_properties(
            p.app_name, p.entity_type,
            required=[p.text_property, p.label_property],
        )
        texts, labels = [], []
        for pm in props.values():
            texts.append(str(pm[p.text_property]))
            labels.append(str(pm[p.label_property]))
        return TextTrainingData(texts=texts, labels=labels)

    def read_eval(self, ctx: ComputeContext):
        """k folds by index modulo k; the actuals are the held-out
        labels."""
        from predictionio_tpu_torch.core.evaluation import kfold_indices

        full = self.read_training(ctx)
        folds = []
        for fold, train_idx, test_idx in kfold_indices(
            len(full.texts), self.params.eval_k
        ):
            td = TextTrainingData(
                texts=[full.texts[i] for i in train_idx],
                labels=[full.labels[i] for i in train_idx],
            )
            qa = [
                ({"text": full.texts[i]}, full.labels[i])
                for i in test_idx
            ]
            folds.append((td, {"fold": fold}, qa))
        return folds


@dataclasses.dataclass(frozen=True)
class TextPreparatorParams(Params):
    #: width of the hashed feature vector
    n_features: int = 4096


@dataclasses.dataclass
class TextPrepared:
    x: ShardedTensor     # [n_pad, n_features] hashed counts over data
    y: ShardedTensor     # int32 [n_pad]
    mask: ShardedTensor  # float32 [n_pad] 1.0 real / 0.0 padding
    label_map: BiMap
    n_features: int


def hash_rows(texts, n_features: int) -> np.ndarray:
    """[len(texts), n_features] hashed counts of the tokenized texts."""
    return np.stack([hash_counts(tokenize(t), n_features) for t in texts])


class TextPreparator(Preparator[TextTrainingData, TextPrepared]):
    """Hash to the fixed width, pad rows to the data-axis multiple, and
    place them over the mesh's ``data`` axis, as in the JAX package (the
    fit's ``mask`` makes padded rows exact)."""

    params_class = TextPreparatorParams

    def prepare(
        self, ctx: ComputeContext, td: TextTrainingData
    ) -> TextPrepared:
        n = self.params.n_features
        label_map, y = BiMap.string_int_with_codes(np.asarray(td.labels))
        x = hash_rows(td.texts, n)
        return TextPrepared(
            x=ctx.shard_rows(x),
            y=ctx.shard_rows(y),
            mask=ctx.shard_rows(np.ones(len(td.texts), np.float32)),
            label_map=label_map,
            n_features=n,
        )


@dataclasses.dataclass(frozen=True)
class TextNBParams(Params):
    #: additive (Laplace) smoothing
    alpha: float = 1.0


@dataclasses.dataclass
class TextNBModel:
    nb_model: nb.MultinomialNBModel
    label_map: BiMap
    n_features: int


class TextNBAlgorithm(Algorithm[TextPrepared, TextNBModel, dict, dict]):
    params_class = TextNBParams

    def train(self, ctx: ComputeContext, data: TextPrepared) -> TextNBModel:
        model = nb.fit_multinomial(
            data.x, data.y,
            n_classes=len(data.label_map),
            alpha=self.params.alpha,
            mask=data.mask,
        )
        logger.info(
            "text NB: %d classes, %d hashed features",
            len(data.label_map), data.n_features,
        )
        return TextNBModel(
            nb_model=model,
            label_map=data.label_map,
            n_features=data.n_features,
        )

    def stage_model(
        self, ctx: ComputeContext, model: TextNBModel
    ) -> TextNBModel:
        return dataclasses.replace(
            model, nb_model=stage_nb(ctx, model.nb_model)
        )

    def predict(self, model: TextNBModel, query: dict) -> dict:
        return self.batch_predict(model, [query])[0]

    def batch_predict(self, model: TextNBModel, queries) -> list[dict]:
        if not queries:
            return []
        return self.batch_predict_collect(
            model, self.batch_predict_launch(model, queries), queries
        )

    def batch_predict_launch(self, model: TextNBModel, queries):
        """Hash on the host, enqueue the scoring; the handle is the log
        probabilities the card is still computing. The batch pads to a
        power of two, as in the JAX package."""
        if not queries:
            return None
        x = hash_rows([str(q.get("text", "")) for q in queries],
                      model.n_features)
        bucket = 1 << (len(queries) - 1).bit_length()
        x = np.pad(x, ((0, bucket - len(queries)), (0, 0)))
        theta = model.nb_model.theta
        return nb.log_scores(model.nb_model,
                             torch.as_tensor(x).to(theta.device))

    def batch_predict_collect(
        self, model: TextNBModel, handle, queries
    ) -> list[dict]:
        if handle is None:
            return []
        logp = handle[: len(queries)].cpu().numpy()  # waits for the card
        best = logp.argmax(axis=1)
        out = []
        for row, b in zip(logp, best):
            out.append({
                "label": model.label_map.inverse(int(b)),
                "scores": {
                    model.label_map.inverse(i): float(s)
                    for i, s in enumerate(row)
                },
            })
        return out

    def warmup_query(self) -> dict:
        return {"text": ""}


def textclassification_engine() -> Engine:
    return Engine(
        TextDataSource,
        TextPreparator,
        {"nb": TextNBAlgorithm},
        FirstServing,
    )


register_engine("textclassification", textclassification_engine)
