"""Recommendation template — implicit/explicit ALS.

Counterpart of ``predictionio_tpu/models/recommendation.py``: ``rate``
events (user → item, with a rating property) are read from the event
store, deduplicated, and trained into factor matrices on the card
(``ops/als.py``); queries ``{"user": id, "num": N}`` answer
``{"itemScores": [{"item": id, "score": s}, ...]}``, and an unknown user
answers ``{"itemScores": []}``. Serving gathers the users' factor rows on
the card and ranks the whole item table with the fused score + top-k
kernel; evaluation (``read_eval``) holds out k folds of the events and
ranks every held-out user of a fold in one batch through the same
kernel.
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
from predictionio_tpu_torch.core.evaluation import kfold_indices
from predictionio_tpu_torch.data.eventframe import Interactions
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.ops import similarity
from predictionio_tpu_torch.ops.als import train_als
from predictionio_tpu_torch.parallel import partition
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.utils.bimap import BiMap

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RecDataSourceParams(Params):
    app_name: str = "MyApp"
    event_names: tuple[str, ...] = ("rate",)
    rating_key: str | None = "rating"
    eval_k: int = 0


@dataclasses.dataclass
class RecTrainingData(SanityCheck):
    interactions: Interactions

    def sanity_check(self) -> None:
        if self.interactions.nnz == 0:
            raise ValueError("no interaction events found")


class RecDataSource(DataSource):
    params_class = RecDataSourceParams

    def _interactions(self) -> Interactions:
        p = self.params
        return EventStore().interactions(
            p.app_name,
            event_names=list(p.event_names),
            value_key=p.rating_key,
        )

    def read_training(self, ctx: ComputeContext) -> RecTrainingData:
        return RecTrainingData(interactions=self._interactions())

    def read_eval(self, ctx: ComputeContext):
        """``eval_k`` folds by index modulo k over the interactions. Each
        training fold keeps the full user and item maps (so every fold
        trains factors of one shape); the held-out items, grouped by
        user in first-seen order, are the actuals of one query a user,
        whose ``num`` is ``max(10, len(items))``."""
        inter = self._interactions()
        folds = []
        for fold, train_idx, test_idx in kfold_indices(
            inter.nnz, self.params.eval_k
        ):
            train = Interactions(
                entity_map=inter.entity_map,
                target_map=inter.target_map,
                rows=inter.rows[train_idx],
                cols=inter.cols[train_idx],
                values=inter.values[train_idx],
                times=inter.times[train_idx],
            )
            by_user: dict[int, list[str]] = {}
            for r, c in zip(inter.rows[test_idx], inter.cols[test_idx]):
                by_user.setdefault(int(r), []).append(
                    inter.target_map.inverse(int(c))
                )
            qa = [
                (
                    {
                        "user": inter.entity_map.inverse(u),
                        "num": max(10, len(items)),
                    },
                    items,
                )
                for u, items in by_user.items()
            ]
            folds.append(
                (RecTrainingData(interactions=train), {"fold": fold}, qa)
            )
        return folds


@dataclasses.dataclass(frozen=True)
class RecPreparatorParams(Params):
    dedupe: str = "sum"  # "sum" (implicit counts) | "latest" (ratings)


class RecPreparator(Preparator):
    """Dedupe repeated (user, item) events: sum for implicit counts,
    keep the latest for rating data."""

    params_class = RecPreparatorParams

    def prepare(
        self, ctx: ComputeContext, td: RecTrainingData
    ) -> RecTrainingData:
        inter = td.interactions
        deduped = (
            inter.dedupe_latest()
            if self.params.dedupe == "latest"
            else inter.dedupe_sum()
        )
        return RecTrainingData(interactions=deduped)


@dataclasses.dataclass(frozen=True)
class ALSParams(Params):
    """Same fields and defaults as the JAX package's ``ALSParams``, so
    one engine.json variant drives both."""

    rank: int = 32
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    implicit: bool = True
    seed: int = 13
    block_len: int = 64
    row_chunk: int = 256
    compute_dtype: str = ""
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    resume: bool = False
    factor_sharding: str = "auto"


@dataclasses.dataclass
class ALSRecModel:
    # np.ndarray after train and when loaded from the model store;
    # tensors on the card after ALSAlgorithm.stage_model (ShardedTensor
    # on a mesh with a model axis above 1, QuantizedFactors after a
    # quantized deploy)
    user_factors: "np.ndarray | torch.Tensor"
    item_factors: "np.ndarray | torch.Tensor"
    user_map: BiMap
    item_map: BiMap
    #: [rows(item_factors)] bool, True on padding rows past the id map
    #: (None when there are none); serving passes it as the kernel's [I]
    #: mask so a padded row never surfaces as a recommendation
    item_phantom_mask: "torch.Tensor | None" = None


class ALSAlgorithm(Algorithm):
    params_class = ALSParams

    def train(self, ctx: ComputeContext, pd: RecTrainingData) -> ALSRecModel:
        """ALS on ``ctx.device`` (``ctx=None``: the current CUDA device,
        raising without one); the model keeps host numpy factors, which
        is what the model store persists."""
        p = self.params
        inter = pd.interactions
        factors = train_als(
            ctx,
            inter.rows,
            inter.cols,
            inter.values,
            n_users=inter.n_rows,
            n_items=inter.n_cols,
            rank=p.rank,
            iterations=p.num_iterations,
            reg=p.lambda_,
            alpha=p.alpha,
            implicit=p.implicit,
            seed=p.seed,
            block_len=p.block_len,
            row_chunk=p.row_chunk,
            compute_dtype=p.compute_dtype or None,
            timer=self.timer,
            checkpoint_dir=p.checkpoint_dir or None,
            checkpoint_every=p.checkpoint_every,
            resume=p.resume,
            factor_sharding=p.factor_sharding,
        )
        return ALSRecModel(
            user_factors=factors.user_factors,
            item_factors=factors.item_factors,
            user_map=inter.entity_map,
            item_map=inter.target_map,
        )

    # -- serving ----------------------------------------------------------
    def stage_model(
        self, ctx: ComputeContext, model: ALSRecModel
    ) -> ALSRecModel:
        """Put both factor matrices on ``ctx``'s devices once, row-sharded
        over ``model`` when that axis is above 1 (a sharded result of
        ``train_als(return_layout="device")`` passes straight through);
        each request then uploads only its int user indices."""
        user_f, _ = partition.stage_factor_matrix(
            ctx, model.user_factors, n_real=len(model.user_map)
        )
        item_f, item_mask = partition.stage_factor_matrix(
            ctx, model.item_factors, n_real=len(model.item_map)
        )
        return dataclasses.replace(
            model,
            user_factors=user_f,
            item_factors=item_f,
            item_phantom_mask=item_mask,
        )

    def predict(self, model: ALSRecModel, query: dict) -> dict:
        return self.batch_predict(model, [query])[0]

    def batch_predict(self, model: ALSRecModel, queries) -> list[dict]:
        if not queries:
            return []
        return self.batch_predict_collect(
            model, self.batch_predict_launch(model, queries), queries
        )

    def batch_predict_launch(self, model: ALSRecModel, queries):
        """Host prep + kernel launch, no wait: the handle holds tensors
        the card is still computing, so the micro-batcher can launch the
        next batch meanwhile. ``num`` clamps to the real catalog."""
        if not queries:
            return None
        n_items = len(model.item_map)
        num = max(int(q.get("num", 10)) for q in queries)
        num = min(num, n_items)
        # batch rows and top-k size round up to powers of two, as in
        # the JAX package, so every request shape is one warmup covered
        num_bucket = min(1 << max(0, (num - 1)).bit_length(), n_items)
        user_idx = np.asarray(
            [model.user_map.get(q.get("user", ""), -1) for q in queries],
            np.int32,
        )
        idx = np.clip(user_idx, 0, None)
        batch_bucket = 1 << max(0, (len(idx) - 1)).bit_length()
        if batch_bucket > len(idx):
            idx = np.pad(idx, (0, batch_bucket - len(idx)))
        scores, items = similarity.gather_top_k_dot(
            model.user_factors, idx, model.item_factors, num_bucket,
            mask=getattr(model, "item_phantom_mask", None),
        )
        return scores, items, user_idx, num

    def batch_predict_collect(
        self, model: ALSRecModel, handle, queries
    ) -> list[dict]:
        """Wait for a launch handle and build one answer per query."""
        if handle is None:
            return []
        scores, items, user_idx, num = handle
        # one device→host copy for both results: the float32 scores ride
        # bit for bit as int32 beside the indices
        both = torch.stack([scores.view(torch.int32), items]).cpu()
        scores = both[0].view(torch.float32).numpy()
        items = both[1].numpy()
        out = []
        for i, q in enumerate(queries):
            if user_idx[i] < 0:
                out.append({"itemScores": []})  # unknown user
                continue
            n = min(int(q.get("num", 10)), num)
            out.append(
                {
                    "itemScores": [
                        {
                            "item": model.item_map.inverse(int(items[i, j])),
                            "score": float(scores[i, j]),
                        }
                        for j in range(n)
                    ]
                }
            )
        return out


def recommendation_engine() -> Engine:
    return Engine(
        RecDataSource,
        RecPreparator,
        {"als": ALSAlgorithm},
        FirstServing,
    )


register_engine("recommendation", recommendation_engine)
