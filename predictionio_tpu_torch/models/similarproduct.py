"""Similar-product template — item-to-item similarity from ALS factors.

Counterpart of ``predictionio_tpu/models/similarproduct.py``: one ALS
per behavioural signal ("view", "like") over one shared item
vocabulary; item ``$set`` properties feed the category filter. Queries
``{"items": [...], "num": N, "categories": [...], "whiteList": [...],
"blackList": [...]}`` answer ``{"itemScores": [...]}``; a basket of
unknown items answers ``{"itemScores": []}``. Each algorithm ranks the
whole catalog by cosine against the mean of the basket's item rows with
the fused score + top-k kernel (``similarity.gather_mean_top_k_cosine``),
and ``SimilarProductServing`` sums the algorithms' scores per item.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    IdentityPreparator,
    Params,
    Serving,
    register_engine,
)
from predictionio_tpu_torch.core.controller import SanityCheck
from predictionio_tpu_torch.data.eventframe import Interactions
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.ops import similarity
from predictionio_tpu_torch.ops.als import train_als
from predictionio_tpu_torch.parallel import partition
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.utils.bimap import BiMap


@dataclasses.dataclass(frozen=True)
class SimilarDataSourceParams(Params):
    app_name: str = "MyApp"
    event_names: tuple[str, ...] = ("view", "like")
    item_entity_type: str = "item"


@dataclasses.dataclass
class SimilarTrainingData(SanityCheck):
    #: per-event-name interactions sharing one item vocabulary (one ALS
    #: per behavioural signal)
    interactions: dict[str, Interactions]
    item_categories: dict[str, list[str]]

    def sanity_check(self) -> None:
        if all(i.nnz == 0 for i in self.interactions.values()):
            raise ValueError("no view/like events found")


class SimilarDataSource(DataSource):
    params_class = SimilarDataSourceParams

    def read_training(self, ctx: ComputeContext) -> SimilarTrainingData:
        p = self.params
        store = EventStore()
        frame = store.frame(p.app_name, event_names=list(p.event_names))
        # one user and item vocabulary across signals, so every signal's
        # factor rows line up with the served item ids
        full = frame.to_interactions()
        interactions = {
            name: frame.filter_events([name]).to_interactions(
                entity_map=full.entity_map, target_map=full.target_map
            ).dedupe_sum()
            for name in p.event_names
        }
        props = store.aggregate_properties(
            p.app_name, entity_type=p.item_entity_type
        )
        categories = {
            eid: [str(c) for c in pm.get("categories") or []]
            for eid, pm in props.items()
        }
        return SimilarTrainingData(
            interactions=interactions, item_categories=categories
        )


@dataclasses.dataclass(frozen=True)
class SimilarALSParams(Params):
    """Same fields and defaults as the JAX package's, so one engine.json
    drives both."""

    event_name: str = "view"  # "like" trains on the like signal
    rank: int = 16
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int = 3
    block_len: int = 64
    row_chunk: int = 256


@dataclasses.dataclass
class SimilarModel:
    # [I, k]: np.ndarray after train and when loaded from the model
    # store; a tensor on the card after SimilarALSAlgorithm.stage_model
    item_factors: "np.ndarray | torch.Tensor"
    item_map: BiMap
    item_categories: dict[str, list[str]]
    #: [rows(item_factors)] bool, True on padding rows past the id map
    #: (None when there are none): the kernel's [I] mask
    item_phantom_mask: "torch.Tensor | None" = None


class SimilarALSAlgorithm(Algorithm):
    """ALS on (user, item) events of one signal → item factors; predict
    is the cosine top-k against the mean of the basket's item rows."""

    params_class = SimilarALSParams

    def train(self, ctx: ComputeContext, pd: SimilarTrainingData):
        p = self.params
        inter = pd.interactions.get(p.event_name)
        if inter is None or inter.nnz == 0:
            raise ValueError(f"no {p.event_name!r} events to train on")
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
            implicit=True,
            seed=p.seed,
            block_len=p.block_len,
            row_chunk=p.row_chunk,
        )
        return SimilarModel(
            item_factors=factors.item_factors,
            item_map=inter.target_map,
            item_categories=pd.item_categories,
        )

    def stage_model(
        self, ctx: ComputeContext, model: SimilarModel
    ) -> SimilarModel:
        """Put the item factors on ``ctx.device`` once; a query then
        uploads only its basket's indices."""
        item_f, item_mask = partition.stage_factor_matrix(
            ctx, model.item_factors, n_real=len(model.item_map)
        )
        return dataclasses.replace(
            model, item_factors=item_f, item_phantom_mask=item_mask
        )

    def predict(self, model: SimilarModel, query: dict) -> dict:
        items = query.get("items") or []
        num = int(query.get("num", 10))
        idx = [
            i
            for i in (model.item_map.get(it, -1) for it in items)
            if i >= 0
        ]
        if not idx:
            return {"itemScores": []}
        # the candidate pool leaves room for the basket's own items and
        # the filters, and is clamped to the real catalog
        n_items = len(model.item_map)
        k = min(1 << max(0, (num + len(idx) - 1)).bit_length(), n_items)
        # the basket pads to a power of two with -1 (left out of the mean)
        bucket = 1 << max(0, (len(idx) - 1)).bit_length()
        idx_arr = np.full(bucket, -1, np.int32)
        idx_arr[: len(idx)] = idx
        scores, cand = similarity.gather_mean_top_k_cosine(
            model.item_factors, idx_arr, k,
            mask=getattr(model, "item_phantom_mask", None),
        )
        # one device→host copy for both: the scores ride as int32 bits
        both = torch.stack([scores.view(torch.int32), cand]).cpu()
        scores = both[0, 0].view(torch.float32).numpy()
        cand = both[1, 0].numpy()

        categories = set(query.get("categories") or [])
        white = set(query.get("whiteList") or [])
        black = set(query.get("blackList") or [])
        query_items = set(items)
        out = []
        for score, ci in zip(scores, cand):
            item = model.item_map.inverse(int(ci))
            if item in query_items or item in black:
                continue
            if white and item not in white:
                continue
            if categories and not (
                categories & set(model.item_categories.get(item, []))
            ):
                continue
            out.append({"item": item, "score": float(score)})
            if len(out) >= num:
                break
        return {"itemScores": out}


class SimilarProductServing(Serving):
    """Sums the algorithms' cosine scores per item (each on [-1, 1]) and
    keeps the ``num`` best."""

    def serve(self, query, predictions):
        num = int(query.get("num", 10))
        combined: dict[str, float] = {}
        for p in predictions:
            for s in p.get("itemScores", []):
                combined[s["item"]] = combined.get(s["item"], 0.0) + s["score"]
        ranked = sorted(
            combined.items(), key=lambda kv: kv[1], reverse=True
        )[:num]
        return {
            "itemScores": [
                {"item": item, "score": score} for item, score in ranked
            ]
        }


def similarproduct_engine() -> Engine:
    return Engine(
        {"view": SimilarDataSource},
        IdentityPreparator,
        {"als": SimilarALSAlgorithm},
        SimilarProductServing,
    )


register_engine("similarproduct", similarproduct_engine)
