"""E-commerce recommendation template: ALS plus serve-time business rules.

Counterpart of ``predictionio_tpu/models/ecommerce.py``. Implicit ALS
trains on view/buy events; ``predict`` ranks the catalog for a known
user with the fused score + top-k kernel (one B = 1
``similarity.gather_top_k_dot``) and then applies live rules read from
the event store at predict time: items the user has already seen, the
latest ``$set`` of the ``constraint`` entity ``unavailableItems``, and
the query's categories, whiteList and blackList. An unknown user gets
the catalog ranked by popularity (interaction counts) instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    Params,
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
class ECommDataSourceParams(Params):
    app_name: str = "MyApp"
    event_names: tuple[str, ...] = ("view", "buy")
    item_entity_type: str = "item"


@dataclasses.dataclass
class ECommTrainingData(SanityCheck):
    interactions: Interactions
    item_categories: dict[str, list[str]]

    def sanity_check(self) -> None:
        if self.interactions.nnz == 0:
            raise ValueError("no view/buy events found")


class ECommDataSource(DataSource):
    params_class = ECommDataSourceParams

    def read_training(self, ctx: ComputeContext) -> ECommTrainingData:
        p = self.params
        store = EventStore()
        frame = store.frame(p.app_name, event_names=list(p.event_names))
        props = store.aggregate_properties(
            p.app_name, entity_type=p.item_entity_type
        )
        return ECommTrainingData(
            interactions=frame.to_interactions().dedupe_sum(),
            item_categories={
                eid: [str(c) for c in pm.get("categories") or []]
                for eid, pm in props.items()
            },
        )


@dataclasses.dataclass(frozen=True)
class ECommAlgorithmParams(Params):
    """Same fields and defaults as the JAX package's, so one engine.json
    drives both."""

    app_name: str = "MyApp"          # for serve-time event reads
    seen_events: tuple[str, ...] = ("view", "buy")
    unseen_only: bool = True
    rank: int = 16
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int = 5
    block_len: int = 64
    row_chunk: int = 256


@dataclasses.dataclass
class ECommModel:
    # np.ndarray after train and when loaded from the model store; a
    # tensor on the card after ECommAlgorithm.stage_model
    user_factors: "np.ndarray | torch.Tensor"
    item_factors: "np.ndarray | torch.Tensor"
    user_map: BiMap
    item_map: BiMap
    item_categories: dict[str, list[str]]
    popularity: np.ndarray  # [I] interaction counts (cold-user fallback)
    #: [rows(item_factors)] bool, True on padding rows past the id map
    #: (None when there are none): the kernel's [I] mask
    item_phantom_mask: "torch.Tensor | None" = None


class ECommAlgorithm(Algorithm):
    params_class = ECommAlgorithmParams

    def train(self, ctx: ComputeContext, pd: ECommTrainingData) -> ECommModel:
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
            implicit=True,
            seed=p.seed,
            block_len=p.block_len,
            row_chunk=p.row_chunk,
        )
        popularity = np.bincount(
            inter.cols, weights=inter.values, minlength=inter.n_cols
        ).astype(np.float32)
        return ECommModel(
            user_factors=factors.user_factors,
            item_factors=factors.item_factors,
            user_map=inter.entity_map,
            item_map=inter.target_map,
            item_categories=pd.item_categories,
            popularity=popularity,
        )

    def stage_model(self, ctx: ComputeContext, model: ECommModel) -> ECommModel:
        """Both factor tables go to ``ctx.device`` once; popularity stays
        on the host, where the cold-user fallback ranks it."""
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

    # -- serve-time business rules ------------------------------------------
    def _seen_items(self, user: str) -> set[str]:
        if not self.params.unseen_only:
            return set()
        try:
            events = EventStore().find_by_entity(
                self.params.app_name,
                entity_type="user",
                entity_id=user,
                event_names=list(self.params.seen_events),
            )
        except Exception:  # store unavailable → serve without the rule
            return set()
        return {
            e.target_entity_id for e in events if e.target_entity_id
        }

    def _unavailable_items(self) -> set[str]:
        """The latest ``$set`` of constraint entity ``unavailableItems``,
        read each predict so availability changes without a retrain."""
        try:
            events = EventStore().find_by_entity(
                self.params.app_name,
                entity_type="constraint",
                entity_id="unavailableItems",
                event_names=["$set"],
                limit=1,
                latest=True,
            )
        except Exception:  # store unavailable → serve without the rule
            return set()
        if not events:
            return set()
        return {
            str(i) for i in events[0].properties.get("items") or []
        }

    def candidates(self, model: ECommModel, user_idx: int, num: int):
        """(scores, item indices) before the rules: a known user's
        top-``pow2(4·num)`` from the kernel, one device→host copy; an
        unknown user's ``4·num`` most popular items."""
        n_items = len(model.item_map)
        if user_idx >= 0:
            k = min(1 << max(0, (4 * num - 1)).bit_length(), n_items)
            scores, cand = similarity.gather_top_k_dot(
                model.user_factors,
                np.asarray([user_idx], np.int32),
                model.item_factors,
                k,
                mask=getattr(model, "item_phantom_mask", None),
            )
            # the float32 scores ride bit for bit as int32 beside the
            # indices
            both = torch.stack([scores.view(torch.int32), cand]).cpu()
            return both[0, 0].view(torch.float32).numpy(), both[1, 0].numpy()
        # numpy's default sort, as the JAX package ranks popularity ties
        order = np.argsort(-model.popularity)
        cand = order[: min(4 * num, n_items)]
        return model.popularity[cand], cand

    def predict(self, model: ECommModel, query: dict) -> dict:
        user = str(query.get("user", ""))
        num = int(query.get("num", 10))
        scores, cand = self.candidates(
            model, model.user_map.get(user, -1), num
        )
        seen = self._seen_items(user)
        unavailable = self._unavailable_items()
        categories = set(query.get("categories") or [])
        white = set(query.get("whiteList") or [])
        black = set(query.get("blackList") or [])
        out = []
        for score, ci in zip(scores, cand):
            item = model.item_map.inverse(int(ci))
            if item in seen or item in unavailable or item in black:
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


def ecommerce_engine() -> Engine:
    return Engine(
        ECommDataSource,
        IdentityPreparator,
        {"ecomm": ECommAlgorithm},
        FirstServing,
    )


register_engine("ecommerce", ecommerce_engine)
