"""Complementary-purchase template: "frequently bought together".

Counterpart of ``predictionio_tpu/models/complementarypurchase.py``.
Each user's ``buy`` events split into baskets at ``basket_window_secs``
gaps; the baskets become multi-hot rows ``B`` and the co-occurrence table
is ``C += Bᵀ B``, one float32 matrix product a chunk of baskets on the
device (no TF32: ``C`` holds exact integer counts up to 2**24 baskets).
Lift or confidence scores follow from ``C`` elementwise, and each item's
``top_k`` complements are taken by a stable descending sort, so equal
scores list the lower item first, as ``lax.top_k`` does. The trained
model is two host arrays; serving merges the queried items' complement
lists on the host with no device work.
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
    IdentityPreparator,
    Params,
    register_engine,
)
from predictionio_tpu_torch.core.controller import SanityCheck
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.utils.bimap import BiMap

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CPDataSourceParams(Params):
    app_name: str = "MyApp"
    event_names: tuple[str, ...] = ("buy",)
    #: a gap longer than this starts a new basket for the user
    basket_window_secs: float = 3600.0


@dataclasses.dataclass
class CPTrainingData(SanityCheck):
    item_map: BiMap
    #: per basket: sorted unique dense item ids
    baskets: list[np.ndarray]

    def sanity_check(self) -> None:
        if not self.baskets:
            raise ValueError("no buy events found — seed data first")
        if all(len(b) < 2 for b in self.baskets):
            raise ValueError(
                "no basket contains two items; co-occurrence needs "
                "multi-item baskets (check basket_window_secs)"
            )


def split_baskets(
    rows: np.ndarray, cols: np.ndarray, times: np.ndarray, window: float
) -> list[np.ndarray]:
    """Group (user, item, time) by user, order by time, and start a new
    basket wherever the gap exceeds ``window``; each basket holds its
    sorted unique item ids."""
    if not len(rows):
        return []
    order = np.lexsort((times, rows))
    users, items, times = rows[order], cols[order], times[order]
    new_user = np.empty(len(users), bool)
    new_user[0] = True
    new_user[1:] = users[1:] != users[:-1]
    gap = np.empty(len(users), bool)
    gap[0] = True
    gap[1:] = (times[1:] - times[:-1]) > window
    bounds = np.append(np.flatnonzero(new_user | gap), len(users))
    return [
        np.unique(items[lo:hi]).astype(np.int32)
        for lo, hi in zip(bounds[:-1], bounds[1:])
    ]


class CPDataSource(DataSource[CPTrainingData, dict, dict, list]):
    params_class = CPDataSourceParams

    def read_training(self, ctx: ComputeContext) -> CPTrainingData:
        p = self.params
        inter = EventStore().interactions(
            p.app_name, event_names=list(p.event_names)
        )
        return CPTrainingData(
            item_map=inter.target_map,
            baskets=split_baskets(inter.rows, inter.cols, inter.times,
                                  p.basket_window_secs),
        )


@dataclasses.dataclass(frozen=True)
class CPAlgoParams(Params):
    """``metric``: "lift" (P(i,j)·N / (P(i)P(j)), the default) or
    "confidence" (P(j|i)). ``min_support``: the fewest baskets an item
    pair must share. ``top_k``: complements stored per item. Same fields
    and defaults as the JAX package's."""

    metric: str = "lift"
    min_support: int = 2
    top_k: int = 20
    #: baskets per device chunk of the BᵀB accumulation
    chunk: int = 1024


@dataclasses.dataclass
class CPModel:
    item_map: BiMap
    topk_items: np.ndarray   # int32 [n_items, k] (dense ids; -1 pad)
    topk_scores: np.ndarray  # float32 [n_items, k]

    def complements(self, item: str, num: int) -> list[tuple[str, float]]:
        idx = self.item_map.get(item)
        if idx is None:
            return []
        out = []
        for j, s in zip(self.topk_items[idx], self.topk_scores[idx]):
            if j < 0 or s <= 0:
                continue
            out.append((self.item_map.inverse(int(j)), float(s)))
            if len(out) >= num:
                break
        return out


def cooccurrence(baskets, n_items: int, chunk: int, device) -> torch.Tensor:
    """``C = Σ Bᵀ B`` over chunks of ``chunk`` baskets, float32 on
    ``device``: each chunk's multi-hot ``B`` is scattered on the device
    from the baskets' (row, item) pairs."""
    C = torch.zeros((n_items, n_items), dtype=torch.float32, device=device)
    for lo in range(0, len(baskets), chunk):
        group = baskets[lo:lo + chunk]
        lens = np.fromiter((len(b) for b in group), np.int64, len(group))
        rows = torch.as_tensor(np.repeat(np.arange(len(group)), lens),
                               device=device)
        cols = torch.as_tensor(
            np.concatenate(group).astype(np.int64) if lens.sum()
            else np.zeros(0, np.int64), device=device)
        B = torch.zeros((len(group), n_items), dtype=torch.float32,
                        device=device)
        B[rows, cols] = 1.0
        C.addmm_(B.T, B)
    return C


def score_top_k(C: torch.Tensor, n_baskets: int, metric: str,
                min_support: int, top_k: int):
    """Per item, the ``top_k`` best complements by lift or confidence
    (pairs below ``min_support`` and self-pairs score 0): ``(scores,
    indices)`` on ``C``'s device, equal scores lower index first."""
    n = C.shape[0]
    pair = C * (1.0 - torch.eye(n, dtype=C.dtype, device=C.device))
    counts = torch.diagonal(C)  # baskets containing each item
    if metric == "confidence":
        s = pair / torch.clamp(counts[:, None], min=1.0)
    else:  # lift
        s = (pair * float(max(n_baskets, 1))
             / torch.clamp(counts[:, None] * counts[None, :], min=1.0))
    s = torch.where(pair >= min_support, s, 0.0)
    scores, idx = torch.sort(s, dim=1, descending=True, stable=True)
    k = min(top_k, n)
    return scores[:, :k], idx[:, :k]


class CPAlgorithm(Algorithm[CPTrainingData, CPModel, dict, dict]):
    params_class = CPAlgoParams

    def train(self, ctx: ComputeContext, data: CPTrainingData) -> CPModel:
        p = self.params
        if p.metric not in ("lift", "confidence"):
            raise ValueError(
                f"metric must be 'lift' or 'confidence', got {p.metric!r}"
            )
        n_items = len(data.item_map)
        n_baskets = len(data.baskets)
        C = cooccurrence(data.baskets, n_items, p.chunk, ctx.device)
        scores, idx = score_top_k(C, n_baskets, p.metric, p.min_support,
                                  p.top_k)
        scores = scores.cpu().numpy()
        idx = np.where(scores > 0, idx.cpu().numpy(), -1).astype(np.int32)
        logger.info(
            "complementary-purchase model: %d items, %d baskets, "
            "metric=%s", n_items, n_baskets, p.metric,
        )
        return CPModel(
            item_map=data.item_map, topk_items=idx, topk_scores=scores
        )

    def predict(self, model: CPModel, query: dict) -> dict:
        # a repeated item must not double its scores; order kept
        items = list(dict.fromkeys(query.get("items") or []))
        queried = set(items)
        num = int(query.get("num", 10))
        full_k = model.topk_items.shape[1]
        merged: dict[str, float] = {}
        for item in items:
            # merged over each item's whole stored list: cutting each
            # list first would misrank complements several items share
            for other, score in model.complements(item, full_k):
                if other in queried:
                    continue
                merged[other] = merged.get(other, 0.0) + score
        ranked = sorted(merged.items(), key=lambda kv: -kv[1])[:num]
        return {
            "itemScores": [
                {"item": item, "score": score} for item, score in ranked
            ]
        }

    def warmup_query(self) -> dict:
        return {"items": [], "num": 1}


def complementarypurchase_engine() -> Engine:
    return Engine(
        CPDataSource,
        IdentityPreparator,
        {"cooccurrence": CPAlgorithm},
        FirstServing,
    )


register_engine("complementarypurchase", complementarypurchase_engine)
