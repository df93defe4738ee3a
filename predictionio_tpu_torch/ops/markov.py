"""Markov chain: a row-normalized top-N transition model.

Counterpart of ``predictionio_tpu/ops/markov.py`` (the e2 library's
``MarkovChain``): from (from, to[, weight]) transitions, count on the
host with ``np.add.at``, normalize each row and keep its ``top_n``
transitions on the device. The top-N is a stable descending sort, so
equal probabilities list the lower state first, as ``lax.top_k`` does.
States are dense ids (map them with a BiMap upstream).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class MarkovChainModel:
    """Top-N transitions per state: indices [S, N], probs [S, N]."""

    indices: torch.Tensor
    probs: torch.Tensor

    @property
    def n_states(self) -> int:
        return self.indices.shape[0]


def _train_dense(counts: torch.Tensor, top_n: int) -> MarkovChainModel:
    row_sum = counts.sum(dim=1, keepdim=True)
    # guard only against /0: fractional row totals still normalize
    safe = torch.where(row_sum > 0, row_sum, 1.0)
    probs = torch.where(row_sum > 0, counts / safe, 0.0)
    top_probs, top_idx = torch.sort(probs, dim=1, descending=True,
                                    stable=True)
    return MarkovChainModel(indices=top_idx[:, :top_n].to(torch.int32),
                            probs=top_probs[:, :top_n])


def train_markov_chain(
    from_states: np.ndarray,
    to_states: np.ndarray,
    n_states: int,
    top_n: int = 10,
    weights: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> MarkovChainModel:
    """Count transitions → row-normalized top-N model on ``device``."""
    counts = np.zeros((n_states, n_states), np.float32)
    w = (
        np.asarray(weights, np.float32)
        if weights is not None
        else np.ones(len(from_states), np.float32)
    )
    np.add.at(counts, (np.asarray(from_states), np.asarray(to_states)), w)
    return _train_dense(torch.as_tensor(counts).to(device),
                        min(top_n, n_states))


def predict_next(
    model: MarkovChainModel, state: int
) -> list[tuple[int, float]]:
    """Next-state distribution for one state (sparse, prob-descending)."""
    idx = model.indices[state].cpu().numpy()
    probs = model.probs[state].cpu().numpy()
    return [(int(i), float(p)) for i, p in zip(idx, probs) if p > 0]
