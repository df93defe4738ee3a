"""Naive Bayes: the sufficient statistics as one matrix product.

Counterpart of ``predictionio_tpu/ops/naive_bayes.py``. The per-class
feature sums are ``onehot(y).T @ X``, one ``[C, n] x [n, d]`` product on
the tensors' device, in float32 (no TF32: the counts must stay exact).
A padding row mask (1.0 real, 0.0 padding) makes padded batches exact.
Rows placed over the mesh's ``data`` axis (``ctx.shard_rows``) give one
product and one class count per row block, summed on the home device in
block order (:func:`~predictionio_tpu_torch.parallel.mesh.sum_over_data`),
where the JAX package lets GSPMD reduce them. The two models are
dataclasses of tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from predictionio_tpu_torch.parallel.mesh import ShardedTensor, sum_over_data


@dataclasses.dataclass
class MultinomialNBModel:
    """log-prior pi [C] and log-likelihood theta [C, d]."""

    pi: torch.Tensor
    theta: torch.Tensor

    @property
    def n_classes(self) -> int:
        return self.pi.shape[0]


def _onehot(y: torch.Tensor, n_classes: int, dtype, mask) -> torch.Tensor:
    onehot = torch.nn.functional.one_hot(y.long(), n_classes).to(dtype)
    if mask is not None:
        onehot = onehot * mask[:, None].to(dtype)
    return onehot


def class_sums(
    x: torch.Tensor | ShardedTensor,
    y: torch.Tensor | ShardedTensor,
    n_classes: int,
    mask: torch.Tensor | ShardedTensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(class_count [C], feat_sum [C, d])`` of the (masked) rows: per
    row block ``onehot.sum(0)`` and ``onehot.T @ x``, summed in block
    order on the home device."""

    def block(xb, yb, mb=None):
        onehot = _onehot(yb, n_classes, xb.dtype, mb)   # [n, C]
        return onehot.sum(dim=0), onehot.T @ xb

    return sum_over_data(block, *((x, y) if mask is None else (x, y, mask)))


def fit_multinomial(
    x: torch.Tensor | ShardedTensor,
    y: torch.Tensor | ShardedTensor,
    n_classes: int,
    alpha: float = 1.0,
    mask: torch.Tensor | ShardedTensor | None = None,
) -> MultinomialNBModel:
    """Multinomial NB fit (MLlib NaiveBayes semantics, lambda=alpha).

    x: [n, d] non-negative features; y: [n] int labels;
    mask: [n] 1.0 for real rows, 0.0 for padding. Tensors, or rows over
    the mesh's ``data`` axis: ``pi`` and ``theta`` then come from the
    summed blocks, on the home device.
    """
    d = x.shape[1]
    class_count, feat_sum = class_sums(x, y, n_classes, mask)
    total = class_count.sum()
    pi = torch.log(class_count + alpha) - torch.log(
        total + alpha * n_classes
    )
    theta = torch.log(feat_sum + alpha) - torch.log(
        feat_sum.sum(dim=1, keepdim=True) + alpha * d
    )
    return MultinomialNBModel(pi=pi, theta=theta)


def log_scores(model: MultinomialNBModel, x: torch.Tensor) -> torch.Tensor:
    """Joint log-scores [n, C] for feature rows [n, d]."""
    return x @ model.theta.T + model.pi[None, :]


def predict_classes(model: MultinomialNBModel, x: torch.Tensor) -> torch.Tensor:
    """The best class per row; ties go to the lower class, as
    ``jnp.argmax`` breaks them."""
    return torch.argmax(log_scores(model, x), dim=1)


# -- categorical NB (string features, the e2 CategoricalNaiveBayes) ---------


@dataclasses.dataclass
class CategoricalNBModel:
    """Per-class priors and per-(feature slot, value) log-likelihoods
    over concatenated one-hot blocks, normalized per slot."""

    pi: torch.Tensor     # [C]
    theta: torch.Tensor  # [C, sum(vocab_sizes)]


def encode_categorical(
    codes: np.ndarray, vocab_sizes: list[int]
) -> np.ndarray:
    """[n, J] int codes → [n, sum(vocab)] concatenated one-hot (host)."""
    n, j = codes.shape
    assert j == len(vocab_sizes)
    offsets = np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]])
    out = np.zeros((n, int(sum(vocab_sizes))), dtype=np.float32)
    rows = np.arange(n)
    for slot, off in enumerate(offsets):
        valid = codes[:, slot] >= 0
        out[rows[valid], off + codes[valid, slot]] = 1.0
    return out


def fit_categorical(
    onehot_x: torch.Tensor,
    y: torch.Tensor,
    n_classes: int,
    vocab_sizes: tuple[int, ...],
    alpha: float = 1.0,
    mask: torch.Tensor | None = None,
) -> CategoricalNBModel:
    """Categorical NB over concatenated one-hot blocks."""
    onehot_y = _onehot(y, n_classes, onehot_x.dtype, mask)
    class_count = onehot_y.sum(dim=0)
    counts = onehot_y.T @ onehot_x  # [C, sum(vocab)]
    total = class_count.sum()
    pi = torch.log(class_count + alpha) - torch.log(
        total + alpha * n_classes
    )
    # per feature slot: the class count + alpha*|V_j| below
    blocks = []
    off = 0
    for size in vocab_sizes:
        block = counts[:, off:off + size]
        blocks.append(
            torch.log(block + alpha)
            - torch.log(class_count[:, None] + alpha * size)
        )
        off += size
    theta = torch.cat(blocks, dim=1)
    return CategoricalNBModel(pi=pi, theta=theta)


def categorical_log_scores(
    model: CategoricalNBModel, onehot_x: torch.Tensor
) -> torch.Tensor:
    return onehot_x @ model.theta.T + model.pi[None, :]
