"""Generic k-fold cross-validation split.

Counterpart of ``predictionio_tpu/core/crossvalidation.py``:
``split_data(k, dataset, training_creator, test_creator)`` produces the
``read_eval`` fold shape, ``[(training_data, eval_info, [(query,
actual)])]``, by index modulo k. Templates with their own fold logic
(the recommendation template groups held-out items by user) keep their
own ``read_eval``; this is the reusable default.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, TypeVar

D = TypeVar("D")   # one example
TD = TypeVar("TD")

def split_data(
    eval_k: int,
    dataset: Sequence[D],
    training_creator: Callable[[Sequence[D]], TD],
    test_creator: Callable[[D], tuple[Any, Any]],
) -> list[tuple[TD, dict, list[tuple[Any, Any]]]]:
    """k folds by ``index % k``; fold i tests on examples ≡ i (mod k)."""
    if eval_k < 2:
        raise ValueError("eval_k must be >= 2")
    folds = []
    for fold in range(eval_k):
        training = [
            d for i, d in enumerate(dataset) if i % eval_k != fold
        ]
        testing = [d for i, d in enumerate(dataset) if i % eval_k == fold]
        folds.append(
            (
                training_creator(training),
                {"fold": fold, "k": eval_k},
                [test_creator(d) for d in testing],
            )
        )
    return folds
