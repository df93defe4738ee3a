"""Carry model weights into the port.

Both functions build this package's ``ALSRecModel`` from host arrays, so
the two packages can answer from the same factors. Neither imports
anything of the JAX package.
"""

from __future__ import annotations

import numpy as np

from predictionio_tpu_torch.models.recommendation import ALSRecModel
from predictionio_tpu_torch.utils.bimap import BiMap


def als_model_from_numpy(
    user_factors, item_factors, user_ids, item_ids
) -> ALSRecModel:
    """An ALS model from ``[U, k]`` and ``[I, k]`` factor arrays (cast to
    float32) and the string ids of their rows, in row order."""
    user_factors = np.ascontiguousarray(user_factors, dtype=np.float32)
    item_factors = np.ascontiguousarray(item_factors, dtype=np.float32)
    if user_factors.ndim != 2 or item_factors.ndim != 2:
        raise ValueError("factor matrices must be 2-D")
    if user_factors.shape[1] != item_factors.shape[1]:
        raise ValueError(
            f"user rank {user_factors.shape[1]} != item rank "
            f"{item_factors.shape[1]}"
        )
    if len(user_ids) != user_factors.shape[0] or (
        len(item_ids) != item_factors.shape[0]
    ):
        raise ValueError("one id per factor row is required")
    return ALSRecModel(
        user_factors=user_factors,
        item_factors=item_factors,
        user_map=BiMap(np.asarray(user_ids)),
        item_map=BiMap(np.asarray(item_ids)),
    )


def from_jax_model(model) -> ALSRecModel:
    """The port's model from a JAX package ``ALSRecModel`` whose arrays
    are already host numpy (a trained or unpickled model, not a staged
    one). The id maps carry over as their key arrays; the phantom mask,
    if any, as a bool array."""
    mask = getattr(model, "item_phantom_mask", None)
    return ALSRecModel(
        user_factors=np.ascontiguousarray(model.user_factors, np.float32),
        item_factors=np.ascontiguousarray(model.item_factors, np.float32),
        user_map=BiMap(np.asarray(model.user_map.keys())),
        item_map=BiMap(np.asarray(model.item_map.keys())),
        item_phantom_mask=None if mask is None else np.asarray(mask, bool),
    )
