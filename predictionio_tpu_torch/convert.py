"""Carry model weights into the port.

``als_model_from_numpy`` and ``from_jax_model`` build this package's
``ALSRecModel`` from host arrays; ``from_jax_template_model`` carries any
other template's model over (``ECommModel``, ``CPModel``, the naive
Bayes and text models, ``HelloModel``, ``RegressionModel``,
``LeadModel``), so the two packages can answer from the same weights.
None of them imports anything of the JAX package.
"""

from __future__ import annotations

import dataclasses
import importlib

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


def _host(value):
    """A JAX model field in this package's terms: arrays (``jax.Array``
    included, through ``__array__``) as numpy, id maps as this package's
    BiMap, nested template dataclasses converted, the rest as it is."""
    if type(value).__name__ == "BiMap":
        return BiMap(np.asarray(value.keys()))
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return from_jax_template_model(value)
    if hasattr(value, "__array__") and not isinstance(value, (str, bytes)):
        return np.asarray(value)
    return value


def from_jax_template_model(model):
    """This package's counterpart of a JAX package template model (the
    class of the same name at the same module path), every field carried
    over as a host value; staged tensors follow at ``stage_model``. The
    model store's allowlist names the classes that may be carried."""
    from predictionio_tpu_torch.core.persistence import _MODEL_CLASSES

    cls = type(model)
    sub = cls.__module__.partition(".")[2]
    if cls.__name__ not in _MODEL_CLASSES.get(sub, ()):
        raise TypeError(f"{cls.__module__}.{cls.__name__} is not a "
                        "template model this package carries")
    target = getattr(
        importlib.import_module(f"predictionio_tpu_torch.{sub}"),
        cls.__name__)
    return target(**{
        f.name: _host(getattr(model, f.name))
        for f in dataclasses.fields(target) if f.init
    })
