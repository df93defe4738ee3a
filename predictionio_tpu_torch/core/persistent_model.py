"""MANUAL persistence to the local filesystem.

Counterpart of ``predictionio_tpu/core/persistent_model.py``
(``LocalFileSystemPersistentModel``, ``save_persistent_model``,
``load_persistent_model``): an algorithm that mixes in
:class:`LocalFileSystemPersistentModel` gets ``persistence_mode=MANUAL``
and working ``save_model`` / ``load_model`` for dataclass, dict and
bare-array models, under the same directory layout,
``$PIO_FS_BASEDIR/pmodels/<AlgoClass>/<instance_id>/``, and with the
same typed errors for a missing or a damaged directory.

A model is split one level deep into

* **array state**: numpy array and tensor fields, written to
  ``state/arrays.npz`` (a tensor leaves its device first and comes back
  as a tensor, on the device the loader names, in its own dtype), and
* **the skeleton**: everything else, pickled to ``aux.pkl`` and read
  back through the model store's allowlist unpickler, widened only by
  the classes the caller names.

The JAX package writes its array state as an orbax checkpoint, which
cannot be read without JAX; so the two packages do not share MANUAL
model files. A MANUAL model trained by one package is retrained, not
loaded, by the other. (AUTO models, pickled into the model store, are
shared.)
"""

from __future__ import annotations

import dataclasses
import io
import logging
import os
import pickle
import shutil
import sys
from typing import Any

import numpy as np
import torch

from predictionio_tpu_torch.core.controller import PersistenceMode
from predictionio_tpu_torch.core.persistence import _ModelUnpickler
from predictionio_tpu_torch.utils.npzio import atomic_savez

logger = logging.getLogger(__name__)

_AUX_FILE = "aux.pkl"
_STATE_DIR = "state"
_ARRAYS_FILE = "arrays.npz"
_ARRAY_KINDS = (np.ndarray, torch.Tensor)


class PersistentModelError(RuntimeError):
    """A MANUAL-persistence restore failed: the directory is damaged
    (partial write, missing state, unreadable arrays). Typed so that a
    deploy can tell a corrupt model from a programming error and fall
    back to the last good generation instead of serving half a model."""


class PersistentModelMissing(PersistentModelError, FileNotFoundError):
    """No persistent model exists at the directory (never saved, or
    deleted), as opposed to a damaged one."""


def _base_dir() -> str:
    return os.environ.get(
        "PIO_FS_BASEDIR", os.path.join(os.path.expanduser("~"), ".piotpu")
    )


def _split_model(model: Any) -> tuple[dict[str, Any], Any]:
    """(array fields, picklable skeleton). Dataclasses and dicts split
    one level deep, array-valued entries leaving a ``None`` behind; a
    bare array is all state; anything else is all skeleton."""
    if dataclasses.is_dataclass(model) and not isinstance(model, type):
        arrays = {
            f.name: getattr(model, f.name)
            for f in dataclasses.fields(model)
            if isinstance(getattr(model, f.name), _ARRAY_KINDS)
        }
        return arrays, dataclasses.replace(
            model, **{k: None for k in arrays}
        )
    if isinstance(model, dict):
        arrays = {
            k: v for k, v in model.items()
            if isinstance(k, str) and isinstance(v, _ARRAY_KINDS)
        }
        return arrays, {k: v for k, v in model.items() if k not in arrays}
    if isinstance(model, _ARRAY_KINDS):
        return {"__model__": model}, None
    return {}, model


def _join_model(arrays: dict[str, Any], skeleton: Any) -> Any:
    if "__model__" in arrays and skeleton is None:
        return arrays["__model__"]
    if dataclasses.is_dataclass(skeleton) and not isinstance(skeleton, type):
        return dataclasses.replace(skeleton, **arrays)
    if isinstance(skeleton, dict):
        return {**skeleton, **arrays}
    return skeleton


def _to_numpy(value) -> tuple[np.ndarray, str | None]:
    """(host array, the tensor's dtype name, or None for numpy)."""
    if isinstance(value, np.ndarray):
        return value, None
    t = value.detach().cpu()
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.float()  # numpy has no bfloat16; cast back at load
    return t.numpy(), dtype


def save_persistent_model(
    directory: str, model: Any, overwrite: bool = True
) -> str:
    """Write ``model`` as array state plus a pickled skeleton; the
    skeleton lands last, so a directory without it holds no model."""
    directory = os.path.abspath(directory)
    if overwrite and os.path.exists(directory):
        shutil.rmtree(directory)
    os.makedirs(directory, exist_ok=True)
    arrays, skeleton = _split_model(model)
    tensors = {}
    if arrays:
        host = {}
        for key, value in arrays.items():
            host[key], dtype = _to_numpy(value)
            if dtype is not None:
                tensors[key] = dtype
        atomic_savez(os.path.join(directory, _STATE_DIR, _ARRAYS_FILE),
                     **host)
    tmp = os.path.join(directory, _AUX_FILE + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(
            {"skeleton": skeleton, "array_keys": sorted(arrays),
             "tensors": tensors},
            f,
            protocol=pickle.HIGHEST_PROTOCOL,
        )
    os.replace(tmp, os.path.join(directory, _AUX_FILE))
    logger.info(
        "persistent model saved to %s (%d array field(s))",
        directory, len(arrays),
    )
    return directory


def load_persistent_model(
    directory: str,
    device: str | torch.device | None = None,
    classes: tuple[type, ...] = (),
) -> Any:
    """Restore a model; every failure raises a typed error.

    * no model at all → :class:`PersistentModelMissing` (also a
      ``FileNotFoundError``);
    * an unreadable skeleton, a missing or unreadable ``state/``, or
      state lacking a declared field → :class:`PersistentModelError`.

    Never returns half a model. Tensor fields come back as tensors on
    ``device`` (the CPU when None); numpy fields as numpy. The skeleton
    may name the model store's classes and ``classes`` (for instance the
    algorithm's own model dataclass), nothing else."""
    directory = os.path.abspath(directory)
    aux_path = os.path.join(directory, _AUX_FILE)
    if not os.path.exists(aux_path):
        raise PersistentModelMissing(
            f"no persistent model at {directory} (missing {_AUX_FILE})"
        )
    extra = {(c.__module__, c.__qualname__): c for c in classes}
    try:
        with open(aux_path, "rb") as f:
            aux = _ModelUnpickler(io.BytesIO(f.read()), extra).load()
        array_keys = aux["array_keys"]
        tensors = aux.get("tensors", {})
        skeleton = aux["skeleton"]
    except Exception as e:  # noqa: BLE001 - a damaged pickle surfaces typed
        raise PersistentModelError(
            f"persistent model at {directory}: unreadable {_AUX_FILE}: {e}"
        ) from e
    arrays: dict[str, Any] = {}
    if array_keys:
        state_dir = os.path.join(directory, _STATE_DIR)
        if not os.path.isdir(state_dir):
            # the skeleton committed but the array state never did (a
            # crash between the two writes, or a partial copy)
            raise PersistentModelError(
                f"persistent model at {directory}: aux declares "
                f"{len(array_keys)} array field(s) but {_STATE_DIR}/ "
                "is missing (partial checkpoint)"
            )
        try:
            with np.load(os.path.join(state_dir, _ARRAYS_FILE),
                         allow_pickle=False) as npz:
                state = {k: npz[k] for k in npz.files}
        except Exception as e:  # noqa: BLE001 - any read failure -> typed
            raise PersistentModelError(
                f"persistent model at {directory}: array state "
                f"unreadable: {e}"
            ) from e
        missing = [k for k in array_keys if k not in state]
        if missing:
            raise PersistentModelError(
                f"persistent model at {directory}: restored state is "
                f"missing array field(s) {missing} (torn checkpoint)"
            )
        for key in array_keys:
            if key not in tensors:
                arrays[key] = state[key]
                continue
            dtype = getattr(torch, str(tensors[key]), None)
            if not isinstance(dtype, torch.dtype):
                raise PersistentModelError(
                    f"persistent model at {directory}: field {key!r} "
                    f"names no tensor dtype ({tensors[key]!r})"
                )
            arrays[key] = torch.as_tensor(state[key]).to(
                device=device or "cpu", dtype=dtype)
    return _join_model(arrays, skeleton)


class LocalFileSystemPersistentModel:
    """Algorithm mixin: MANUAL persistence to the local filesystem.

    ``load_model`` puts tensor fields on ``ctx.device`` and lets the
    skeleton name the classes defined in the algorithm's own module
    (override :meth:`persistent_model_classes` to name others)."""

    persistence_mode = PersistenceMode.MANUAL

    def persistent_model_dir(self, instance_id: str) -> str:
        return os.path.join(
            _base_dir(), "pmodels", type(self).__name__, instance_id
        )

    def persistent_model_classes(self) -> tuple[type, ...]:
        module = sys.modules.get(type(self).__module__)
        return tuple(
            v for v in vars(module).values()
            if isinstance(v, type) and v.__module__ == module.__name__
        ) if module is not None else ()

    def save_model(self, instance_id: str, model: Any) -> None:
        save_persistent_model(self.persistent_model_dir(instance_id), model)

    def load_model(self, instance_id: str, ctx: Any) -> Any:
        return load_persistent_model(
            self.persistent_model_dir(instance_id),
            device=getattr(ctx, "device", None),
            classes=self.persistent_model_classes(),
        )
