"""Model persistence — model blobs and transactional generations.

Counterpart of ``predictionio_tpu/core/persistence.py``. A published
generation is the model blob plus a JSON manifest recording its SHA-256,
size, training watermark and parent; the manifest lands LAST and commits
the generation. Blobs, manifests and checksums are byte-compatible with
the JAX package, so each package deploys the other's generations.

Loading a blob unpickles it through :class:`_ModelUnpickler`, which
resolves only an allowlist: the model classes of either package (mapped
to this package's classes, so a generation the JAX package published
deploys here without importing JAX), what numpy arrays need, and plain
builtins. Anything else is refused as an ``UnpicklingError``.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
import io
import json
import logging
import pickle
from typing import Any, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.core.controller import Algorithm, PersistenceMode

logger = logging.getLogger(__name__)

_FORMAT_VERSION = 1

#: generation manifest schema version
GENERATION_VERSION = 1


class ModelIntegrityError(RuntimeError):
    """A published generation failed checksum verification. Carries the
    instance id so callers can quarantine it and fall back."""

    def __init__(self, instance_id: str, reason: str):
        super().__init__(
            f"model generation {instance_id} failed integrity "
            f"verification: {reason}"
        )
        self.instance_id = instance_id
        self.reason = reason


def to_host(tree: Any) -> Any:
    """Every tensor in ``tree`` as a numpy array (bf16 tensors, which
    numpy cannot hold, as float32). Dataclasses, dicts, lists and tuples
    are walked; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree,
            **{
                f.name: to_host(getattr(tree, f.name))
                for f in dataclasses.fields(tree)
                if f.init
            },
        )
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def serialize_models(
    instance_id: str,
    algorithms: Sequence[Algorithm],
    models: Sequence[Any],
) -> bytes:
    """One blob for the whole engine instance (all algorithms)."""
    entries: list[tuple[str, Any]] = []
    for algo, model in zip(algorithms, models):
        mode = algo.persistence_mode
        if mode == PersistenceMode.AUTO:
            entries.append(
                ("auto", to_host(algo.prepare_model_for_host(model)))
            )
        elif mode == PersistenceMode.MANUAL:
            algo.save_model(instance_id, model)
            entries.append(("manifest", type(algo).__qualname__))
        else:
            entries.append(("retrain", None))
    buf = io.BytesIO()
    pickle.dump(
        {"version": _FORMAT_VERSION, "entries": entries},
        buf,
        protocol=pickle.HIGHEST_PROTOCOL,
    )
    return buf.getvalue()


#: (module, name) pickles may name, whichever package wrote them →
#: (module of this package, name) to import instead
_MODEL_CLASSES = {
    "models.recommendation": ("ALSRecModel",),
    "models.similarproduct": ("SimilarModel",),
    "models.ecommerce": ("ECommModel",),
    "models.complementarypurchase": ("CPModel",),
    "models.classification": ("NaiveBayesModel",),
    "models.textclassification": ("TextNBModel",),
    "models.helloworld": ("HelloModel",),
    "models.regression": ("RegressionModel",),
    "models.leadscoring": ("LeadModel",),
    "ops.naive_bayes": ("MultinomialNBModel", "CategoricalNBModel"),
    "ops.markov": ("MarkovChainModel",),
    "utils.bimap": ("BiMap",),
}
_NUMPY_GLOBALS = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
}
_BUILTINS = {
    "dict", "list", "tuple", "set", "frozenset", "bytes", "bytearray",
    "str", "int", "float", "complex", "bool", "slice", "range",
}


#: the JAX package pickles a ``jax.Array`` left inside a model (its
#: ``to_host`` does not walk plain dataclasses) as a call of this
#: function on the numpy array's own pickle state
_JAX_ARRAY = ("jax._src.array", "_reconstruct_array")


def _numpy_from_jax_array(fun, args, arr_state, aval_state):
    """The numpy array a pickled ``jax.Array`` holds. ``fun`` was itself
    resolved through the allowlist (numpy's ``_reconstruct``)."""
    arr = fun(*args)
    if not isinstance(arr, np.ndarray):
        raise pickle.UnpicklingError("a pickled jax.Array holds no array")
    arr.__setstate__(arr_state)
    return arr


class _ModelUnpickler(pickle.Unpickler):
    """The allowlist above, plus ``extra``: ``{(module, name): class}``
    a caller expects (a MANUAL model's own classes)."""

    def __init__(self, file, extra: dict | None = None):
        super().__init__(file)
        self._extra = extra or {}

    def find_class(self, module: str, name: str):
        if (module, name) in self._extra:
            return self._extra[(module, name)]
        if (module, name) == _JAX_ARRAY:
            return _numpy_from_jax_array
        for package in ("predictionio_tpu", "predictionio_tpu_torch"):
            sub = module[len(package) + 1:]
            if (
                module.startswith(package + ".")
                and name in _MODEL_CLASSES.get(sub, ())
            ):
                return super().find_class(
                    f"predictionio_tpu_torch.{sub}", name
                )
        if (module, name) in _NUMPY_GLOBALS or (
            module == "builtins" and name in _BUILTINS
        ):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"model blob names {module}.{name}, which is not an allowed "
            "model class"
        )


def deserialize_models(blob: bytes) -> list[tuple[str, Any]]:
    """→ [(mode_tag, payload)] in algorithm order."""
    payload = _ModelUnpickler(io.BytesIO(blob)).load()
    if not isinstance(payload, dict) or (
        payload.get("version") != _FORMAT_VERSION
    ):
        raise ValueError("unsupported model blob version")
    return payload["entries"]


# --------------------------------------------------------------------------
# Transactional generation publish / verified load
# --------------------------------------------------------------------------


def manifest_id(instance_id: str) -> str:
    """Model-store id of a generation's manifest blob."""
    return f"{instance_id}.manifest"


def sha256_hex(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


def build_manifest(
    instance_id: str,
    artifacts: dict[str, bytes],
    watermark: dict | None = None,
    parent: str | None = None,
) -> dict:
    """Generation manifest: per-artifact SHA-256 + size, the training
    watermark, and the parent generation."""
    return {
        "version": GENERATION_VERSION,
        "instanceId": instance_id,
        "artifacts": [
            {
                "id": art_id,
                "sha256": sha256_hex(blob),
                "bytes": len(blob),
            }
            for art_id, blob in sorted(artifacts.items())
        ],
        "watermark": watermark or {},
        "parent": parent,
        "createdAt": _dt.datetime.now(_dt.timezone.utc).isoformat(),
    }


def publish_generation(
    models_backend,
    instance_id: str,
    blob: bytes,
    watermark: dict | None = None,
    parent: str | None = None,
) -> dict:
    """Write-all-then-commit publish: the blob first (under
    ``instance_id``), then the manifest (under :func:`manifest_id`).
    Returns the manifest dict."""
    from predictionio_tpu_torch.data.storage.base import Model

    manifest = build_manifest(
        instance_id, {instance_id: blob}, watermark=watermark,
        parent=parent,
    )
    models_backend.insert(Model(id=instance_id, models=blob))
    models_backend.insert(
        Model(
            id=manifest_id(instance_id),
            models=json.dumps(manifest, sort_keys=True).encode("utf-8"),
        )
    )
    logger.info(
        "published model generation %s (%d bytes, parent=%s)",
        instance_id, len(blob), parent,
    )
    return manifest


def load_manifest(models_backend, instance_id: str) -> dict | None:
    """The generation's manifest, or None for a pre-manifest publish. A
    malformed manifest is an integrity failure."""
    record = models_backend.get(manifest_id(instance_id))
    if record is None:
        return None
    try:
        manifest = json.loads(record.models.decode("utf-8"))
        if not isinstance(manifest, dict) or "artifacts" not in manifest:
            raise ValueError("manifest is not a generation object")
    except (ValueError, UnicodeDecodeError) as e:
        raise ModelIntegrityError(
            instance_id, f"unreadable manifest: {e}"
        ) from e
    return manifest


def quarantine_generation(models_backend, instance_id: str) -> None:
    """Move a corrupt generation's blob and manifest aside. Best-effort:
    it runs on the failure path and must not mask the integrity error."""
    for art_id in (instance_id, manifest_id(instance_id)):
        try:
            models_backend.quarantine(art_id)
        except Exception as e:  # noqa: BLE001 - failure-path best effort
            logger.warning("could not quarantine %s: %s", art_id, e)


def load_generation(models_backend, instance_id: str) -> bytes:
    """Checksum-verified read of a generation's model blob. A blob with
    no manifest is returned as it is; a manifest whose artifact is
    missing, truncated or checksum-divergent raises
    :class:`ModelIntegrityError`."""
    manifest = load_manifest(models_backend, instance_id)
    record = models_backend.get(instance_id)
    if manifest is None:
        if record is None:
            raise ModelIntegrityError(instance_id, "model blob missing")
        return record.models
    by_id = {a["id"]: a for a in manifest["artifacts"]}
    spec = by_id.get(instance_id)
    if spec is None:
        raise ModelIntegrityError(
            instance_id, "manifest lists no blob for this instance"
        )
    if record is None:
        raise ModelIntegrityError(
            instance_id, "manifest present but model blob missing"
        )
    if len(record.models) != spec["bytes"]:
        raise ModelIntegrityError(
            instance_id,
            f"blob is {len(record.models)} bytes, manifest says "
            f"{spec['bytes']} (truncated or torn write)",
        )
    digest = sha256_hex(record.models)
    if digest != spec["sha256"]:
        raise ModelIntegrityError(
            instance_id,
            f"sha256 {digest[:12]}… != manifest {spec['sha256'][:12]}…",
        )
    return record.models
