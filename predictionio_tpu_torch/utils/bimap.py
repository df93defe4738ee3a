"""BiMap — immutable bidirectional string↔dense-index mapping.

A copy of ``predictionio_tpu/utils/bimap.py``: the port imports nothing
of the JAX package, so it keeps its own. Pickled maps of either package
load as this class (``core/persistence.py``).

Capability parity with the reference's ``data/.../storage/BiMap.scala:25-163``
(``BiMap.stringInt/stringLong``), the primitive every ALS template uses to
turn string entity ids into dense matrix row indices.

TPU-first difference: the reference builds the map with
``RDD[String].distinct.collect`` (BiMap.scala:116-135), which SURVEY.md §7
flags as unscalable. Here construction is vectorized host-side via
``np.unique(return_inverse=True)`` — one C-speed pass that yields both the
vocabulary and the dense codes, which is what actually gets shipped to the
device mesh.
"""

from __future__ import annotations

from collections.abc import Iterable, Sequence

import numpy as np


class BiMap:
    """Immutable bijection ``str -> int`` with O(1) inverse lookup."""

    def __init__(self, keys: Sequence[str] | np.ndarray):
        self._keys = np.asarray(keys)
        if len(np.unique(self._keys)) != len(self._keys):
            raise ValueError("BiMap keys must be unique")
        self._index: dict[str, int] = {
            str(k): i for i, k in enumerate(self._keys)
        }
        # Sorted view for vectorized encode() regardless of key order.
        self._order = np.argsort(self._keys)
        self._sorted_keys = self._keys[self._order]

    # -- construction -----------------------------------------------------
    @staticmethod
    def string_int(values: Iterable[str] | np.ndarray) -> "BiMap":
        """Distinct values → dense [0, n) codes (reference stringInt)."""
        arr = np.asarray(list(values) if not isinstance(values, np.ndarray) else values)
        uniq = np.unique(arr)
        return BiMap(uniq)

    @staticmethod
    def string_int_with_codes(
        values: np.ndarray,
    ) -> tuple["BiMap", np.ndarray]:
        """One-pass build + encode: returns (bimap, int32 codes)."""
        uniq, inverse = np.unique(values, return_inverse=True)
        return BiMap(uniq), inverse.astype(np.int32)

    # -- lookup -----------------------------------------------------------
    def __call__(self, key: str) -> int:
        return self._index[str(key)]

    def get(self, key: str, default: int | None = None) -> int | None:
        return self._index.get(str(key), default)

    def inverse(self, idx: int) -> str:
        return str(self._keys[idx])

    def encode(self, values: np.ndarray, missing: int = -1) -> np.ndarray:
        """Vectorized str→int; unknown keys map to ``missing``."""
        arr = np.asarray(values)
        if len(self._sorted_keys) == 0:
            return np.full(arr.shape, missing, dtype=np.int32)
        pos = np.searchsorted(self._sorted_keys, arr)
        pos = np.clip(pos, 0, len(self._sorted_keys) - 1)
        ok = self._sorted_keys[pos] == arr
        out = np.where(ok, self._order[pos], missing).astype(np.int32)
        return out

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return self._keys[np.asarray(codes)]

    def keys(self) -> np.ndarray:
        return self._keys

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, key: object) -> bool:
        return str(key) in self._index

    def to_dict(self) -> dict[str, int]:
        return dict(self._index)


class EntityMap:
    """String entity id ↔ dense index ↔ payload.

    Capability parity with the reference's experimental
    ``data/.../storage/EntityMap.scala`` (``EntityIdIxMap`` +
    ``EntityMap[A]``): a :class:`BiMap` over the entity ids plus a data
    payload per entity, so engines can move between the string-id world
    (events, queries) and the dense-index world (device arrays) without
    bookkeeping.
    """

    def __init__(self, id_to_data: dict[str, object]):
        self._data = dict(id_to_data)
        self.id_to_ix = BiMap(np.asarray(sorted(self._data)))

    # -- EntityIdIxMap surface --------------------------------------------
    def index(self, entity_id: str) -> int:
        return self.id_to_ix(entity_id)

    def entity_id(self, ix: int) -> str:
        return self.id_to_ix.inverse(ix)

    def get(self, entity_id: str, default: int | None = None) -> int | None:
        return self.id_to_ix.get(entity_id, default)

    def __contains__(self, entity_id: object) -> bool:
        return entity_id in self.id_to_ix

    def __len__(self) -> int:
        return len(self._data)

    # -- EntityMap[A] surface ---------------------------------------------
    def data(self, key: str | int) -> object:
        """Payload by entity id (str) or dense index (int)."""
        if isinstance(key, (int, np.integer)):
            key = self.entity_id(int(key))
        return self._data[str(key)]

    def get_data(self, entity_id: str) -> object | None:
        return self._data.get(str(entity_id))

    def take(self, n: int) -> "EntityMap":
        keep = [self.entity_id(i) for i in range(min(n, len(self)))]
        return EntityMap({k: self._data[k] for k in keep})

    def to_dict(self) -> dict[str, object]:
        return dict(self._data)
