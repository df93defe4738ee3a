"""DataMap / PropertyMap — typed JSON property bags.

A copy of ``predictionio_tpu/data/datamap.py``: the port imports nothing
of the JAX package, so it keeps its own.

Capability parity with the reference's ``data/.../storage/DataMap.scala:41-241``
and ``PropertyMap.scala:33-96``: a thin immutable wrapper over a
``dict[str, Any]`` (JSON-decoded values) with typed accessors, merge /
remove operators, and a PropertyMap variant that carries first/last update
times produced by event aggregation.
"""

from __future__ import annotations

import datetime as _dt
from collections.abc import Iterator, Mapping
from typing import Any, TypeVar

T = TypeVar("T")


class DataMapError(KeyError):
    """Raised when a required field is absent or has the wrong shape."""


class DataMap(Mapping[str, Any]):
    """Immutable JSON property bag with typed access.

    Values are plain JSON-decoded Python objects (str/int/float/bool/list/
    dict/None). Mirrors ``DataMap.get[T]/getOpt/getOrElse/++/--``
    (reference DataMap.scala:64-133).
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Mapping[str, Any] | None = None):
        self._fields: dict[str, Any] = dict(fields or {})

    # -- Mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    # -- typed accessors --------------------------------------------------
    def require(self, name: str) -> None:
        if name not in self._fields:
            raise DataMapError(f"The field {name} is required.")

    def get(self, name: str, default: Any = None) -> Any:  # type: ignore[override]
        """``getOrElse`` when *default* given; plain lookup otherwise."""
        return self._fields.get(name, default)

    def get_required(self, name: str) -> Any:
        """Reference ``get[T]`` — raise if absent or null (DataMap.scala:76-87)."""
        self.require(name)
        value = self._fields[name]
        if value is None:
            raise DataMapError(f"The required field {name} cannot be null.")
        return value

    def get_opt(self, name: str) -> Any | None:
        return self._fields.get(name)

    def get_str(self, name: str) -> str:
        return str(self.get_required(name))

    def get_float(self, name: str) -> float:
        return float(self.get_required(name))

    def get_int(self, name: str) -> int:
        return int(self.get_required(name))

    def get_list(self, name: str) -> list[Any]:
        value = self.get_required(name)
        if not isinstance(value, list):
            raise DataMapError(f"The field {name} is not a list.")
        return value

    def get_str_list(self, name: str) -> list[str]:
        return [str(v) for v in self.get_list(name)]

    def get_float_list(self, name: str) -> list[float]:
        return [float(v) for v in self.get_list(name)]

    # -- operators --------------------------------------------------------
    def merged_with(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """``++`` — right-biased merge (DataMap.scala:124)."""
        out = dict(self._fields)
        out.update(dict(other))
        return DataMap(out)

    def without(self, keys: Any) -> "DataMap":
        """``--`` — remove keys (DataMap.scala:129)."""
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    def to_dict(self) -> dict[str, Any]:
        return dict(self._fields)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:  # stable enough for small property bags
        return hash(tuple(sorted((k, repr(v)) for k, v in self._fields.items())))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"


class PropertyMap(DataMap):
    """DataMap + aggregation timestamps (reference PropertyMap.scala:33-57).

    Produced by folding ``$set/$unset/$delete`` events; carries when the
    entity's properties were first and most recently updated.
    """

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Mapping[str, Any] | None,
        first_updated: _dt.datetime,
        last_updated: _dt.datetime,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self.to_dict()!r}, first_updated={self.first_updated}, "
            f"last_updated={self.last_updated})"
        )
