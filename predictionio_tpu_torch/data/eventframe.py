"""EventFrame — columnar event batches, the RDD[Event] replacement.

A copy of ``predictionio_tpu/data/eventframe.py`` (the port keeps its
own); the dense COO it produces is what ``ops/als.py`` packs.

In the reference, bulk event access returns ``RDD[Event]``
(``PEvents.find``, data/.../storage/PEvents.scala:35-80) and every
downstream template immediately re-shapes it into dense-id arrays (BiMap +
``map``). Here the columnar form *is* the bulk type: string columns live
host-side as numpy arrays, and :meth:`EventFrame.to_interactions` produces
the dense COO (row_idx, col_idx, value) arrays that get padded and staged
onto the device mesh. This is the fixed-shape boundary SURVEY.md §7
hard-part (a) calls for.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable
from typing import Any

import numpy as np

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.utils.bimap import BiMap


@dataclasses.dataclass
class EventFrame:
    """Column-oriented batch of events (host memory)."""

    event: np.ndarray          # unicode
    entity_type: np.ndarray    # unicode
    entity_id: np.ndarray      # unicode
    target_entity_type: np.ndarray  # unicode, "" = absent
    target_entity_id: np.ndarray    # unicode, "" = absent
    event_time: np.ndarray     # float64 epoch seconds (UTC)
    properties: list[dict[str, Any]]  # per-row property bags

    @staticmethod
    def from_events(events: Iterable[Event]) -> "EventFrame":
        ev, ety, eid, tty, tid, t, props = [], [], [], [], [], [], []
        for e in events:
            ev.append(e.event)
            ety.append(e.entity_type)
            eid.append(e.entity_id)
            tty.append(e.target_entity_type or "")
            tid.append(e.target_entity_id or "")
            t.append(e.event_time.timestamp())
            props.append(e.properties.to_dict())
        return EventFrame(
            event=np.asarray(ev, dtype=np.str_),
            entity_type=np.asarray(ety, dtype=np.str_),
            entity_id=np.asarray(eid, dtype=np.str_),
            target_entity_type=np.asarray(tty, dtype=np.str_),
            target_entity_id=np.asarray(tid, dtype=np.str_),
            event_time=np.asarray(t, dtype=np.float64),
            properties=props,
        )

    def __len__(self) -> int:
        return len(self.event)

    def filter_events(self, names: Iterable[str]) -> "EventFrame":
        mask = np.isin(self.event, list(names))
        return self._mask(mask)

    def _mask(self, mask: np.ndarray) -> "EventFrame":
        return EventFrame(
            event=self.event[mask],
            entity_type=self.entity_type[mask],
            entity_id=self.entity_id[mask],
            target_entity_type=self.target_entity_type[mask],
            target_entity_id=self.target_entity_id[mask],
            event_time=self.event_time[mask],
            properties=[p for p, m in zip(self.properties, mask) if m],
        )

    def property_column(
        self, key: str, default: float = 1.0
    ) -> np.ndarray:
        """Extract one numeric property across rows (e.g. ``rating``)."""
        return np.asarray(
            [float(p.get(key, default)) for p in self.properties],
            dtype=np.float32,
        )

    def to_interactions(
        self,
        value_key: str | None = None,
        default_value: float = 1.0,
        entity_map: BiMap | None = None,
        target_map: BiMap | None = None,
    ) -> "Interactions":
        """Dense COO interactions: (entity row, target col, value).

        When maps are supplied (e.g. from a previous fold / serving-time
        vocabulary), unknown ids are dropped; otherwise maps are built
        from this frame in one vectorized pass. Rows without a target
        entity ("" sentinel, e.g. $set property events) are dropped.
        """
        if len(self) and (self.target_entity_id == "").any():
            return self._mask(self.target_entity_id != "").to_interactions(
                value_key=value_key,
                default_value=default_value,
                entity_map=entity_map,
                target_map=target_map,
            )
        if entity_map is None:
            entity_map, rows = BiMap.string_int_with_codes(self.entity_id)
            row_ok = np.ones(len(rows), dtype=bool)
        else:
            rows = entity_map.encode(self.entity_id)
            row_ok = rows >= 0
        if target_map is None:
            target_map, cols = BiMap.string_int_with_codes(
                self.target_entity_id
            )
            col_ok = np.ones(len(cols), dtype=bool)
        else:
            cols = target_map.encode(self.target_entity_id)
            col_ok = cols >= 0
        values = (
            self.property_column(value_key, default_value)
            if value_key is not None
            else np.full(len(self), default_value, dtype=np.float32)
        )
        ok = row_ok & col_ok
        return Interactions(
            entity_map=entity_map,
            target_map=target_map,
            rows=rows[ok].astype(np.int32),
            cols=cols[ok].astype(np.int32),
            values=values[ok],
            times=self.event_time[ok],
        )


@dataclasses.dataclass
class Interactions:
    """COO interaction matrix + the id vocabularies that index it."""

    entity_map: BiMap
    target_map: BiMap
    rows: np.ndarray    # int32 [nnz]
    cols: np.ndarray    # int32 [nnz]
    values: np.ndarray  # float32 [nnz]
    times: np.ndarray   # float64 [nnz]

    @property
    def n_rows(self) -> int:
        return len(self.entity_map)

    @property
    def n_cols(self) -> int:
        return len(self.target_map)

    @property
    def nnz(self) -> int:
        return len(self.rows)

    def dedupe_sum(self) -> "Interactions":
        """Sum duplicate (row, col) pairs — MLlib ALS's implicit-feedback
        convention of aggregating repeated events."""
        key = self.rows.astype(np.int64) * max(self.n_cols, 1) + self.cols
        uniq, inverse = np.unique(key, return_inverse=True)
        values = np.zeros(len(uniq), dtype=np.float32)
        np.add.at(values, inverse, self.values)
        times = np.zeros(len(uniq), dtype=np.float64)
        np.maximum.at(times, inverse, self.times)
        return Interactions(
            entity_map=self.entity_map,
            target_map=self.target_map,
            rows=(uniq // max(self.n_cols, 1)).astype(np.int32),
            cols=(uniq % max(self.n_cols, 1)).astype(np.int32),
            values=values,
            times=times,
        )

    def dedupe_latest(self) -> "Interactions":
        """Keep the latest event per (row, col) — the rating-data
        convention (reference recommendation DataSource keeps latest rate)."""
        key = self.rows.astype(np.int64) * max(self.n_cols, 1) + self.cols
        order = np.lexsort((self.times, key))
        key_sorted = key[order]
        last = np.r_[key_sorted[1:] != key_sorted[:-1], True]
        keep = order[last]
        return Interactions(
            entity_map=self.entity_map,
            target_map=self.target_map,
            rows=self.rows[keep],
            cols=self.cols[keep],
            values=self.values[keep],
            times=self.times[keep],
        )
