"""``$set / $unset / $delete`` property aggregation.

A copy of ``predictionio_tpu/data/aggregation.py``. The fold is a
commutative, associative monoid, so events may be folded in any
grouping and order.

Semantics (last write wins per key, by event time):

* ``$set``    — upsert each property key with the event's time as its version.
* ``$unset``  — remove a key iff the unset time is >= the key's set time.
* ``$delete`` — drop every key whose set time is <= the delete time; if the
  delete time also covers the *latest* ``$set`` event, the entity has no
  property map at all (it is excluded from the aggregate).

An entity that never saw a ``$set`` yields no PropertyMap (even if it saw
``$unset``/``$delete``).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from collections.abc import Iterable
from typing import Any

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import SPECIAL_EVENTS, Event


@dataclasses.dataclass(frozen=True)
class _PropTime:
    """A property value versioned by event time."""

    value: Any
    t: _dt.datetime

    def combine(self, other: "_PropTime") -> "_PropTime":
        # a tie goes to ``other``: for same-time $set events the
        # later-combined operand wins
        return self if self.t > other.t else other


@dataclasses.dataclass(frozen=True)
class _SetProp:
    fields: dict[str, _PropTime]
    t: _dt.datetime  # time of the latest $set event

    def combine(self, other: "_SetProp") -> "_SetProp":
        fields = dict(self.fields)
        for k, pt in other.fields.items():
            fields[k] = fields[k].combine(pt) if k in fields else pt
        return _SetProp(fields=fields, t=max(self.t, other.t))


@dataclasses.dataclass(frozen=True)
class _UnsetProp:
    fields: dict[str, _dt.datetime]

    def combine(self, other: "_UnsetProp") -> "_UnsetProp":
        fields = dict(self.fields)
        for k, t in other.fields.items():
            fields[k] = max(fields[k], t) if k in fields else t
        return _UnsetProp(fields=fields)


def _opt_combine(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a.combine(b)


@dataclasses.dataclass(frozen=True)
class EventOp:
    """Monoid element folding special events into a property state.

    ``combine`` is associative and commutative (modulo equal-timestamp
    ties), so events may be folded in any grouping and order.
    """

    set_prop: _SetProp | None = None
    unset_prop: _UnsetProp | None = None
    delete_t: _dt.datetime | None = None
    first_updated: _dt.datetime | None = None
    last_updated: _dt.datetime | None = None

    @staticmethod
    def identity() -> "EventOp":
        return EventOp()

    @staticmethod
    def from_event(e: Event) -> "EventOp":
        t = e.event_time
        if e.event == "$set":
            return EventOp(
                set_prop=_SetProp(
                    fields={
                        k: _PropTime(v, t) for k, v in e.properties.items()
                    },
                    t=t,
                ),
                first_updated=t,
                last_updated=t,
            )
        if e.event == "$unset":
            return EventOp(
                unset_prop=_UnsetProp(
                    fields={k: t for k in e.properties}
                ),
                first_updated=t,
                last_updated=t,
            )
        if e.event == "$delete":
            return EventOp(delete_t=t, first_updated=t, last_updated=t)
        raise ValueError(f"not a special event: {e.event}")

    def combine(self, other: "EventOp") -> "EventOp":
        firsts = [
            t for t in (self.first_updated, other.first_updated) if t is not None
        ]
        lasts = [
            t for t in (self.last_updated, other.last_updated) if t is not None
        ]
        delete_t = None
        if self.delete_t is not None or other.delete_t is not None:
            delete_t = max(
                (t for t in (self.delete_t, other.delete_t) if t is not None)
            )
        return EventOp(
            set_prop=_opt_combine(self.set_prop, other.set_prop),
            unset_prop=_opt_combine(self.unset_prop, other.unset_prop),
            delete_t=delete_t,
            first_updated=min(firsts) if firsts else None,
            last_updated=max(lasts) if lasts else None,
        )

    def to_property_map(self) -> PropertyMap | None:
        """Materialize the state; None = no entity."""
        if self.set_prop is None:
            return None
        set_prop = self.set_prop
        fields = set_prop.fields

        unset_keys = set()
        if self.unset_prop is not None:
            unset_keys = {
                k
                for k, unset_t in self.unset_prop.fields.items()
                if k in fields and unset_t >= fields[k].t
            }

        if self.delete_t is not None:
            if self.delete_t >= set_prop.t:
                return None  # delete covers the latest $set: entity is gone
            delete_keys = {
                k for k, pt in fields.items() if self.delete_t >= pt.t
            }
        else:
            delete_keys = set()

        assert self.first_updated is not None and self.last_updated is not None
        return PropertyMap(
            {
                k: pt.value
                for k, pt in fields.items()
                if k not in unset_keys and k not in delete_keys
            },
            first_updated=self.first_updated,
            last_updated=self.last_updated,
        )


def aggregate_properties(
    events: Iterable[Event],
) -> dict[str, PropertyMap]:
    """Fold special events → ``{entity_id: PropertyMap}``.

    For a single entity type (callers pre-filter by entity type; see
    :meth:`predictionio_tpu_torch.data.store.EventStore.aggregate_properties`).
    Non-special events are ignored.
    """
    ops: dict[str, EventOp] = {}
    for e in events:
        if e.event not in SPECIAL_EVENTS:
            continue
        op = EventOp.from_event(e)
        prev = ops.get(e.entity_id)
        ops[e.entity_id] = prev.combine(op) if prev is not None else op
    out: dict[str, PropertyMap] = {}
    for entity_id, op in ops.items():
        pm = op.to_property_map()
        if pm is not None:
            out[entity_id] = pm
    return out
