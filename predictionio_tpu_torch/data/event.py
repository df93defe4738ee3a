"""Event model + validation.

A copy of ``predictionio_tpu/data/event.py`` (the port keeps its own).

Capability parity with the reference ``data/.../storage/Event.scala:39-164``:
an immutable behavioral event with entity / optional target-entity
coordinates, a property bag, event time, tags, and an optional ``prId``
linking a ``predict`` feedback event to the prediction that caused it.

Validation rules mirror ``EventValidation`` (Event.scala:109-164):

* names starting with ``$`` are reserved; only the special events
  ``$set / $unset / $delete`` are accepted;
* ``pio_``-prefixed event names, entity types, target entity types and
  property keys are reserved (except built-ins, e.g. entity type
  ``pio_pr`` used by the prediction-feedback loop);
* special events must not carry a target entity; ``$unset`` must carry a
  non-empty property bag.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import uuid
from typing import Any, Mapping

from predictionio_tpu_torch.data.datamap import DataMap

SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})
#: Built-in entity types exempt from the ``pio_`` reservation
#: (reference Event.scala:158-164 — ``pio_pr`` backs the feedback loop).
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})
DEFAULT_ENTITY_ID = ""


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


class EventValidationError(ValueError):
    """Raised for events violating the reserved-name / shape rules."""


@dataclasses.dataclass(frozen=True)
class Event:
    """One behavioral event (reference Event.scala:39-75)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: str | None = None
    target_entity_id: str | None = None
    properties: DataMap = dataclasses.field(default_factory=DataMap)
    event_time: _dt.datetime = dataclasses.field(default_factory=_utcnow)
    tags: tuple[str, ...] = ()
    pr_id: str | None = None
    event_id: str | None = None
    creation_time: _dt.datetime = dataclasses.field(default_factory=_utcnow)

    def __post_init__(self) -> None:
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(self.properties))
        for name in ("event_time", "creation_time"):
            t = getattr(self, name)
            if t.tzinfo is None:  # naive timestamps are taken as UTC
                object.__setattr__(
                    self, name, t.replace(tzinfo=_dt.timezone.utc)
                )
        validate_event(self)

    def with_id(self, event_id: str | None = None) -> "Event":
        """Return a copy carrying a concrete event id (UUID4 by default)."""
        return dataclasses.replace(
            self, event_id=event_id or uuid.uuid4().hex
        )

    # -- JSON (API shape; reference EventJson4sSupport.APISerializer) -----
    def to_json_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "properties": self.properties.to_dict(),
            "eventTime": self.event_time.isoformat(),
            "creationTime": self.creation_time.isoformat(),
        }
        if self.event_id is not None:
            d["eventId"] = self.event_id
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = self.target_entity_id
        if self.tags:
            d["tags"] = list(self.tags)
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        return d

    @staticmethod
    def from_json_dict(d: Mapping[str, Any]) -> "Event":
        """Parse the API JSON shape (reference EventJson4sSupport.scala:35-118)."""
        try:
            event = d["event"]
            entity_type = d["entityType"]
            entity_id = d["entityId"]
        except KeyError as e:
            raise EventValidationError(f"field {e.args[0]} is required") from e

        def _time(key: str) -> _dt.datetime:
            raw = d.get(key)
            if raw is None or raw == "":
                return _utcnow()
            try:
                t = _dt.datetime.fromisoformat(
                    str(raw).replace("Z", "+00:00")
                )
            except ValueError as e:
                raise EventValidationError(
                    f"{key} {raw!r} is not an ISO-8601 time: {e}"
                ) from e
            return t if t.tzinfo else t.replace(tzinfo=_dt.timezone.utc)

        return Event(
            event=str(event),
            entity_type=str(entity_type),
            entity_id=str(entity_id),
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=d.get("targetEntityId"),
            properties=DataMap(d.get("properties") or {}),
            event_time=_time("eventTime"),
            tags=tuple(d.get("tags") or ()),
            pr_id=d.get("prId"),
            event_id=d.get("eventId"),
            creation_time=_time("creationTime"),
        )


def validate_event(e: Event) -> None:
    """Enforce the reference's event rules (Event.scala:109-164)."""
    if not e.event:
        raise EventValidationError("event must not be empty.")
    if not e.entity_type:
        raise EventValidationError("entityType must not be empty string.")
    if not e.entity_id:
        raise EventValidationError("entityId must not be empty string.")
    if e.target_entity_type is not None and not e.target_entity_type:
        raise EventValidationError(
            "targetEntityType must not be empty string."
        )
    if e.target_entity_id is not None and not e.target_entity_id:
        raise EventValidationError("targetEntityId must not be empty string.")
    if (e.target_entity_type is None) != (e.target_entity_id is None):
        raise EventValidationError(
            "targetEntityType and targetEntityId must be specified together."
        )

    # Reserved prefixes (Event.scala:120-141)
    if e.event.startswith("$") and e.event not in SPECIAL_EVENTS:
        raise EventValidationError(
            f"{e.event} is not a supported reserved event name."
        )
    if e.event.startswith("pio_"):
        raise EventValidationError(
            f"{e.event} is not a supported reserved event name."
        )
    for who, etype in (
        ("entityType", e.entity_type),
        ("targetEntityType", e.target_entity_type),
    ):
        if (
            etype is not None
            and etype.startswith("pio_")
            and etype not in BUILTIN_ENTITY_TYPES
        ):
            raise EventValidationError(
                f"{etype} is not a supported reserved {who}."
            )
    for key in e.properties:
        if key.startswith("pio_"):
            raise EventValidationError(
                f"{key} is not a supported reserved property key."
            )

    # Special-event shape rules (Event.scala:143-156)
    if e.event in SPECIAL_EVENTS:
        if e.target_entity_type is not None or e.target_entity_id is not None:
            raise EventValidationError(
                f"special event {e.event} must not have targetEntity."
            )
        if e.event == "$unset" and len(e.properties) == 0:
            raise EventValidationError(
                "$unset event must have non-empty properties."
            )
