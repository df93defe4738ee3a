"""Engine-facing event reads, addressed by app name.

Counterpart of ``EventStore`` in ``predictionio_tpu/data/store.py``:
bulk training-time reads (``find``, ``frame``, ``interactions``), entity
property aggregation (``aggregate_properties``, ``extract_entity_map``)
and the latest-first serve-time scan ``find_by_entity``, with app and
channel names resolved to ids through the metadata store.
"""

from __future__ import annotations

import datetime as _dt
from typing import Iterator, Sequence

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.eventframe import EventFrame, Interactions
from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.utils.bimap import EntityMap


class EventStoreError(RuntimeError):
    pass


class EventStore:
    """App-name-addressed event reads over the configured storage."""

    def __init__(self, storage: Storage | None = None):
        self._storage = storage or get_storage()

    def _resolve(
        self, app_name: str, channel_name: str | None
    ) -> tuple[int, int | None]:
        app = self._storage.get_meta_data_apps().get_by_name(app_name)
        if app is None:
            raise EventStoreError(
                f"Invalid app name {app_name!r}: app does not exist."
            )
        if channel_name is None:
            return app.id, None
        channels = self._storage.get_meta_data_channels().get_by_app_id(
            app.id
        )
        for ch in channels:
            if ch.name == channel_name:
                return app.id, ch.id
        raise EventStoreError(
            f"Invalid channel name {channel_name!r} for app {app_name!r}."
        )

    # -- bulk (training-time) ---------------------------------------------
    def find(
        self,
        app_name: str,
        channel_name: str | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
    ) -> Iterator[Event]:
        app_id, channel_id = self._resolve(app_name, channel_name)
        return self._storage.get_events().find(
            app_id,
            channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
        )

    def frame(self, app_name: str, **kwargs) -> EventFrame:
        """Bulk columnar read."""
        return EventFrame.from_events(self.find(app_name, **kwargs))

    def interactions(
        self,
        app_name: str,
        channel_name: str | None = None,
        event_names: Sequence[str] | None = None,
        value_key: str | None = None,
        default_value: float = 1.0,
    ) -> Interactions:
        """Dense COO interactions for training reads.

        Dispatches to the backend's native columnar scan when it has one
        (the event log scans straight to dense-id arrays); otherwise
        goes through the ``EventFrame`` conversion.
        """
        app_id, channel_id = self._resolve(app_name, channel_name)
        backend = self._storage.get_events()
        if hasattr(backend, "interactions"):
            return backend.interactions(
                app_id,
                channel_id,
                event_names=event_names,
                value_key=value_key,
                default_value=default_value,
            )
        frame = self.frame(
            app_name, channel_name=channel_name, event_names=event_names
        )
        return frame.to_interactions(
            value_key=value_key, default_value=default_value
        )

    def aggregate_properties(
        self,
        app_name: str,
        entity_type: str,
        channel_name: str | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, PropertyMap]:
        """``{entity_id: PropertyMap}`` folded from the entity type's
        ``$set/$unset/$delete`` events."""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return self._storage.get_events().aggregate_properties(
            app_id,
            channel_id,
            entity_type=entity_type,
            start_time=start_time,
            until_time=until_time,
            required=required,
        )

    def extract_entity_map(
        self,
        app_name: str,
        entity_type: str,
        channel_name: str | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> EntityMap:
        """The aggregated properties as an :class:`EntityMap`: string id
        ↔ dense index ↔ PropertyMap."""
        return EntityMap(self.aggregate_properties(
            app_name,
            entity_type,
            channel_name=channel_name,
            start_time=start_time,
            until_time=until_time,
            required=required,
        ))

    # -- serve-time -------------------------------------------------------
    def find_by_entity(
        self,
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        limit: int | None = None,
        latest: bool = True,
    ) -> list[Event]:
        """Latest-first entity scan for predict-time business rules."""
        app_id, channel_id = self._resolve(app_name, channel_name)
        return list(
            self._storage.get_events().find(
                app_id,
                channel_id,
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                limit=limit,
                reversed=latest,
            )
        )
