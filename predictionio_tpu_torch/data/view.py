"""DataView — cached materialized event views.

Counterpart of ``predictionio_tpu/data/view.py``: the events of an
(app, channel, time range, event names) are materialized once into a
columnar ``.npz`` of :class:`EventFrame` columns (property bags
JSON-encoded per row) under ``PIO_FS_BASEDIR/view``, keyed by a hash of
the query and a caller-supplied version, so repeated trainings and
evaluations over the same slice skip the event-store scan. The key and
the npz layout are the JAX package's, so a view either package writes
is read by the other.

Invalidate by bumping ``version`` or calling :meth:`DataView.clear`.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json
import logging
import os

import numpy as np

from predictionio_tpu_torch.data.eventframe import EventFrame
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.utils.npzio import atomic_savez

logger = logging.getLogger(__name__)

#: bump when the on-disk layout changes (part of the cache key; equal to
#: the JAX package's, so either package reads the other's views)
FORMAT_VERSION = 1


def _base_dir() -> str:
    return os.environ.get(
        "PIO_FS_BASEDIR", os.path.expanduser("~/.piotpu")
    )


def frame_to_npz(frame: EventFrame, path: str) -> None:
    """Persist an EventFrame as a columnar npz (atomic rename)."""
    atomic_savez(
        path,
        event=frame.event,
        entity_type=frame.entity_type,
        entity_id=frame.entity_id,
        target_entity_type=frame.target_entity_type,
        target_entity_id=frame.target_entity_id,
        event_time=frame.event_time,
        properties=np.asarray(
            [json.dumps(p) for p in frame.properties], dtype=np.str_
        ),
    )


def frame_from_npz(path: str) -> EventFrame:
    with np.load(path, allow_pickle=False) as z:
        return EventFrame(
            event=z["event"],
            entity_type=z["entity_type"],
            entity_id=z["entity_id"],
            target_entity_type=z["target_entity_type"],
            target_entity_id=z["target_entity_id"],
            event_time=z["event_time"],
            properties=[json.loads(s) for s in z["properties"]],
        )


class DataView:
    """Cached columnar view over an app's events."""

    def __init__(
        self,
        store: EventStore | None = None,
        base_dir: str | None = None,
    ):
        self._store = store or EventStore()
        self._dir = os.path.join(base_dir or _base_dir(), "view")

    # -- cache key -------------------------------------------------------
    @staticmethod
    def _key(
        app_name: str,
        channel_name: str | None,
        start_time: _dt.datetime | None,
        until_time: _dt.datetime | None,
        event_names,
        version: str,
    ) -> str:
        raw = json.dumps(
            [
                app_name,
                channel_name,
                start_time.isoformat() if start_time else None,
                until_time.isoformat() if until_time else None,
                sorted(event_names) if event_names else None,
                version,
                FORMAT_VERSION,
            ]
        )
        return hashlib.sha1(raw.encode()).hexdigest()[:20]

    def path_for(self, **kwargs) -> str:
        key = self._key(
            kwargs["app_name"],
            kwargs.get("channel_name"),
            kwargs.get("start_time"),
            kwargs.get("until_time"),
            kwargs.get("event_names"),
            kwargs.get("version", ""),
        )
        return os.path.join(self._dir, f"{key}.npz")

    def create(
        self,
        app_name: str,
        channel_name: str | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        event_names=None,
        version: str = "",
        refresh: bool = False,
    ) -> EventFrame:
        """Return the cached view, materializing on first use."""
        path = self.path_for(
            app_name=app_name,
            channel_name=channel_name,
            start_time=start_time,
            until_time=until_time,
            event_names=event_names,
            version=version,
        )
        if not refresh and os.path.exists(path):
            try:
                frame = frame_from_npz(path)
                logger.debug(
                    "view cache hit %s (%d events)", path, len(frame)
                )
                return frame
            except Exception:  # noqa: BLE001 - corrupt cache → rebuild
                logger.warning(
                    "corrupt view cache %s; rebuilding", path
                )
        frame = self._store.frame(
            app_name,
            channel_name=channel_name,
            start_time=start_time,
            until_time=until_time,
            event_names=list(event_names) if event_names else None,
        )
        frame_to_npz(frame, path)
        logger.info(
            "materialized view %s (%d events)", path, len(frame)
        )
        return frame

    def clear(self) -> int:
        """Drop every cached view; returns the number removed."""
        if not os.path.isdir(self._dir):
            return 0
        removed = 0
        for name in os.listdir(self._dir):
            if name.endswith(".npz"):
                try:
                    os.unlink(os.path.join(self._dir, name))
                    removed += 1
                except OSError:
                    pass
        return removed
