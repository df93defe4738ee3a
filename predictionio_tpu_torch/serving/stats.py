"""Event-server counters by hour, behind ``GET /stats.json``.

Counterpart of ``predictionio_tpu/serving/stats.py``: per app, counts of
response statuses, event names and entity types, bucketed by UTC hour,
kept when the event server runs with ``stats=True``.
"""

from __future__ import annotations

import datetime as _dt
import threading
from collections import Counter

from predictionio_tpu_torch.data.event import Event


def _now() -> _dt.datetime:
    """Module-level so tests can pin the clock (hour-bucket rollover)."""
    return _dt.datetime.now(_dt.timezone.utc)


def _hour_bucket(t: _dt.datetime) -> str:
    return t.astimezone(_dt.timezone.utc).strftime("%Y-%m-%dT%H:00:00Z")


class Stats:
    def __init__(self):
        self._lock = threading.Lock()
        # (bucket, appid) → Counter per dimension
        self._status: dict[tuple[str, int], Counter] = {}
        self._events: dict[tuple[str, int], Counter] = {}
        self._entity_types: dict[tuple[str, int], Counter] = {}
        self.start_time = _now()

    def update(
        self, app_id: int, status: int, event: Event | None = None
    ) -> None:
        bucket = _hour_bucket(_now())
        key = (bucket, app_id)
        with self._lock:
            self._status.setdefault(key, Counter())[str(status)] += 1
            if event is not None:
                self._events.setdefault(key, Counter())[event.event] += 1
                self._entity_types.setdefault(key, Counter())[
                    event.entity_type
                ] += 1

    def snapshot(self, app_id: int) -> dict:
        with self._lock:
            def collect(table):
                out: Counter = Counter()
                for (_bucket, aid), counter in table.items():
                    if aid == app_id:
                        out.update(counter)
                return dict(out)

            return {
                "startTime": self.start_time.isoformat(),
                "statusCount": collect(self._status),
                "eventCount": collect(self._events),
                "entityTypeCount": collect(self._entity_types),
            }
