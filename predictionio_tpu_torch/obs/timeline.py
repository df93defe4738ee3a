"""Bounded ring of structured lifecycle events — the incident timeline.

Counterpart of ``predictionio_tpu/obs/timeline.py``, copied. The
serving router federates the replicas' rings with
:func:`merge_timelines`.

Metrics answer "how much"; the timeline answers "what happened, in what
order". Control-plane transitions that explain a goodput dip — breaker
opens, canary verdicts, pool evictions and cold-load timeouts,
autoscaler actions, swap phase changes, SLO burn alerts, noisy-neighbor
flags — are appended here as structured events, each stamped with both
clocks (monotonic for local ordering, wall for cross-process merge),
a severity, and whatever correlation IDs the emitter has (request,
tenant, generation). Every server exposes the ring at
``GET /debug/timeline.json``; the router federates the per-replica
rings into one time-ordered fleet narrative with the same stale-replica
semantics as metrics federation, and ``pio-tpu timeline`` renders it.

Stdlib-only like the rest of :mod:`predictionio_tpu_torch.obs`: recording is
a deque append under a private lock (no I/O, no allocation beyond the
event dict), so emitters may call :meth:`Timeline.record` while holding
their own locks (the breaker does).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Iterable

from predictionio_tpu_torch.obs.context import get_request_id

#: severity levels, in escalation order
INFO = "info"
WARN = "warn"
ERROR = "error"

_SEVERITIES = (INFO, WARN, ERROR)

#: default ring capacity; override with PIO_TIMELINE_CAPACITY
DEFAULT_CAPACITY = 512


def _env_capacity() -> int:
    raw = os.environ.get("PIO_TIMELINE_CAPACITY")
    if not raw:
        return DEFAULT_CAPACITY
    try:
        value = int(raw)
    except ValueError:
        return DEFAULT_CAPACITY
    return value if value > 0 else DEFAULT_CAPACITY


class Timeline:
    """Fixed-capacity event ring. Oldest events fall off; ``dropped``
    counts them so a scrape can tell "quiet server" from "ring turned
    over since your last pull"."""

    def __init__(
        self,
        capacity: int | None = None,
        *,
        registry=None,
    ):
        self._capacity = capacity or _env_capacity()
        self._events: collections.deque = collections.deque(
            maxlen=self._capacity
        )
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped = 0
        self._events_total = None
        if registry is not None:
            self._events_total = registry.counter(
                "pio_timeline_events_total",
                "lifecycle events recorded into the incident timeline",
                ("kind",),
            )

    def record(
        self,
        kind: str,
        message: str,
        *,
        severity: str = INFO,
        tenant: str = "",
        generation: int | None = None,
        request_id: str | None = None,
        **fields,
    ) -> dict:
        """Append one event. ``kind`` is a stable machine token (e.g.
        ``breaker_transition``); ``message`` is the human line the CLI
        renders. Extra keyword fields ride along verbatim (they must be
        JSON-serializable). The request ID is auto-captured from the
        ambient context when the emitter doesn't pass one — it doubles
        as the trace ID, so a timeline line correlates with a span."""
        if severity not in _SEVERITIES:
            severity = INFO
        if request_id is None:
            request_id = get_request_id()
        # wall stamp is for cross-process merge ordering + display;
        # all LOCAL ordering uses the monotonic stamp and the sequence
        wall = time.time()
        event = {
            "kind": kind,
            "message": message,
            "severity": severity,
            "mono": time.monotonic(),
            "wall": wall,
        }
        if tenant:
            event["tenant"] = tenant
        if generation is not None:
            event["generation"] = generation
        if request_id:
            event["requestId"] = request_id
        if fields:
            event.update(fields)
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            if len(self._events) == self._capacity:
                self._dropped += 1
            self._events.append(event)
        if self._events_total is not None:
            self._events_total.labels(kind).inc()
        return event

    def events(self) -> list[dict]:
        """Snapshot, oldest first (already ordered: single appender
        lock + monotonically increasing ``seq``)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def to_dict(self) -> dict:
        """The ``/debug/timeline.json`` payload for one process."""
        with self._lock:
            events = [dict(e) for e in self._events]
            dropped = self._dropped
        return {
            "capacity": self._capacity,
            "dropped": dropped,
            "events": events,
        }

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0


def merge_timelines(
    payloads: Iterable[tuple[str, dict | None]],
    *,
    limit: int | None = None,
) -> dict:
    """Merge per-replica ``/debug/timeline.json`` payloads into one
    fleet narrative, time-ordered by the wall stamp (monotonic clocks
    are not comparable across processes; within one replica the
    ``seq`` tie-breaks events recorded in the same wall tick).

    ``payloads`` is ``(replica_id, payload)`` pairs — a ``None``
    payload (replica never scraped) contributes nothing, as metrics
    federation does, where a stale replica's LAST snapshot still
    contributes. Each merged event
    is annotated with its ``replica``. ``limit`` keeps only the newest
    N events after the merge.
    """
    merged: list[dict] = []
    replicas: list[str] = []
    dropped = 0
    for replica_id, payload in payloads:
        if not payload:
            continue
        replicas.append(replica_id)
        dropped += int(payload.get("dropped", 0) or 0)
        for event in payload.get("events", ()):
            if not isinstance(event, dict):
                continue
            annotated = dict(event)
            annotated["replica"] = replica_id
            merged.append(annotated)
    merged.sort(
        key=lambda e: (
            float(e.get("wall", 0.0) or 0.0),
            str(e.get("replica", "")),
            int(e.get("seq", 0) or 0),
        )
    )
    if limit is not None and limit >= 0 and len(merged) > limit:
        dropped += len(merged) - limit
        merged = merged[-limit:]
    return {
        "replicas": sorted(replicas),
        "dropped": dropped,
        "events": merged,
    }


_global_lock = threading.Lock()
_global_timeline: Timeline | None = None


def get_timeline() -> Timeline:
    """Process-global ring, for emitters with no registry/timeline
    threaded through (the breaker transitions inside ``resilience``).
    Servers pass their own :class:`Timeline` where construction allows
    it; both end up in the same ring when the server uses this one."""
    global _global_timeline
    with _global_lock:
        if _global_timeline is None:
            _global_timeline = Timeline()
        return _global_timeline


def set_timeline(timeline: Timeline | None) -> Timeline | None:
    """Swap the process-global ring (a server installs its own so
    breaker events land beside its canary/pool events; tests isolate).
    Returns the previous ring."""
    global _global_timeline
    with _global_lock:
        previous = _global_timeline
        _global_timeline = timeline
        return previous
