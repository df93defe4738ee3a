"""Span-based distributed tracing with a Perfetto-exportable flight
recorder.

Counterpart of ``predictionio_tpu/obs/tracing.py``, copied: the same
span trees, ring and flight recorder, ``X-Parent-Span`` propagation and
Chrome trace-event export.

The metrics answer *how much* and *how often*; this module answers
*why was this one request slow*: every request gets a span tree — root
HTTP span, storage-call spans, a batch-dispatch span linked to every
query it coalesced — keyed by trace ID = request ID, so the timeline a
TensorFlow-serving or Podracer operator reads off a step trace exists
here natively, without a device profiler.

Design constraints, in priority order:

* **near-free when off** — a disabled tracer costs the hot path one
  contextvar read (``current_span()`` returning ``None``) and nothing
  else: no span objects, no clock reads, no locks. ``span()`` and
  ``Tracer.trace`` return the shared :data:`NOOP` singleton.
* **hard memory bounds** — completed traces land in a ring buffer
  (``deque(maxlen=...)``); the flight recorder keeps only the N slowest
  request traces (min-heap on root duration); open traces are capped in
  count and in spans per trace. Nothing grows with traffic.
* **one clock** — every timestamp is ``_EPOCH + perf_counter()`` so
  parent/child intervals nest strictly within a process regardless of
  wall-clock adjustment.

Propagation: the trace ID rides the existing ``X-Request-ID``
contextvar/header; ``X-Parent-Span`` carries the caller's span ID on
outbound hops (client SDK, httpstore), so event-server → store-server
and engine → store calls join one distributed trace. Span trees are
keyed internally by root span ID, not trace ID — two servers in one
process handling the same distributed trace record two linked trees
instead of corrupting each other.

Export: ``Tracer.chrome_trace()`` renders Chrome trace-event JSON that
loads directly in Perfetto (https://ui.perfetto.dev) — served at
``GET /debug/traces`` by every server, pulled by ``pio-tpu trace``.
"""

from __future__ import annotations

import contextvars
import heapq
import logging
import os
import secrets
import threading
import time
from collections import OrderedDict, deque

from predictionio_tpu_torch.obs.context import ID_OK

logger = logging.getLogger(__name__)

#: the one clock: wall-clock anchor for the monotonic perf counter, so
#: timestamps are epoch-meaningful AND nest strictly. time.time() is
#: read exactly once, at import, to anchor the epoch; every duration is
#: measured by perf_counter deltas on top of it, so an NTP step after
#: import can never reorder or stretch spans (it only offsets all
#: absolute timestamps equally).
_EPOCH = time.time() - time.perf_counter()  # pio-lint: disable=wall-clock -- one-shot epoch anchor; durations use perf_counter

#: header carrying the caller's span ID on outbound hops (the trace ID
#: itself rides X-Request-ID)
PARENT_SPAN_HEADER = "X-Parent-Span"

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "pio_span", default=None
)


def now() -> float:
    """Epoch seconds on the perf_counter clock (monotonic-consistent)."""
    return _EPOCH + time.perf_counter()


def new_span_id() -> str:
    return secrets.token_hex(8)


def _json_safe(value, depth: int = 3):
    """Caller-supplied span attributes, coerced to plain JSON: non-str
    dict keys become strings, unknown types become ``str(value)``, and
    the depth bound makes circular structures harmless — one weird
    attribute must never make the recorder unscrapeable or fail a
    training run's timeline write."""
    if value is None or isinstance(value, (str, int, float, bool)):
        return value
    if depth <= 0:
        return str(value)
    if isinstance(value, (list, tuple)):
        return [_json_safe(v, depth - 1) for v in value]
    if isinstance(value, dict):
        return {
            str(k): _json_safe(v, depth - 1) for k, v in value.items()
        }
    return str(value)


def sanitize_id(raw: str | None) -> str | None:
    """A forwarded span/trace ID, or None when absent or malformed
    (same acceptance as request IDs — obs.context.ID_OK)."""
    if raw and ID_OK.match(raw):
        return raw
    return None


def current_span() -> "Span | None":
    """The active span for this context (one contextvar read — this is
    the entire hot-path cost when tracing is off)."""
    return _current_span.get()


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path.

    ``__enter__`` returns ``None`` so instrumentation sites can guard
    attribute writes with ``if sp is not None``.
    """

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _NoopSpan()


class Span:
    """One timed operation; also its own context manager.

    ``trace_id`` groups spans across processes (it is the request ID);
    ``trace_key`` (the local root's span ID) groups them within one
    tracer, so two local trees of the same distributed trace — e.g. an
    event server and a store server sharing a process — never collide.
    """

    __slots__ = (
        "tracer",
        "trace_id",
        "trace_key",
        "span_id",
        "parent_id",
        "name",
        "start",
        "duration",
        "attributes",
        "root",
        "_token",
    )

    def __init__(
        self,
        tracer: "Tracer",
        trace_id: str,
        name: str,
        parent_id: str | None = None,
        trace_key: str | None = None,
        attributes: dict | None = None,
        root: bool = False,
    ):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.trace_key = trace_key if trace_key is not None else self.span_id
        self.parent_id = parent_id
        self.name = name
        self.start = 0.0
        self.duration = 0.0
        self.attributes = dict(attributes) if attributes else {}
        self.root = root
        self._token = None

    def set(self, key: str, value) -> None:
        self.attributes[key] = value

    def __enter__(self) -> "Span":
        self.start = now()
        if self.root:
            self.tracer._open(self.trace_key)
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.duration = now() - self.start
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        if exc_type is not None and "error" not in self.attributes:
            self.attributes["error"] = f"{exc_type.__name__}: {exc}"
        if self.root:
            # the root bypasses record()'s span cap — a capped trace
            # must still render its root bar
            self.tracer._finalize(self)
        else:
            self.tracer.record(self)
        return False

    def to_dict(self) -> dict:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "start": round(self.start, 6),
            "durationMs": round(self.duration * 1000, 3),
            "attributes": _json_safe(self.attributes),
        }


class _TraceBuf:
    """Spans of one open (root not yet closed) trace, span-capped."""

    __slots__ = ("spans", "dropped")

    def __init__(self):
        self.spans: list[Span] = []
        self.dropped = 0


class Tracer:
    """Bounded per-process span recorder.

    * ``trace(...)`` opens a ROOT span: its completion finalizes the
      trace into the ring buffer and (if among the N slowest) the
      flight recorder.
    * child spans come from :func:`span`, which attaches to the
      *parent's* tracer — instrumentation sites never need a tracer
      reference, and per-server tracers (tests, multi-tenant) work.
    * ``record(...)`` accepts an externally-built finished span (the
      micro-batcher's dispatch span copies).
    """

    def __init__(
        self,
        max_traces: int = 128,
        flight_slots: int = 16,
        max_spans_per_trace: int = 256,
        max_open_traces: int = 512,
        enabled: bool = True,
    ):
        self.enabled = enabled
        self._max_spans = max_spans_per_trace
        self._max_open = max_open_traces
        self._flight_slots = flight_slots
        self._lock = threading.Lock()
        self._open_traces: OrderedDict[str, _TraceBuf] = OrderedDict()
        self._ring: deque[dict] = deque(maxlen=max_traces)
        #: min-heap of (root duration, seq, trace) — N slowest retained
        self._flight: list[tuple[float, int, dict]] = []
        self._seq = 0
        #: open traces evicted at the cap — their spans are lost; the
        #: count is surfaced so that loss is diagnosable, not silent
        self._abandoned = 0

    # -- span construction -------------------------------------------------

    def trace(
        self,
        name: str,
        trace_id: str | None = None,
        parent_id: str | None = None,
        attributes: dict | None = None,
    ):
        """Root-span context manager for a new local trace; the shared
        no-op when disabled. ``trace_id`` is the request ID;
        ``parent_id`` is a forwarded remote span (``X-Parent-Span``)."""
        if not self.enabled:
            return NOOP
        return Span(
            self,
            trace_id or new_span_id(),
            name,
            parent_id=parent_id,
            attributes=attributes,
            root=True,
        )

    def child(self, parent: Span, name: str, attributes: dict | None = None):
        return Span(
            self,
            parent.trace_id,
            name,
            parent_id=parent.span_id,
            trace_key=parent.trace_key,
            attributes=attributes,
        )

    # -- recording ---------------------------------------------------------

    def _open(self, trace_key: str) -> None:
        evicted = []
        with self._lock:
            self._open_traces.pop(trace_key, None)
            while len(self._open_traces) >= self._max_open:
                # oldest open trace is abandoned (a root that never
                # closes must not leak memory forever) — counted and
                # logged, because the oldest open trace can be a
                # long-lived one you care about (a pio_train root in a
                # trainer that also serves)
                evicted.append(self._open_traces.popitem(last=False)[0])
                self._abandoned += 1
            self._open_traces[trace_key] = _TraceBuf()
        for key in evicted:
            logger.debug(
                "abandoned open trace %s at the open-trace cap; its "
                "spans are lost", key,
            )

    def record(self, span: Span) -> None:
        """A finished span joins its open trace; spans whose root is
        gone (or never existed) are dropped — nothing orphaned leaks."""
        with self._lock:
            buf = self._open_traces.get(span.trace_key)
            if buf is None:
                return
            if len(buf.spans) >= self._max_spans:
                buf.dropped += 1
                return
            buf.spans.append(span)

    def _finalize(self, root: Span) -> None:
        with self._lock:
            buf = self._open_traces.pop(root.trace_key, None)
            if buf is None:
                return
            buf.spans.append(root)
            trace = {
                "traceId": root.trace_id,
                "rootSpanId": root.span_id,
                "root": root.name,
                "start": round(root.start, 6),
                "durationMs": round(root.duration * 1000, 3),
                "droppedSpans": buf.dropped,
                "spans": [s.to_dict() for s in buf.spans],
            }
            self._ring.append(trace)
            self._seq += 1
            item = (root.duration, self._seq, trace)
            if len(self._flight) < self._flight_slots:
                heapq.heappush(self._flight, item)
            elif root.duration > self._flight[0][0]:
                heapq.heapreplace(self._flight, item)

    def clear(self) -> None:
        with self._lock:
            self._open_traces.clear()
            self._ring.clear()
            self._flight.clear()

    # -- export ------------------------------------------------------------

    def _snapshot(self) -> tuple[list[dict], list[dict]]:
        """(ring oldest-first, flight slowest-first) under one lock."""
        with self._lock:
            ring = list(self._ring)
            flight = [
                t for _d, _s, t in sorted(
                    self._flight, key=lambda it: -it[0]
                )
            ]
        return ring, flight

    def traces(self) -> list[dict]:
        """Everything retained: ring (oldest first), then flight-only
        traces the ring has since evicted (slowest first)."""
        ring, flight = self._snapshot()
        seen = {t["rootSpanId"] for t in ring}
        return ring + [t for t in flight if t["rootSpanId"] not in seen]

    def to_dict(self) -> dict:
        """Raw spans (``GET /debug/traces.json``)."""
        ring, flight = self._snapshot()
        return {
            "traces": ring,
            "flight": flight,
            "abandonedOpenTraces": self._abandoned,
        }

    def chrome_trace(self, trace_id: str | None = None) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable). Each retained
        trace renders as one "process" (pid) named after its trace ID;
        two local trees of one distributed trace share a pid. Spans
        within a trace are laid onto tracks (tid) so only strictly
        nested intervals share one — Perfetto's slice stack mis-renders
        partially-overlapping siblings on a single track (e.g. two
        algorithms' concurrent batch dispatches)."""
        records = self.traces()
        if trace_id is not None:
            records = [r for r in records if r["traceId"] == trace_id]
        events: list[dict] = []
        pid_by_trace: dict[str, int] = {}
        for rec in records:
            pid = pid_by_trace.get(rec["traceId"])
            if pid is None:
                pid = pid_by_trace[rec["traceId"]] = len(pid_by_trace) + 1
                events.append(
                    {
                        "name": "process_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": 0,
                        "args": {
                            "name": (
                                f"trace {rec['traceId']} ({rec['root']})"
                            )
                        },
                    }
                )
            for s, tid in _assign_lanes(rec["spans"]):
                events.append(
                    {
                        "name": s["name"],
                        "cat": "pio",
                        "ph": "X",
                        "pid": pid,
                        "tid": tid,
                        "ts": round(s["start"] * 1e6, 3),
                        "dur": round(s["durationMs"] * 1000, 3),
                        "args": {
                            "traceId": s["traceId"],
                            "spanId": s["spanId"],
                            "parentId": s["parentId"],
                            **s["attributes"],
                        },
                    }
                )
        return {"traceEvents": events, "displayTimeUnit": "ms"}


#: lane-fit tolerance: span starts are exported at 1e-6 s precision and
#: durations at 1e-6 s (3 dp of ms), so rounding can displace an
#: interval edge by ~1 µs either way — anything tighter kicks truly
#: nested or back-to-back spans onto a spurious "concurrent" track
_LANE_EPS = 2e-6


def _assign_lanes(spans: list[dict]) -> list[tuple[dict, int]]:
    """Greedy flame-graph track assignment: a span shares a track with
    the spans it strictly nests inside; a partial overlap (concurrent
    siblings) opens the next track. Returns (span, tid) pairs."""
    ordered = sorted(
        spans, key=lambda s: (s["start"], -s["durationMs"])
    )
    #: per track, the stack of currently-open interval end times
    tracks: list[list[float]] = []
    out: list[tuple[dict, int]] = []
    for s in ordered:
        start = s["start"]
        end = start + s["durationMs"] / 1000.0
        tid = None
        for i, stack in enumerate(tracks):
            while stack and stack[-1] <= start + _LANE_EPS:
                stack.pop()
            if not stack or end <= stack[-1] + _LANE_EPS:
                stack.append(end)
                tid = i + 1
                break
        if tid is None:
            tracks.append([end])
            tid = len(tracks)
        out.append((s, tid))
    return out


def span(name: str, **attributes):
    """Child span of the current context span, recorded into the
    tracer that owns the current trace. Off-trace (no root open on this
    context) or with tracing disabled this is the shared no-op — the
    instrumentation cost is one contextvar read."""
    parent = _current_span.get()
    if parent is None:
        return NOOP
    return parent.tracer.child(parent, name, attributes or None)


#: process-global tracer (every server defaults to it, like the default
#: metric registry); PIO_TRACING=0 disables it at startup
_default_tracer = Tracer(
    enabled=os.environ.get("PIO_TRACING", "1").lower()
    not in ("0", "false", "no")
)


def get_tracer() -> Tracer:
    return _default_tracer
