"""Micro-batching queue for serving.

Counterpart of ``predictionio_tpu/serving/batching.py``: concurrent
requests coalesce into one batch for one kernel launch. The batcher is a
two-stage pipeline: a **collector** thread assembles batches
(``max_batch`` / adaptive wait, cancellation, deadline drops) and
launches them, and a **completer** thread waits for each batch's results
and settles its futures. ``pipeline_depth`` bounds batches launched but
not yet collected (2 = double buffering; 0 = both stages inline on one
thread).

``batch_fn`` is either a plain callable ``(items) -> results``, run once
per batch in the completer, or a two-phase object with
``dispatch(items) -> handle`` and ``collect(handle) -> results``
(:class:`TwoPhaseBatchFn`). On the card ``dispatch`` queues the kernel
on the CUDA stream and returns at once, and ``collect`` waits for the
copy back: so ``pio_device_enqueue_seconds`` times the launch and
``pio_device_sync_seconds`` the wait for the device, which is what
:meth:`MicroBatcher._attribute` apportions to tenants.

Overload discipline, as in the JAX package: when the backlog exceeds one
batch the nearest-deadline slots go first; at the queue-depth bound a
submission of a higher criticality class evicts the lowest-class queued
slot (``pio_shed_total{batcher,class}``); :meth:`MicroBatcher.retry_after_s`
turns live queue state into the ``Retry-After`` a shed carries. The cut
of cancelled and expired slots in ``_dispatch_batch`` is the last word
before the kernel launch.

One repair against the reference (ROADMAP.md §3): a cancelled slot
still waiting in the queue no longer counts against ``max_queue``. At
the bound ``submit`` first sweeps the cancelled slots out (counted in
``pio_batch_cancelled_total``, as the launch-time cut counts them), so a
queue full of abandoned work never refuses a live submission.
"""

from __future__ import annotations

import logging
import math
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, NamedTuple, Sequence

from predictionio_tpu_torch.obs import MetricRegistry, get_request_id
from predictionio_tpu_torch.obs import timeline as timeline_mod
from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.obs.context import log_json
from predictionio_tpu_torch.obs.registry import LATENCY_BUCKETS, OCCUPANCY_BUCKETS
from predictionio_tpu_torch.serving import admission, resilience

logger = logging.getLogger(__name__)


class BatcherOverloaded(Exception):
    """Queue depth bound hit — shed the request instead of queuing it.

    Deliberately NOT a RuntimeError: callers distinguish overload
    (client should back off, 503 fast) from a closed batcher mid-reload
    (retry against the fresh set).
    """


class BatcherClosed(RuntimeError):
    """``submit`` on a closed batcher: a draining old generation, after a
    ``/reload`` or a canary verdict swapped it out. The one
    ``RuntimeError`` a caller may retry elsewhere or drop; a device
    failure is any other ``RuntimeError``."""


class TwoPhaseBatchFn:
    """The pipelined ``batch_fn`` protocol: enqueue now, sync later.

    ``dispatch(items) -> handle`` must queue the device work and
    return without blocking on it (a kernel launch on the CUDA stream
    returns at once; the handle holds the un-fetched device tensors).
    ``collect(handle) -> results`` waits for the copy back and
    materializes one result per item, in order.

    The batcher duck-types on ``dispatch``/``collect`` attributes, so
    any object with both works; this class is the explicit spelling.
    """

    __slots__ = ("dispatch", "collect")

    def __init__(
        self,
        dispatch: Callable[[Sequence[Any]], Any],
        collect: Callable[[Any], Sequence[Any]],
    ):
        self.dispatch = dispatch
        self.collect = collect


class _Slot(NamedTuple):
    """One queued submission: the payload, its Future, the submitting
    request's identity (ID + open span + submit time) for dispatch logs
    and trace spans, its deadline so expired work is dropped before
    the device sees it, and its criticality class so overload evicts
    the least-critical queued work first."""

    item: Any
    future: Future
    request_id: str | None
    parent_span: Any  # tracing.Span | None
    submitted_mono: float
    deadline: Any  # resilience.Deadline | None
    criticality: str = admission.DEFAULT
    tenant: str = ""


class _Inflight(NamedTuple):
    """One enqueued batch riding the collector→completer handoff."""

    live: list  # [_Slot]
    handle: Any
    start_wall: float
    start_mono: float
    t0: float  # perf_counter at dispatch entry
    enqueue_s: float
    traced: bool


class _NullMetrics:
    """Registry-free fast path: every hook is a no-op."""

    __slots__ = ()

    def queue_depth(self, n: int) -> None:
        pass

    def shed(self, criticality: str) -> None:
        pass

    def dispatched(self, occupancy: int, seconds: float) -> None:
        pass

    def enqueued(self, seconds: float) -> None:
        pass

    def synced(self, seconds: float) -> None:
        pass

    def cancelled(self, n: int) -> None:
        pass

    def expired(self, n: int) -> None:
        pass

    def leaked(self) -> None:
        pass

    def attributed(
        self, tenant: str, device_s: float, wait_s: float, status: str
    ) -> None:
        pass


#: queue-wait budget a tenant's requests must beat for the tenant to
#: count as UNHARMED in the noisy-neighbor check; default is half the
#: default-class SLO latency (obs/slo.py). Override with
#: PIO_TENANT_WAIT_SLO_MS.
_DEFAULT_WAIT_SLO_S = 0.5

#: a tenant is a noisy-neighbor CANDIDATE when its device-seconds over
#: the rollup window exceed this multiple of the fair per-tenant share
_NOISY_SHARE_FACTOR = 1.5

#: noisy-neighbor rollup window (seconds): device share and queue-wait
#: breaches accumulate per window, the gauge updates at rollover
_NOISY_WINDOW_S = 15.0


def _wait_slo_s() -> float:
    raw = os.environ.get("PIO_TENANT_WAIT_SLO_MS")
    if not raw:
        return _DEFAULT_WAIT_SLO_S
    try:
        value = float(raw)
    except ValueError:
        return _DEFAULT_WAIT_SLO_S
    return value / 1000.0 if value > 0 else _DEFAULT_WAIT_SLO_S


class _NoisyRollup:
    """Per-window noisy-neighbor detection over the attribution stream.

    A tenant is flagged when BOTH hold over one window: it consumed
    more than ``_NOISY_SHARE_FACTOR`` x the fair per-tenant device
    share, and some OTHER tenant's queue wait breached the wait SLO —
    i.e. the overuse visibly harmed a neighbor. Advisory only (a gauge
    + timeline event beside the fair-share admission path, never an
    enforcement input). Callers hold no lock; all state is guarded by
    the owning ``_BatcherMetrics``' attribution lock."""

    __slots__ = (
        "noisy_gauge", "window_end", "device_s", "breached", "flagged",
        "wait_slo_s",
    )

    def __init__(self, noisy_gauge):
        self.noisy_gauge = noisy_gauge
        self.window_end = time.monotonic() + _NOISY_WINDOW_S
        self.device_s: dict[str, float] = {}
        self.breached: set[str] = set()
        self.flagged: set[str] = set()
        self.wait_slo_s = _wait_slo_s()

    def observe(self, tenant: str, device_s: float, wait_s: float) -> None:
        self.device_s[tenant] = (
            self.device_s.get(tenant, 0.0) + device_s
        )
        if wait_s > self.wait_slo_s:
            self.breached.add(tenant)
        now = time.monotonic()
        if now >= self.window_end:
            self._roll(now)

    def _roll(self, now: float) -> None:
        total = sum(self.device_s.values())
        tenants = set(self.device_s)
        fair = total / max(1, len(tenants))
        noisy = {
            t
            for t, used in self.device_s.items()
            if len(tenants) > 1
            and used > _NOISY_SHARE_FACTOR * fair
            and (self.breached - {t})
        }
        for t in noisy - self.flagged:
            self.noisy_gauge.labels(t).set(1)
            timeline_mod.get_timeline().record(
                "noisy_neighbor", f"tenant {t!r} over fair device share "
                "while neighbors breached their queue-wait SLO",
                severity=timeline_mod.WARN, tenant=t,
            )
        for t in self.flagged - noisy:
            self.noisy_gauge.labels(t).set(0)
            timeline_mod.get_timeline().record(
                "noisy_neighbor", f"tenant {t!r} back within fair share",
                tenant=t,
            )
        self.flagged = noisy
        self.device_s = {}
        self.breached = set()
        self.window_end = now + _NOISY_WINDOW_S


class _BatcherMetrics:
    """Bound registry children for one named batcher."""

    __slots__ = ("_depth", "_shed", "_shed_class", "_name", "_occupancy",
                 "_dispatch", "_enqueue", "_sync", "_batches",
                 "_cancelled", "_expired", "_leaked",
                 "_tenant_device", "_tenant_wait", "_tenant_requests",
                 "_attr_lock", "_noisy")

    def __init__(self, registry: MetricRegistry, name: str):
        self._name = name
        self._depth = registry.gauge(
            "pio_batch_queue_depth",
            "Items waiting in the micro-batch queue",
            ("batcher",),
        ).labels(name)
        self._shed = registry.counter(
            "pio_batch_shed_total",
            "Submissions refused at the queue-depth bound",
            ("batcher",),
        ).labels(name)
        self._shed_class = registry.counter(
            "pio_shed_total",
            "Work shed by the batcher under overload, by criticality "
            "class (refused at the bound, or evicted by a "
            "higher-criticality submission)",
            ("batcher", "class"),
        )
        self._occupancy = registry.histogram(
            "pio_batch_occupancy",
            "Queries per dispatched device batch",
            ("batcher",),
            buckets=OCCUPANCY_BUCKETS,
        ).labels(name)
        self._dispatch = registry.histogram(
            "pio_device_dispatch_seconds",
            "End-to-end wall clock of one batch: device enqueue "
            "through collected results",
            ("batcher",),
            buckets=LATENCY_BUCKETS,
        ).labels(name)
        self._enqueue = registry.histogram(
            "pio_device_enqueue_seconds",
            "Host time enqueuing one batch to the device (two-phase "
            "dispatch(); ~0 for single-phase batch_fns)",
            ("batcher",),
            buckets=LATENCY_BUCKETS,
        ).labels(name)
        self._sync = registry.histogram(
            "pio_device_sync_seconds",
            "Device barrier + host result materialization of one "
            "batch (two-phase collect(), or the whole single-phase "
            "batch_fn)",
            ("batcher",),
            buckets=LATENCY_BUCKETS,
        ).labels(name)
        self._batches = registry.counter(
            "pio_batches_total",
            "Device batches dispatched",
            ("batcher",),
        ).labels(name)
        self._cancelled = registry.counter(
            "pio_batch_cancelled_total",
            "Slots cancelled before dispatch (device work avoided)",
            ("batcher",),
        ).labels(name)
        self._expired = registry.counter(
            "pio_batch_deadline_expired_total",
            "Slots dropped before device dispatch because their "
            "deadline had already expired",
            ("batcher",),
        ).labels(name)
        self._leaked = registry.counter(
            "pio_batcher_leaked_threads_total",
            "Worker threads still alive after close() timed out "
            "joining them",
            ("batcher",),
        ).labels(name)
        # tenant cost attribution: families are UNBOUND (labelled per
        # settle) and shared across batchers — the registry get-or-create
        # makes repeat registration from every batcher/pool safe, and
        # fleet federation sums them per tenant across replicas
        self._tenant_device = registry.counter(
            "pio_tenant_device_seconds_total",
            "Measured device time (enqueue + sync) apportioned to the "
            "tenant's slots, by slot count per coalesced batch",
            ("tenant",),
        )
        self._tenant_wait = registry.histogram(
            "pio_tenant_queue_wait_seconds",
            "Per-slot wait between batch submit and device dispatch, "
            "by tenant",
            ("tenant",),
            buckets=LATENCY_BUCKETS,
        )
        self._tenant_requests = registry.counter(
            "pio_tenant_requests_total",
            "Batch slots settled per tenant, by outcome",
            ("tenant", "status"),
        )
        self._attr_lock = threading.Lock()
        self._noisy = _NoisyRollup(
            registry.gauge(
                "pio_tenant_noisy",
                "1 while the tenant exceeds its fair device share AND "
                "other tenants' queue waits breach the wait SLO "
                "(advisory; see docs/observability.md)",
                ("tenant",),
            )
        )

    def queue_depth(self, n: int) -> None:
        self._depth.set(n)

    def shed(self, criticality: str) -> None:
        self._shed.inc()
        self._shed_class.labels(self._name, criticality).inc()

    def dispatched(self, occupancy: int, seconds: float) -> None:
        self._batches.inc()
        self._occupancy.observe(occupancy)
        self._dispatch.observe(seconds)

    def enqueued(self, seconds: float) -> None:
        self._enqueue.observe(seconds)

    def synced(self, seconds: float) -> None:
        self._sync.observe(seconds)

    def cancelled(self, n: int) -> None:
        self._cancelled.inc(n)

    def expired(self, n: int) -> None:
        self._expired.inc(n)

    def leaked(self) -> None:
        self._leaked.inc()

    def attributed(
        self, tenant: str, device_s: float, wait_s: float, status: str
    ) -> None:
        """One slot's share of a settled batch. Conservation contract:
        the settle paths call this for EVERY live slot with exactly
        ``(enqueue_s + sync_s) / len(live)``, success and failure
        alike, so the per-tenant sum equals the batcher's measured
        device time (asserted in tests and scripts/metrics_smoke.py)."""
        self._tenant_device.labels(tenant).inc(device_s)
        self._tenant_wait.labels(tenant).observe(wait_s)
        self._tenant_requests.labels(tenant, status).inc()
        # settlement runs on the completer AND the collector (serial /
        # dispatch-failure paths); the rollup's read-modify-write needs
        # its own tiny guard
        with self._attr_lock:
            self._noisy.observe(tenant, device_s, wait_s)


class MicroBatcher:
    """Coalesce submit()-ed items into batches for ``batch_fn``.

    A batch is dispatched when ``max_batch`` items are waiting or the
    coalescing wait elapsed since the first queued item — the classic
    latency/throughput knob. With ``adaptive_wait`` (default on) the
    wait self-tunes: each batch that fills to ``max_batch`` halves the
    next window toward 0 (a hot queue refills instantly from backlog —
    waiting only adds latency), and the first non-full batch restores
    the full ``max_wait_ms`` (idle traffic keeps the whole window to
    coalesce). ``max_queue`` bounds queued items: beyond it, ``submit``
    raises :class:`BatcherOverloaded` so overload turns into fast
    shedding rather than client-side timeout hangs.

    ``pipeline_depth`` bounds batches in flight between device enqueue
    and collected results (default 2 = double buffering; 0 = the
    pre-pipeline serial behavior, everything inline on one thread).

    Returned futures support ``cancel()`` up to the moment their batch
    is dispatched: a cancelled slot is dropped from the batch (its
    device work never happens) and counted in
    ``pio_batch_cancelled_total``. Callers that abandon accepted
    futures (e.g. a partially-overloaded multi-algorithm batch slot)
    should cancel them rather than leak the dispatch.

    Overload semantics: the wait queue is not strictly FIFO. When the
    backlog exceeds ``max_batch`` at selection time, the slots with the
    nearest deadlines dispatch first (work about to expire must not
    rot behind slack work); arrival order breaks ties and orders
    deadline-less slots. At the ``max_queue`` bound, a submission of a
    strictly higher criticality class (``X-PIO-Criticality``, read
    from the admission contextvar) evicts the lowest-class queued slot
    — the evicted future fails with :class:`BatcherOverloaded` and the
    shed is accounted per class in ``pio_shed_total{batcher,class}``.
    """

    def __init__(
        self,
        batch_fn: Callable[[Sequence[Any]], Sequence[Any]] | TwoPhaseBatchFn,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        max_queue: int | None = None,
        registry: MetricRegistry | None = None,
        name: str = "default",
        close_join_timeout_s: float = 30.0,
        pipeline_depth: int = 2,
        adaptive_wait: bool = True,
    ):
        if hasattr(batch_fn, "dispatch") and hasattr(batch_fn, "collect"):
            self._dispatch_fn = batch_fn.dispatch
            self._collect_fn = batch_fn.collect
        else:
            # single-phase compatibility: the whole batch_fn runs as
            # the collect stage (so next-batch assembly still overlaps
            # its compute) and is called exactly once per batch — no
            # wrapper barriers
            self._dispatch_fn = None
            self._collect_fn = batch_fn
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1000.0
        self._adaptive = adaptive_wait
        #: the live coalescing window (introspectable; updated by the
        #: collector after every batch when adaptive_wait is on)
        self._current_wait = self._max_wait
        self._close_join_timeout_s = close_join_timeout_s
        self._max_queue = (
            max_queue if max_queue is not None else 8 * max_batch
        )
        self.name = name
        self._metrics = (
            _BatcherMetrics(registry, name)
            if registry is not None
            else _NullMetrics()
        )
        #: wait queue + its condition: submit appends and notifies, the
        #: collector selects under the same lock. One lock, never held
        #: across dispatch or any blocking wait (Condition.wait excepted)
        self._cv = threading.Condition()
        self._buf: list[_Slot] = []
        self._closed = threading.Event()
        #: EWMA of end-to-end batch seconds — feeds retry_after_s().
        #: Guarded by the cv: the settle path runs on BOTH worker
        #: threads (completer normally, collector for dispatch-phase
        #: failures and the serial fallback), so the read-modify-write
        #: would otherwise lose updates between them
        self._batch_ewma_s = 0.0
        self._pipeline_depth = max(0, pipeline_depth)
        self._completer: threading.Thread | None = None
        if self._pipeline_depth > 0:
            self._pending: queue.Queue = queue.Queue()
            self._inflight = threading.Semaphore(self._pipeline_depth)
            self._completer = threading.Thread(
                target=self._complete_loop, name=f"{name}-completer",
                daemon=True,
            )
            self._completer.start()
        self._thread = threading.Thread(
            target=self._loop, name=f"{name}-collector", daemon=True
        )
        self._thread.start()

    def submit(self, item: Any) -> Future:
        # a request whose budget already ran out must not take a
        # queue slot at all — the 504 costs nothing here but would
        # cost a dispatch slot at flush time. Checked BEFORE the
        # overload bound: doomed work must never trigger an eviction.
        deadline = resilience.get_deadline()
        criticality = admission.get_criticality()
        tenant = admission.get_tenant()
        victim: _Slot | None = None
        # the cv orders submit against close(): once closed is set under
        # it, no new slot can slip into the buffer behind the drain
        with self._cv:
            if self._closed.is_set():
                raise BatcherClosed("batcher is closed")
            if deadline is not None and deadline.expired:
                self._metrics.expired(1)
                raise resilience.DeadlineExceeded(
                    "deadline expired before batch submit"
                )
            if (
                self._max_queue > 0
                and len(self._buf) >= self._max_queue
                and (
                    self._sweep_cancelled() == 0
                    or len(self._buf) >= self._max_queue
                )
            ):
                victim = self._pick_victim(criticality)
                if victim is None:
                    self._metrics.shed(criticality)
                    raise BatcherOverloaded(
                        f"batch queue at capacity ({self._max_queue})"
                    )
                self._buf.remove(victim)
                self._metrics.shed(victim.criticality)
            future: Future = Future()
            # the submitting request's ID and span ride the slot so
            # dispatch logs can name the requests in a slow/failed
            # batch, and the dispatch span can link back to every query
            # it coalesced. With tracing off the extra cost is exactly
            # the current_span() contextvar read (parent is None).
            parent_span = tracing.current_span()
            # submit time is stamped unconditionally (not just under a
            # trace): per-tenant queue-wait attribution needs it for
            # every slot
            self._buf.append(
                _Slot(
                    item,
                    future,
                    get_request_id(),
                    parent_span,
                    time.monotonic(),
                    deadline,
                    criticality,
                    tenant,
                )
            )
            self._metrics.queue_depth(len(self._buf))
            self._cv.notify()
        if victim is not None:
            # settle the evicted waiter OUTSIDE the lock: its
            # done-callbacks run inline and must not execute under the
            # batcher's condition
            if victim.future.set_running_or_notify_cancel():
                victim.future.set_exception(
                    BatcherOverloaded(
                        "shed: evicted by a higher-criticality "
                        "submission under overload"
                    )
                )
        return future

    def _sweep_cancelled(self) -> int:
        """cv held. Drop the queued slots whose futures were cancelled,
        and return how many. Their waiters are gone; the launch-time cut
        would drop them anyway, so they must not hold the queue-depth
        bound against a live submission (the reference counts them,
        ROADMAP.md §3)."""
        live = []
        swept = 0
        for slot in self._buf:
            if slot.future.cancelled():
                slot.future.set_running_or_notify_cancel()
                swept += 1
            else:
                live.append(slot)
        if swept:
            self._buf = live
            self._metrics.cancelled(swept)
        return swept

    def _pick_victim(self, criticality: str) -> "_Slot | None":
        """cv held. The queued slot a full buffer sheds to admit a
        ``criticality``-class submission: strictly lower class only
        (equal class waits its turn — no churn), lowest class first,
        then the nearest deadline (the slot most likely to die unserved
        anyway loses the least goodput), then the latest arrival."""
        incoming = admission.CLASS_RANK.get(
            criticality, admission.CLASS_RANK[admission.DEFAULT]
        )
        victim = None
        victim_key = None
        for i, slot in enumerate(self._buf):
            rank = admission.CLASS_RANK.get(slot.criticality, 1)
            if rank >= incoming or slot.future.cancelled():
                continue
            key = (
                rank,
                slot.deadline.expires_mono
                if slot.deadline is not None
                else math.inf,
                -i,
            )
            if victim_key is None or key < victim_key:
                victim, victim_key = slot, key
        return victim

    def __call__(self, item: Any, timeout: float | None = 30.0) -> Any:
        # the waiter must never outlive the budget it was admitted
        # under: a request deadline in context caps the result wait, so
        # an expired budget surfaces as a timeout now, not 30 s later
        deadline = resilience.get_deadline()
        if deadline is not None:
            timeout = deadline.cap(
                timeout
                if timeout is not None
                else resilience.Deadline.MAX_BUDGET_S
            )
        return self.submit(item).result(timeout=timeout)

    def retry_after_s(self) -> float:
        """Cooperative-backpressure hint from live queue state: about
        how long until the current backlog has drained through the
        device (queued batches × recent batch time), clamped to
        [0.05, 5] — what a shed response's ``Retry-After`` should say
        (docs/robustness.md)."""
        with self._cv:
            depth = len(self._buf)
            per_batch = max(self._batch_ewma_s, 0.001)
        batches_ahead = 1.0 + depth / max(1, self._max_batch)
        return min(5.0, max(0.05, batches_ahead * per_batch))

    def close(self) -> None:
        """Graceful, in pipeline order: the collector drains queued
        items through dispatch, in-flight dispatches complete,
        their futures resolve, then both threads exit. A worker stuck
        in a hung dispatch past the join timeout is reported
        (structured warning + ``pio_batcher_leaked_threads_total``)
        instead of silently leaked."""
        with self._cv:
            if self._closed.is_set():
                return
            self._closed.set()
            self._cv.notify_all()  # wake the collector to drain
        join_deadline = time.monotonic() + self._close_join_timeout_s
        self._thread.join(timeout=self._close_join_timeout_s)
        leaked = self._thread.is_alive()
        if self._completer is not None:
            # the completer sentinel is sent by the collector alone
            # (end of its drain loop). If the collector is hung we do
            # NOT inject one here: it could overtake a batch the stuck
            # collector is still about to hand off, and an exited
            # completer would strand that batch's futures forever. Both
            # threads are daemons — if the collector ever unblocks it
            # drains, sends the real sentinel, and the futures resolve
            # late instead of never.
            self._completer.join(
                timeout=max(0.1, join_deadline - time.monotonic())
            )
            leaked = leaked or self._completer.is_alive()
        if leaked:
            self._metrics.leaked()
            log_json(
                logger, logging.WARNING, "batcher_thread_leaked",
                batcher=self.name,
                joinTimeoutS=self._close_join_timeout_s,
            )

    # -- collector stage ---------------------------------------------------
    def _select_batch(self) -> list:
        """cv held. Take up to ``max_batch`` slots out of the buffer —
        deadline-aware when over-full: the nearest-deadline slots go
        first so near-expiry work isn't served dead behind slack work;
        arrival order breaks ties (and orders deadline-less slots), and
        the dispatched batch itself keeps arrival order."""
        buf = self._buf
        if len(buf) <= self._max_batch:
            batch = buf
            self._buf = []
        else:
            order = sorted(
                range(len(buf)),
                key=lambda i: (
                    buf[i].deadline.expires_mono
                    if buf[i].deadline is not None
                    else math.inf,
                    i,
                ),
            )
            chosen = set(order[: self._max_batch])
            batch = [buf[i] for i in sorted(chosen)]
            self._buf = [
                slot for i, slot in enumerate(buf) if i not in chosen
            ]
        if not self._closed.is_set():
            # a closed batcher is a draining OLD generation — after
            # /reload its replacement shares the same gauge child, and
            # a final set() here would overwrite the live queue depth
            self._metrics.queue_depth(len(self._buf))
        return batch

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._buf and not self._closed.is_set():
                    self._cv.wait()
                if not self._buf:
                    break  # closed and fully drained
                if not self._closed.is_set():
                    # coalesce: wait out the window from the FIRST
                    # queued item unless the batch fills (or close
                    # lands — a drain dispatches immediately)
                    window_end = time.monotonic() + self._current_wait
                    while (
                        len(self._buf) < self._max_batch
                        and not self._closed.is_set()
                    ):
                        remaining = window_end - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                batch = self._select_batch()
            full = len(batch) >= self._max_batch
            self._dispatch_batch(batch)
            if self._adaptive:
                # hot: a full batch means backlog is doing the
                # coalescing — halve the window toward 0 so queue wait
                # stops taxing p50. The first non-full batch restores
                # the whole window for idle-traffic coalescing.
                if full:
                    wait = self._current_wait * 0.5
                    if wait < self._max_wait / 64:
                        wait = 0.0
                    self._current_wait = wait
                else:
                    self._current_wait = self._max_wait
        if self._completer is not None:
            self._pending.put(None)  # completer drains in order, then exits

    def _dispatch_batch(self, batch) -> None:
        # backpressure BEFORE the cancellation/deadline cutoff: while
        # the collector waits for a pipeline slot (device slow, depth
        # exhausted) waiters can still cancel and budgets can still
        # expire — the cutoff below must be the last word before the
        # device sees the work
        if self._completer is not None:
            self._inflight.acquire()
        # transition every slot to running; cancelled slots drop out
        # HERE, before the device sees them — cancellation is how an
        # abandoning caller turns wasted dispatch into avoided dispatch.
        # Expired-deadline slots drop out the same way (the deadline
        # re-check at dispatch entry): their waiter is already gone (or
        # about to time out), so dispatching them would burn device
        # time computing unreceivable answers.
        live = []
        expired = 0
        for slot in batch:
            if not slot.future.set_running_or_notify_cancel():
                continue
            if slot.deadline is not None and slot.deadline.expired:
                slot.future.set_exception(
                    resilience.DeadlineExceeded(
                        "deadline expired while queued for dispatch"
                    )
                )
                expired += 1
                continue
            live.append(slot)
        if dropped := len(batch) - len(live) - expired:
            self._metrics.cancelled(dropped)
        if expired:
            self._metrics.expired(expired)
            log_json(
                logger, logging.DEBUG, "batch_slots_expired",
                batcher=self.name, expired=expired,
            )
        if not live:
            if self._completer is not None:
                self._inflight.release()
            return
        # dispatch-span bookkeeping only when at least one slot was
        # submitted under an open trace — untraced traffic pays nothing
        traced = any(slot.parent_span is not None for slot in live)
        start_wall = tracing.now() if traced else 0.0
        # dispatch-start is stamped unconditionally: queue-wait
        # attribution (submit -> dispatch) covers untraced traffic too
        start_mono = time.monotonic()
        if self._completer is None:
            self._flush_serial(live, start_wall, start_mono, traced)
            return
        items = [slot.item for slot in live]
        t0 = time.perf_counter()
        if self._dispatch_fn is None:
            # single-phase: the handle is the items; batch_fn runs once
            # in the completer
            handle, enqueue_s = items, 0.0
        else:
            try:
                handle = self._dispatch_fn(items)
            except Exception as e:  # noqa: BLE001 - propagate to waiters
                self._inflight.release()
                enqueue_s = time.perf_counter() - t0
                self._metrics.enqueued(enqueue_s)
                self._settle_failure(
                    live, e, time.perf_counter() - t0,
                    start_wall, start_mono, traced,
                    enqueue_s=enqueue_s, sync_s=0.0, phase="dispatch",
                )
                return
            enqueue_s = time.perf_counter() - t0
            self._metrics.enqueued(enqueue_s)
        self._pending.put(
            _Inflight(
                live, handle, start_wall, start_mono, t0, enqueue_s,
                traced,
            )
        )

    # -- completer stage ---------------------------------------------------
    def _complete_loop(self) -> None:
        while True:
            rec = self._pending.get()
            if rec is None:
                return
            try:
                t1 = time.perf_counter()
                sync_s = 0.0
                try:
                    # sync time is observed in the finally so a failed
                    # collect's device time lands in the histogram too
                    # — attribution charges exactly what was observed,
                    # success or failure (conservation)
                    try:
                        results = self._collect_fn(rec.handle)
                    finally:
                        sync_s = time.perf_counter() - t1
                        self._metrics.synced(sync_s)
                    if len(results) != len(rec.live):
                        raise RuntimeError(
                            f"batch_fn returned {len(results)} results "
                            f"for {len(rec.live)} items"
                        )
                except Exception as e:  # noqa: BLE001 - to every waiter
                    self._settle_failure(
                        rec.live, e, time.perf_counter() - rec.t0,
                        rec.start_wall, rec.start_mono, rec.traced,
                        enqueue_s=rec.enqueue_s,
                        sync_s=sync_s,
                        phase="collect",
                    )
                    continue
                self._settle_success(
                    rec.live, results, time.perf_counter() - rec.t0,
                    rec.start_wall, rec.start_mono, rec.traced,
                    enqueue_s=rec.enqueue_s, sync_s=sync_s,
                )
            finally:
                self._inflight.release()

    # -- serial fallback (pipeline_depth=0) --------------------------------
    def _flush_serial(
        self, live, start_wall: float, start_mono: float, traced: bool
    ) -> None:
        """The pre-pipeline inline path: enqueue + sync back to back on
        the collector thread. Kept for apples-to-apples benchmarking
        and as an escape hatch (``pipeline_depth=0``)."""
        items = [slot.item for slot in live]
        t0 = time.perf_counter()
        enqueue_s = 0.0
        try:
            if self._dispatch_fn is None:
                handle = items
            else:
                handle = self._dispatch_fn(items)
                enqueue_s = time.perf_counter() - t0
                self._metrics.enqueued(enqueue_s)
            t1 = time.perf_counter()
            results = self._collect_fn(handle)
            sync_s = time.perf_counter() - t1
            self._metrics.synced(sync_s)
            if len(results) != len(items):
                raise RuntimeError(
                    f"batch_fn returned {len(results)} results for "
                    f"{len(items)} items"
                )
        except Exception as e:  # noqa: BLE001 - propagate to every waiter
            self._settle_failure(
                live, e, time.perf_counter() - t0, start_wall,
                start_mono, traced, enqueue_s=enqueue_s, sync_s=0.0,
                phase="serial",
            )
            return
        self._settle_success(
            live, results, time.perf_counter() - t0, start_wall,
            start_mono, traced, enqueue_s=enqueue_s, sync_s=sync_s,
        )

    # -- shared settlement -------------------------------------------------
    def _observe_batch_time(self, elapsed: float) -> None:
        # feeds retry_after_s(). Settlement runs on the completer OR
        # the collector (dispatch-phase failure, serial fallback), so
        # the EWMA fold takes the cv — both writers and the
        # retry_after_s() reader agree on one guard
        with self._cv:
            self._batch_ewma_s = (
                elapsed
                if self._batch_ewma_s == 0.0
                else 0.8 * self._batch_ewma_s + 0.2 * elapsed
            )

    def _attribute(
        self, live, start_mono: float, enqueue_s: float, sync_s: float,
        status: str,
    ) -> None:
        """Apportion the batch's measured device time across its slots
        by slot count — every live slot, on success AND failure paths,
        so per-tenant sums conserve the batcher's total device time."""
        share = (enqueue_s + sync_s) / len(live)
        for slot in live:
            self._metrics.attributed(
                slot.tenant,
                share,
                max(0.0, start_mono - slot.submitted_mono),
                status,
            )

    def _settle_success(
        self, live, results, elapsed: float, start_wall: float,
        start_mono: float, traced: bool, enqueue_s: float, sync_s: float,
    ) -> None:
        self._observe_batch_time(elapsed)
        self._metrics.dispatched(len(live), elapsed)
        self._attribute(live, start_mono, enqueue_s, sync_s, "ok")
        if traced:
            self._record_dispatch_spans(
                live, start_wall, start_mono, elapsed,
                enqueue_s=enqueue_s, sync_s=sync_s,
            )
        log_json(
            logger, logging.DEBUG, "batch_dispatch",
            batcher=self.name, occupancy=len(live),
            ms=round(elapsed * 1000, 3),
            enqueueMs=round(enqueue_s * 1000, 3),
            requestIds=[s.request_id for s in live if s.request_id],
        )
        for slot, result in zip(live, results):
            slot.future.set_result(result)

    def _settle_failure(
        self, live, exc: Exception, elapsed: float, start_wall: float,
        start_mono: float, traced: bool, enqueue_s: float, sync_s: float,
        phase: str,
    ) -> None:
        self._observe_batch_time(elapsed)
        self._metrics.dispatched(len(live), elapsed)
        self._attribute(live, start_mono, enqueue_s, sync_s, "error")
        if traced:
            self._record_dispatch_spans(
                live, start_wall, start_mono, elapsed,
                enqueue_s=enqueue_s, sync_s=sync_s,
                error=f"{type(exc).__name__}: {exc}",
            )
        log_json(
            logger, logging.WARNING, "batch_dispatch_failed",
            batcher=self.name, occupancy=len(live), phase=phase,
            ms=round(elapsed * 1000, 3),
            error=f"{type(exc).__name__}: {exc}",
            requestIds=[s.request_id for s in live if s.request_id],
        )
        for slot in live:
            if not slot.future.done():
                slot.future.set_exception(exc)

    def _record_dispatch_spans(
        self, live, start_wall: float, start_mono: float,
        elapsed: float, enqueue_s: float = 0.0, sync_s: float = 0.0,
        error: str | None = None,
    ) -> None:
        """One device dispatch, seen from every trace that rode in it.

        The dispatch happens once but coalesces queries from many
        requests (= many traces), so each DISTINCT submitting span gets
        one child ``batch_dispatch`` span copy carrying the shared
        timing plus its queue wait, with ``links`` naming every
        coalesced query span — the cross-request join Perfetto can't
        infer. Distinct matters: a batch-queries request submits many
        slots under one span, and per-slot copies would overflow the
        per-trace span cap with duplicates."""
        parents: dict[str, tuple] = {}
        for slot in live:
            span = slot.parent_span
            if span is not None and span.span_id not in parents:
                parents[span.span_id] = (span, slot.submitted_mono)
        links = [
            f"{p.trace_id}:{p.span_id}" for p, _t in parents.values()
        ]
        for parent, submitted_mono in parents.values():
            # retrospective span: built AFTER the interval it describes,
            # start/duration assigned below and recorded directly — it
            # is never entered, so it cannot sit in the open-trace
            # table, and there is no exit path on which it could leak
            # pio-lint: disable-next=span-leak -- retrospective: recorded complete, never opened
            dispatch = tracing.Span(
                parent.tracer,
                parent.trace_id,
                "batch_dispatch",
                parent_id=parent.span_id,
                trace_key=parent.trace_key,
                attributes={
                    "batcher": self.name,
                    "occupancy": len(live),
                    "queueWaitMs": round(
                        max(0.0, start_mono - submitted_mono) * 1000, 3
                    ),
                    "deviceDispatchMs": round(elapsed * 1000, 3),
                    "hostEnqueueMs": round(enqueue_s * 1000, 3),
                    "deviceMs": round(sync_s * 1000, 3),
                    "links": links,
                },
            )
            if error is not None:
                dispatch.attributes["error"] = error
            dispatch.start = start_wall
            dispatch.duration = elapsed
            parent.tracer.record(dispatch)
