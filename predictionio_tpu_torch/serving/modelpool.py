"""Byte-budgeted device-resident model pool for multi-tenant serving.

Counterpart of ``predictionio_tpu/serving/modelpool.py``: one engine
server process holds many tenants' (quantized) factor tables on one
card. The pool is the residency authority:

* **budget** — explicit bytes, ``PIO_POOL_BUDGET_BYTES``, or a
  fraction (``PIO_POOL_HBM_FRACTION``, default 0.5) of the smallest
  card's memory as :func:`predictionio_tpu_torch.obs.device.sample_devices`
  reads it (``torch.cuda.mem_get_info``); without CUDA a fixed 256 MiB,
  so tests see real evictions.
* **LRU + pinning** — a request pins its tenant's entry for the life
  of the query (submit through collect); eviction only takes unpinned
  entries, so no launch still in flight can read a freed table. A
  ``/reload`` replace retires the old generation and closes it when its
  last pin drains.
* **cold loads off the hot path** — a miss queues a single-flight load
  on the pool's one loader thread (host load, staging on the card,
  quantization and warm-up run there); request threads wait on the
  load with a deadline, and concurrent requests for one tenant share
  one load.
* **per-tenant metrics** — ``pio_pool_hits_total`` /
  ``pio_pool_misses_total`` / ``pio_pool_evictions_total`` /
  ``pio_pool_resident_bytes`` / ``pio_tenant_resident_byte_seconds_total``
  plus pool-wide ``pio_pool_budget_bytes`` / ``pio_pool_tenants_resident``,
  and ``pool_*`` timeline events.

The pool stores opaque values. A loader returns ``(value, nbytes,
close_fn)``: whoever loaded knows how many device bytes it committed and
how to release them. After ``close_fn`` the pool drops its reference to
the value, so the tensors it held are freed (the caching allocator keeps
the blocks for reuse; nothing here calls ``torch.cuda.empty_cache``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
import time
from typing import Callable

from predictionio_tpu_torch.obs import timeline as timeline_mod

logger = logging.getLogger(__name__)

#: default budget when neither env nor a card's memory is available
#: (the CPU) — small enough that tests see real evictions
_DEFAULT_BUDGET_BYTES = 256 * 1024 * 1024
_DEFAULT_HBM_FRACTION = 0.5

#: loader returns (value, device-bytes-committed, close-fn)
Loader = Callable[[], tuple[object, int, Callable[[], None] | None]]


class PoolLoadError(RuntimeError):
    """The tenant's loader raised; the cause is chained."""


class PoolLoadTimeout(TimeoutError):
    """Waiting on a cold load exceeded the caller's deadline."""


def default_budget_bytes() -> int:
    """Resolve the pool byte budget: ``PIO_POOL_BUDGET_BYTES`` wins;
    else ``PIO_POOL_HBM_FRACTION`` (default 0.5) of the smallest
    card's memory (``torch.cuda.mem_get_info``); else a fixed CPU
    default."""
    raw = os.environ.get("PIO_POOL_BUDGET_BYTES")
    if raw and raw.strip():
        try:
            return max(1, int(raw))
        except ValueError:
            logger.warning(
                "ignoring non-integer PIO_POOL_BUDGET_BYTES=%r", raw
            )
    fraction = _DEFAULT_HBM_FRACTION
    raw = os.environ.get("PIO_POOL_HBM_FRACTION")
    if raw and raw.strip():
        try:
            fraction = min(1.0, max(0.01, float(raw)))
        except ValueError:
            logger.warning(
                "ignoring non-float PIO_POOL_HBM_FRACTION=%r", raw
            )
    try:
        from predictionio_tpu_torch.obs.device import sample_devices

        limits = [
            d["limit"]
            for d in (sample_devices().get("devices") or {}).values()
            if d.get("limit")
        ]
    except Exception:
        limits = []
    if limits:
        return max(1, int(min(limits) * fraction))
    return _DEFAULT_BUDGET_BYTES


class _Entry:
    __slots__ = (
        "tenant", "value", "nbytes", "close_fn", "pins", "last_used",
        "retired", "hits", "charged_mono",
    )

    def __init__(self, tenant, value, nbytes, close_fn, last_used):
        self.tenant = tenant
        self.value = value
        self.nbytes = int(nbytes)
        self.close_fn = close_fn
        self.pins = 0
        self.last_used = last_used
        self.retired = False
        self.hits = 0
        #: residency charged up to this monotonic stamp — cost
        #: attribution charges elapsed x nbytes at every transition
        self.charged_mono = last_used


class _Load:
    __slots__ = ("tenant", "loader", "done", "error")

    def __init__(self, tenant, loader):
        self.tenant = tenant
        self.loader = loader
        self.done = threading.Event()
        self.error: BaseException | None = None


class _Close:
    __slots__ = ("entry",)

    def __init__(self, entry):
        self.entry = entry


_STOP = object()


class ModelPool:
    """LRU pool of device-resident per-tenant values under one byte
    budget. Thread-safe; all loads and closes run on the pool's single
    loader thread so device staging never blocks request threads on
    each other."""

    def __init__(
        self,
        budget_bytes: int | None = None,
        *,
        registry=None,
        timeline: "timeline_mod.Timeline | None" = None,
    ) -> None:
        self._budget = (
            int(budget_bytes)
            if budget_bytes is not None
            else default_budget_bytes()
        )
        if self._budget <= 0:
            raise ValueError(f"pool budget must be > 0: {self._budget}")
        self._lock = threading.Lock()
        self._entries: dict[str, _Entry] = {}
        self._loading: dict[str, _Load] = {}
        self._resident_bytes = 0  # includes retired-but-pinned bytes
        self._evictions = 0
        self._closed = False
        self._jobs: queue.Queue = queue.Queue()
        # non-daemon on purpose: joined in close(), which owners call
        # from their own teardown (thread-lifecycle rule)
        self._worker = threading.Thread(
            target=self._run, name="pio-pool-loader"
        )
        self._worker.start()
        self._hits = self._misses = self._evicted = None
        self._resident_gauge = None
        self._byte_seconds = None
        self._timeline = timeline
        if registry is not None:
            self._hits = registry.counter(
                "pio_pool_hits_total",
                "Model-pool lookups served by a resident entry",
                ("tenant",),
            )
            self._misses = registry.counter(
                "pio_pool_misses_total",
                "Model-pool lookups that triggered a cold load",
                ("tenant",),
            )
            self._evicted = registry.counter(
                "pio_pool_evictions_total",
                "Model-pool entries evicted to fit the byte budget",
                ("tenant",),
            )
            self._resident_gauge = registry.gauge(
                "pio_pool_resident_bytes",
                "Device bytes a tenant's pooled model holds (0 after "
                "eviction)",
                ("tenant",),
            )
            self._byte_seconds = registry.counter(
                "pio_tenant_resident_byte_seconds_total",
                "HBM residency charged to the tenant: bytes x seconds "
                "resident, accrued at touch/evict/replace/close "
                "transitions and at stats() snapshots",
                ("tenant",),
            )
            registry.gauge(
                "pio_pool_budget_bytes",
                "Model-pool device byte budget",
            ).set(float(self._budget))
            registry.gauge(
                "pio_pool_tenants_resident",
                "Tenants currently resident in the model pool",
            ).set_function(lambda: float(len(self._entries)))

    @property
    def budget_bytes(self) -> int:
        return self._budget

    def _charge(self, entry, now: float | None = None) -> None:
        """Accrue the entry's residency since its last charge (bytes x
        seconds) to the tenant. The stamp advances with the charge, so
        overlapping charge sites (touch, evict, replace, close, stats)
        never double-count an interval."""
        if self._byte_seconds is None:
            return
        if now is None:
            now = time.monotonic()
        elapsed = now - entry.charged_mono
        if elapsed <= 0:
            return
        entry.charged_mono = now
        self._byte_seconds.labels(entry.tenant).inc(
            elapsed * entry.nbytes
        )

    def _emit(self, kind, message, *, severity=timeline_mod.INFO,
              tenant="", **fields) -> None:
        """Record a pool lifecycle event; a deque append, safe under
        the pool lock."""
        if self._timeline is not None:
            self._timeline.record(
                kind, message, severity=severity, tenant=tenant,
                **fields,
            )

    # -- hot path ----------------------------------------------------------

    @contextlib.contextmanager
    def pin(self, tenant: str, loader: Loader, timeout: float | None = None):
        """Context manager yielding the tenant's resident value, pinned
        for the duration (pinned entries are never closed under an
        in-flight request). A miss blocks on the single-flight cold
        load up to ``timeout`` seconds."""
        entry = self._acquire(tenant, loader, timeout)
        try:
            yield entry.value
        finally:
            self._unpin(entry)

    def _acquire(self, tenant, loader, timeout):
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        first_pass = True
        while True:
            load = None
            with self._lock:
                if self._closed:
                    raise RuntimeError("model pool is closed")
                entry = self._entries.get(tenant)
                if entry is not None:
                    entry.pins += 1
                    entry.last_used = time.monotonic()
                    self._charge(entry, entry.last_used)
                    if first_pass:
                        entry.hits += 1
                else:
                    load = self._loading.get(tenant)
                    if load is None:
                        load = _Load(tenant, loader)
                        self._loading[tenant] = load
                        self._jobs.put(load)
            if entry is not None:
                # a lookup is a hit or a miss once, on its first pass —
                # the pin taken after waiting out a cold load is the
                # same miss, not a new hit
                if first_pass and self._hits is not None:
                    self._hits.labels(tenant).inc()
                return entry
            if first_pass and self._misses is not None:
                self._misses.labels(tenant).inc()
            first_pass = False
            remaining = (
                None
                if deadline is None
                else deadline - time.monotonic()
            )
            if remaining is not None and remaining <= 0:
                self._emit(
                    "pool_load_timeout",
                    f"cold load for tenant {tenant!r} missed the "
                    "caller's deadline",
                    severity=timeline_mod.ERROR, tenant=tenant,
                )
                raise PoolLoadTimeout(
                    f"timed out waiting for tenant {tenant!r} to load"
                )
            if not load.done.wait(remaining):
                self._emit(
                    "pool_load_timeout",
                    f"cold load for tenant {tenant!r} missed the "
                    "caller's deadline",
                    severity=timeline_mod.ERROR, tenant=tenant,
                )
                raise PoolLoadTimeout(
                    f"timed out waiting for tenant {tenant!r} to load"
                )
            if load.error is not None:
                raise PoolLoadError(
                    f"loading tenant {tenant!r} failed: {load.error}"
                ) from load.error
            # loop: the freshly inserted entry is pinned on the next
            # pass (or, under extreme pressure, re-loaded)

    def _unpin(self, entry) -> None:
        close = False
        with self._lock:
            entry.pins -= 1
            close = entry.retired and entry.pins == 0
        if close:
            self._jobs.put(_Close(entry))

    # -- lifecycle (loader thread) ----------------------------------------

    def _run(self) -> None:
        while True:
            job = self._jobs.get()
            if job is _STOP:
                break
            if isinstance(job, _Close):
                self._close_entry(job.entry)
                continue
            self._do_load(job)

    def _do_load(self, load: _Load) -> None:
        try:
            value, nbytes, close_fn = load.loader()
        except BaseException as exc:  # surfaced to every waiter
            with self._lock:
                self._loading.pop(load.tenant, None)
            self._emit(
                "pool_load_failed",
                f"cold load for tenant {load.tenant!r} failed: "
                f"{type(exc).__name__}: {exc}",
                severity=timeline_mod.ERROR, tenant=load.tenant,
            )
            load.error = exc
            load.done.set()
            return
        entry = _Entry(
            load.tenant, value, nbytes, close_fn, time.monotonic()
        )
        to_close: list[_Entry] = []
        with self._lock:
            self._evict_for_locked(entry.nbytes, to_close)
            old = self._entries.get(load.tenant)
            if old is not None:  # a replace raced us; retire it
                self._retire_locked(old, to_close)
            self._entries[load.tenant] = entry
            self._resident_bytes += entry.nbytes
            self._loading.pop(load.tenant, None)
        if self._resident_gauge is not None:
            self._resident_gauge.labels(load.tenant).set(
                float(entry.nbytes)
            )
        for stale in to_close:
            self._close_entry(stale)
        with self._lock:
            resident = self._resident_bytes
        if resident > self._budget:
            logger.warning(
                "model pool over budget (%d resident > %d budget): "
                "every other tenant is pinned",
                resident, self._budget,
            )
        load.done.set()

    def _evict_for_locked(self, incoming: int, to_close: list) -> None:
        """Pop LRU *unpinned* entries until ``incoming`` fits the
        budget (caller holds the lock; closes happen after release).
        Victims' bytes count as reclaimed immediately — they are
        already queued for close — so one oversized insert never
        cascades into evicting more than it needs."""
        reclaimed = sum(e.nbytes for e in to_close)
        while self._resident_bytes - reclaimed + incoming > self._budget:
            victims = [
                e for e in self._entries.values() if e.pins == 0
            ]
            if not victims:
                return  # everything pinned: overcommit, warned above
            victim = min(victims, key=lambda e: e.last_used)
            del self._entries[victim.tenant]
            victim.retired = True
            to_close.append(victim)
            reclaimed += victim.nbytes
            self._evictions += 1
            self._charge(victim)
            self._emit(
                "pool_eviction",
                f"evicted tenant {victim.tenant!r} "
                f"({victim.nbytes} bytes) to fit the byte budget",
                severity=timeline_mod.WARN, tenant=victim.tenant,
            )
            if self._evicted is not None:
                self._evicted.labels(victim.tenant).inc()
            if self._resident_gauge is not None:
                self._resident_gauge.labels(victim.tenant).set(0.0)

    def _retire_locked(self, entry, to_close: list) -> None:
        self._charge(entry)
        entry.retired = True
        if entry.pins == 0:
            to_close.append(entry)

    def _close_entry(self, entry) -> None:
        try:
            if entry.close_fn is not None:
                entry.close_fn()
        except Exception:
            logger.exception(
                "closing pooled model for tenant %r failed",
                entry.tenant,
            )
        # the closed value's tensors must not outlive the close: a
        # retired entry can stay referenced (a stale pin context, a
        # queued job), and the card's bytes are what the budget counts
        entry.value = None
        with self._lock:
            # the retired-but-pinned tail still held HBM: charge it
            # through to the actual close
            self._charge(entry)
            self._resident_bytes -= entry.nbytes

    # -- management --------------------------------------------------------

    def evict(self, tenant: str) -> bool:
        """Drop a tenant now if it is resident and unpinned. Returns
        True when evicted."""
        with self._lock:
            entry = self._entries.get(tenant)
            if entry is None or entry.pins > 0:
                return False
            del self._entries[tenant]
            entry.retired = True
            self._evictions += 1
            self._charge(entry)
        self._emit(
            "pool_eviction",
            f"explicit evict of tenant {tenant!r} "
            f"({entry.nbytes} bytes)",
            severity=timeline_mod.WARN, tenant=tenant,
        )
        if self._evicted is not None:
            self._evicted.labels(tenant).inc()
        if self._resident_gauge is not None:
            self._resident_gauge.labels(tenant).set(0.0)
        self._jobs.put(_Close(entry))
        return True

    def replace(self, tenant: str, loader: Loader) -> None:
        """Load a NEW value for ``tenant`` (on the calling thread — the
        ``/reload`` admin path, not a request thread) and swap it in.
        The old entry closes immediately when unpinned, else when its
        last in-flight request drains — a reload never yanks a model
        out from under a query."""
        value, nbytes, close_fn = loader()
        entry = _Entry(tenant, value, nbytes, close_fn, time.monotonic())
        to_close: list[_Entry] = []
        with self._lock:
            if self._closed:
                raise RuntimeError("model pool is closed")
            old = self._entries.get(tenant)
            if old is not None:
                self._retire_locked(old, to_close)
                del self._entries[tenant]
            self._evict_for_locked(entry.nbytes, to_close)
            self._entries[tenant] = entry
            self._resident_bytes += entry.nbytes
        if self._resident_gauge is not None:
            self._resident_gauge.labels(tenant).set(float(entry.nbytes))
        for stale in to_close:
            self._jobs.put(_Close(stale))

    def resident(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def stats(self) -> dict:
        """Status-route snapshot: budget, resident bytes, per-tenant
        residency (the CLI pool line renders the metric twins)."""
        with self._lock:
            # settle residency on every snapshot so a long-idle
            # resident keeps accruing byte-seconds between touches
            now = time.monotonic()
            for e in self._entries.values():
                self._charge(e, now)
            tenants = {
                t: {
                    "residentBytes": e.nbytes,
                    "pins": e.pins,
                    "hits": e.hits,
                }
                for t, e in self._entries.items()
            }
            return {
                "budgetBytes": self._budget,
                "residentBytes": self._resident_bytes,
                "tenantsResident": len(tenants),
                "evictions": self._evictions,
                "tenants": tenants,
            }

    def close(self) -> None:
        """Stop the loader thread and close every entry (pinned or
        not — process teardown)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            entries = list(self._entries.values())
            self._entries.clear()
        self._jobs.put(_STOP)
        self._worker.join(timeout=30.0)
        for entry in entries:
            self._close_entry(entry)
