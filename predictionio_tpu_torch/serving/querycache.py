"""Generation-keyed serving query cache with in-flight coalescing.

A model generation is immutable between swaps (docs/training.md): two
identical queries against the same generation are pure recomputation.
:class:`QueryCache` exploits that with a byte-budgeted, sharded-lock
LRU keyed by ``(tenant, generation token, canonical query bytes)`` —
the generation token is the *primary* invalidation mechanism. Every
swap (``/reload``, canary promotion, rollback, trainer fold-in) bumps
the token, so stale entries die by key and age out of the LRU; an
explicit :meth:`QueryCache.flush` additionally drops them eagerly and
records a ``cache_flush`` timeline event per swap reason.

Counterpart of ``predictionio_tpu/serving/querycache.py``, copied: the port keeps
its own copy of this standard-library module, so the same inputs
and clock give the same decisions in both packages
(``tests/test_torch_querycache.py``).

Single-flight: concurrent identical misses coalesce onto ONE in-flight
computation. The first claimant becomes the *leader* (it computes and
consumes the one batcher slot); later claimants become *waiters* that
block on the leader's result with their OWN deadline — a waiter's
budget expiring detaches it without cancelling the leader. The leader
escalates to the highest criticality class among everyone waiting
(:meth:`Claim.criticality`). A leader failure propagates the real
error to all waiters and leaves the key un-poisoned: the next claimant
becomes a fresh leader.

Wire surface: responses carry ``X-PIO-Cache: hit|miss|coalesced``
(:data:`CACHE_HEADER`); a request ``Cache-Control: no-cache`` bypasses
the cache (read-your-writes escape hatch — canary shadow scoring uses
it so the gate never scores a cached answer against a fresh one). Env
knobs (documented in docs/serving.md): ``PIO_CACHE``,
``PIO_CACHE_BUDGET_BYTES``, ``PIO_CACHE_TTL_S``, ``PIO_CACHE_SHARDS``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable

from predictionio_tpu_torch.obs import timeline as timeline_mod
from predictionio_tpu_torch.serving import admission
from predictionio_tpu_torch.serving.canary import strip_volatile

logger = logging.getLogger(__name__)

#: response header naming how the answer was produced: ``hit`` (served
#: from the cache), ``miss`` (computed, now cached), ``coalesced``
#: (this request waited on another request's identical computation).
#: The router forwards it unchanged (docs/scale_out.md wire contract).
CACHE_HEADER = "X-PIO-Cache"

#: request header whose ``no-cache`` / ``no-store`` directives bypass
#: the cache entirely (standard HTTP spelling; documentation-only in
#: the wire-contract table since it is not an X-PIO-* extension).
CACHE_CONTROL_HEADER = "Cache-Control"

#: accounting overhead per resident entry (key tuple, OrderedDict
#: node, Entry object) so a flood of tiny entries still hits the
#: byte budget.
ENTRY_OVERHEAD_BYTES = 256

_DEFAULT_BUDGET_BYTES = 64 << 20  # 64 MiB
_DEFAULT_SHARDS = 8

#: evictions within PRESSURE_WINDOW_S that count as a budget-driven
#: eviction *burst*, emitted as one rate-limited ``cache_pressure``
#: timeline event.
PRESSURE_WINDOW_S = 10.0
PRESSURE_BURST = 64
_PRESSURE_EVENT_MIN_GAP_S = 30.0

_RANK_TO_CLASS = {rank: cls for cls, rank in admission.CLASS_RANK.items()}


def canonical_query_bytes(query: Any) -> bytes:
    """Canonical cache-key bytes for a JSON query: volatile provenance
    fields stripped (same set the canary gate strips), keys sorted,
    separators minimal — so semantically identical queries share one
    cache entry regardless of key order on the wire."""
    return json.dumps(
        strip_volatile(query), sort_keys=True,
        separators=(",", ":"), default=str,
    ).encode("utf-8")


def default_budget_bytes() -> int:
    """Cache byte budget from ``PIO_CACHE_BUDGET_BYTES`` (default
    64 MiB); malformed values warn and fall back."""
    raw = os.environ.get("PIO_CACHE_BUDGET_BYTES", "")
    if not raw:
        return _DEFAULT_BUDGET_BYTES
    try:
        budget = int(raw)
        if budget <= 0:
            raise ValueError(raw)
        return budget
    except ValueError:
        logger.warning(
            "ignoring malformed PIO_CACHE_BUDGET_BYTES=%r; using %d",
            raw, _DEFAULT_BUDGET_BYTES,
        )
        return _DEFAULT_BUDGET_BYTES


def cache_enabled_from_env() -> bool:
    """The serving cache is opt-in: ``PIO_CACHE=1`` (any truthy value)
    or an explicit ``PIO_CACHE_BUDGET_BYTES`` turns it on."""
    flag = os.environ.get("PIO_CACHE", "").strip().lower()
    if flag in ("1", "true", "yes", "on"):
        return True
    if flag in ("0", "false", "no", "off"):
        return False
    return bool(os.environ.get("PIO_CACHE_BUDGET_BYTES", ""))


def _ttl_from_env() -> float | None:
    raw = os.environ.get("PIO_CACHE_TTL_S", "")
    if not raw:
        return None
    try:
        ttl = float(raw)
        if ttl <= 0:
            raise ValueError(raw)
        return ttl
    except ValueError:
        logger.warning("ignoring malformed PIO_CACHE_TTL_S=%r", raw)
        return None


def _shards_from_env() -> int:
    raw = os.environ.get("PIO_CACHE_SHARDS", "")
    if not raw:
        return _DEFAULT_SHARDS
    try:
        shards = int(raw)
        if shards <= 0:
            raise ValueError(raw)
        return shards
    except ValueError:
        logger.warning(
            "ignoring malformed PIO_CACHE_SHARDS=%r; using %d",
            raw, _DEFAULT_SHARDS,
        )
        return _DEFAULT_SHARDS


class LeaderFailed(RuntimeError):
    """The in-flight leader this waiter coalesced onto raised. Carries
    the leader's real exception as ``__cause__`` so the waiter can
    surface the same error the leader saw (the cache is NOT poisoned —
    the failed key is cleared and the next claimant leads afresh)."""


class _InFlight:
    """One leader computation plus its waiters, per cache key."""

    __slots__ = ("done", "value", "error", "max_rank", "waiters")

    def __init__(self, rank: int) -> None:
        self.done = threading.Event()
        self.value: bytes | None = None
        self.error: BaseException | None = None
        self.max_rank = rank
        self.waiters = 0


class _Entry:
    __slots__ = ("value", "nbytes", "expires_at")

    def __init__(self, value: bytes, nbytes: int,
                 expires_at: float | None) -> None:
        self.value = value
        self.nbytes = nbytes
        self.expires_at = expires_at


class _Shard:
    __slots__ = ("lock", "entries", "inflight", "resident")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self.inflight: dict[tuple, _InFlight] = {}
        self.resident = 0


class Claim:
    """Outcome of :meth:`QueryCache.claim` for one request.

    Exactly one of three states:

    - ``hit``   — :attr:`value` holds the cached response bytes;
    - ``leader``— this request must compute, then :meth:`QueryCache.fill`
      or :meth:`QueryCache.abort`;
    - waiter    — call :meth:`QueryCache.join` to block (with the
      waiter's own deadline) on the leader's result.
    """

    __slots__ = ("key", "tenant", "hit", "leader", "value", "flight",
                 "flush_seq", "nbytes")

    def __init__(self, key: tuple, tenant: str, *, hit: bool,
                 leader: bool, value: bytes | None,
                 flight: _InFlight | None, flush_seq: int) -> None:
        self.key = key
        self.tenant = tenant
        self.hit = hit
        self.leader = leader
        self.value = value
        self.flight = flight
        self.flush_seq = flush_seq
        self.nbytes = 0

    def criticality(self) -> str:
        """Highest criticality class among the leader and every waiter
        coalesced so far — the leader submits its one batcher slot at
        this class so a CRITICAL waiter is never starved behind a
        SHEDDABLE leader."""
        if self.flight is None:
            return admission.DEFAULT
        return _RANK_TO_CLASS.get(self.flight.max_rank, admission.DEFAULT)


class WaiterTimeout(TimeoutError):
    """This waiter's own deadline expired before the leader finished.
    The waiter detaches; the leader keeps computing for everyone else."""


class QueryCache:
    """Byte-budgeted sharded-lock LRU of serialized responses plus the
    single-flight table. Thread-safe; shard locks are held only for
    dict bookkeeping (never across compute or waits)."""

    def __init__(
        self,
        budget_bytes: int | None = None,
        *,
        shards: int | None = None,
        ttl_s: float | None = None,
        registry=None,
        timeline: timeline_mod.Timeline | None = None,
        pressure_burst: int = PRESSURE_BURST,
        pressure_window_s: float = PRESSURE_WINDOW_S,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._budget = (
            budget_bytes if budget_bytes is not None
            else default_budget_bytes()
        )
        n_shards = shards if shards is not None else _shards_from_env()
        self._shards = [_Shard() for _ in range(max(1, n_shards))]
        self._shard_budget = max(1, self._budget // len(self._shards))
        self._ttl = ttl_s if ttl_s is not None else _ttl_from_env()
        self._clock = clock
        self._timeline = timeline
        # per-tenant flush sequence: a fill() whose claim predates the
        # tenant's latest flush is dropped instead of resurrecting an
        # entry the flush was meant to kill (waiters still get the
        # value — only the LRU insert is skipped).
        self._flush_lock = threading.Lock()
        self._flush_seq: dict[str, int] = {}
        # eviction-burst detection for the cache_pressure event
        self._pressure_lock = threading.Lock()
        self._pressure_burst = max(1, pressure_burst)
        self._pressure_window = pressure_window_s
        self._pressure_evictions: list[float] = []
        self._last_pressure_event = -float("inf")
        self._hits = self._misses = self._coalesced = None
        self._evictions = None
        if registry is not None:
            self._hits = registry.counter(
                "pio_cache_hits_total",
                "Serving-cache lookups answered from a resident entry "
                "(no batcher slot consumed)",
                ("tenant",),
            )
            self._misses = registry.counter(
                "pio_cache_misses_total",
                "Serving-cache lookups that led the computation "
                "(one batcher slot)",
                ("tenant",),
            )
            self._coalesced = registry.counter(
                "pio_cache_coalesced_total",
                "Serving-cache lookups coalesced onto another "
                "request's identical in-flight computation",
                ("tenant",),
            )
            self._evictions = registry.counter(
                "pio_cache_evictions_total",
                "Serving-cache entries evicted to fit the byte budget",
                ("tenant",),
            )
            registry.gauge(
                "pio_cache_budget_bytes",
                "Serving-cache byte budget",
            ).set(float(self._budget))
            registry.gauge(
                "pio_cache_resident_bytes",
                "Bytes of serialized responses resident in the "
                "serving cache",
            ).set_function(lambda: float(self.resident_bytes()))
            registry.gauge(
                "pio_cache_inflight",
                "Coalesced in-flight computations (leaders) currently "
                "outstanding",
            ).set_function(lambda: float(self.inflight()))

    # -- introspection ---------------------------------------------------

    @property
    def budget_bytes(self) -> int:
        return self._budget

    def resident_bytes(self) -> int:
        return sum(s.resident for s in self._shards)

    def inflight(self) -> int:
        total = 0
        for s in self._shards:
            with s.lock:
                total += len(s.inflight)
        return total

    def __len__(self) -> int:
        return sum(len(s.entries) for s in self._shards)

    def stats(self) -> dict:
        entries = waiters = 0
        for s in self._shards:
            with s.lock:
                entries += len(s.entries)
                waiters += sum(f.waiters for f in s.inflight.values())
        return {
            "budgetBytes": self._budget,
            "residentBytes": self.resident_bytes(),
            "entries": entries,
            "inflight": self.inflight(),
            "waiters": waiters,
            "shards": len(self._shards),
            "ttlS": self._ttl,
        }

    # -- internals -------------------------------------------------------

    def _shard_for(self, key: tuple) -> _Shard:
        return self._shards[hash(key) % len(self._shards)]

    def _tenant_flush_seq(self, tenant: str) -> int:
        with self._flush_lock:
            return self._flush_seq.get(tenant, 0)

    def _count(self, counter, tenant: str) -> None:
        if counter is not None:
            counter.labels(tenant).inc()

    def _expired(self, entry: _Entry, now: float) -> bool:
        return entry.expires_at is not None and now >= entry.expires_at

    def _evict_locked(self, shard: _Shard, evicted: list[tuple]) -> None:
        """Pop LRU entries until the shard fits its budget slice.
        Caller holds ``shard.lock``; metric/timeline work happens
        outside via the returned keys."""
        while shard.resident > self._shard_budget and shard.entries:
            key, entry = shard.entries.popitem(last=False)
            shard.resident -= entry.nbytes
            evicted.append(key)

    def _note_evictions(self, evicted: list[tuple]) -> None:
        if not evicted:
            return
        for key in evicted:
            self._count(self._evictions, key[0])
        now = self._clock()
        emit_burst = 0
        with self._pressure_lock:
            window = self._pressure_evictions
            window.extend([now] * len(evicted))
            cutoff = now - self._pressure_window
            while window and window[0] < cutoff:
                window.pop(0)
            if (
                len(window) >= self._pressure_burst
                and now - self._last_pressure_event
                >= _PRESSURE_EVENT_MIN_GAP_S
            ):
                self._last_pressure_event = now
                emit_burst = len(window)
        if emit_burst and self._timeline is not None:
            self._timeline.record(
                "cache_pressure",
                f"serving-cache eviction burst: {emit_burst} evictions "
                f"in {self._pressure_window:.0f}s (budget "
                f"{self._budget} bytes)",
                severity=timeline_mod.WARN,
                evictions=emit_burst,
                windowS=self._pressure_window,
                budgetBytes=self._budget,
            )

    # -- the claim protocol ---------------------------------------------

    def claim(self, tenant: str, generation: str,
              canonical: bytes) -> Claim:
        """Resolve one lookup: a hit (``claim.value`` is the response
        bytes), leadership (compute, then ``fill``/``abort``), or a
        wait ticket (``join``). Registers this request's criticality
        class toward the in-flight maximum either way."""
        key = (tenant, generation, canonical)
        rank = admission.CLASS_RANK.get(
            admission.get_criticality(), admission.CLASS_RANK[admission.DEFAULT]
        )
        flush_seq = self._tenant_flush_seq(tenant)
        shard = self._shard_for(key)
        now = self._clock()
        with shard.lock:
            entry = shard.entries.get(key)
            if entry is not None:
                if self._expired(entry, now):
                    del shard.entries[key]
                    shard.resident -= entry.nbytes
                else:
                    shard.entries.move_to_end(key)
                    self._count(self._hits, tenant)
                    return Claim(
                        key, tenant, hit=True, leader=False,
                        value=entry.value, flight=None,
                        flush_seq=flush_seq,
                    )
            flight = shard.inflight.get(key)
            if flight is not None:
                flight.max_rank = max(flight.max_rank, rank)
                flight.waiters += 1
                self._count(self._coalesced, tenant)
                return Claim(
                    key, tenant, hit=False, leader=False, value=None,
                    flight=flight, flush_seq=flush_seq,
                )
            flight = _InFlight(rank)
            shard.inflight[key] = flight
            self._count(self._misses, tenant)
            return Claim(
                key, tenant, hit=False, leader=True, value=None,
                flight=flight, flush_seq=flush_seq,
            )

    def fill(self, claim: Claim, value: bytes) -> None:
        """Leader completed: publish ``value`` to every waiter and (if
        the tenant has not been flushed since the claim) insert it into
        the LRU under the byte budget."""
        shard = self._shard_for(claim.key)
        nbytes = (
            len(value) + len(claim.key[2]) + ENTRY_OVERHEAD_BYTES
        )
        claim.nbytes = nbytes
        expires = (
            self._clock() + self._ttl if self._ttl is not None else None
        )
        stale = claim.flush_seq != self._tenant_flush_seq(claim.tenant)
        evicted: list[tuple] = []
        with shard.lock:
            flight = shard.inflight.pop(claim.key, None)
            if not stale and nbytes <= self._shard_budget:
                old = shard.entries.pop(claim.key, None)
                if old is not None:
                    shard.resident -= old.nbytes
                shard.entries[claim.key] = _Entry(value, nbytes, expires)
                shard.resident += nbytes
                self._evict_locked(shard, evicted)
        if flight is not None:
            flight.value = value
            flight.done.set()
        self._note_evictions(evicted)

    def abort(self, claim: Claim, error: BaseException) -> None:
        """Leader failed: clear the in-flight slot (no poisoning — the
        next claimant leads afresh) and propagate the real error to
        every waiter."""
        shard = self._shard_for(claim.key)
        with shard.lock:
            flight = shard.inflight.pop(claim.key, None)
        if flight is not None:
            flight.error = error
            flight.done.set()

    def join(self, claim: Claim, timeout_s: float | None) -> bytes:
        """Waiter path: block until the leader finishes or THIS
        waiter's own budget expires. Raises :class:`WaiterTimeout` on
        own-deadline expiry (the leader is untouched) or
        :class:`LeaderFailed` (chaining the leader's real exception)."""
        flight = claim.flight
        if flight is None or claim.leader:
            raise RuntimeError("join() is only valid on a waiter claim")
        finished = flight.done.wait(timeout_s)
        shard = self._shard_for(claim.key)
        with shard.lock:
            flight.waiters -= 1
        if not finished:
            raise WaiterTimeout(
                f"waiter deadline ({timeout_s}s) expired before the "
                "coalesced leader finished"
            )
        if flight.error is not None:
            raise LeaderFailed(
                "coalesced leader failed"
            ) from flight.error
        assert flight.value is not None
        return flight.value

    # -- invalidation ----------------------------------------------------

    def flush(self, tenant: str | None = None, *, reason: str,
              generation: str | None = None) -> int:
        """Eagerly drop entries (all tenants when ``tenant`` is None)
        and bump the tenant flush sequence so in-flight fills of
        pre-flush claims cannot resurrect them. Records one
        ``cache_flush{reason}`` timeline event. Returns entries
        dropped. In-flight computations are left to finish — their
        waiters still get answers; only the LRU insert is suppressed."""
        dropped = 0
        with self._flush_lock:
            if tenant is None:
                for t in list(self._flush_seq):
                    self._flush_seq[t] += 1
                self._flush_seq[""] = self._flush_seq.get("", 0) + 1
            else:
                self._flush_seq[tenant] = (
                    self._flush_seq.get(tenant, 0) + 1
                )
        for shard in self._shards:
            with shard.lock:
                if tenant is None:
                    dropped += len(shard.entries)
                    shard.entries.clear()
                    shard.resident = 0
                else:
                    doomed = [
                        k for k in shard.entries if k[0] == tenant
                    ]
                    for k in doomed:
                        shard.resident -= shard.entries.pop(k).nbytes
                    dropped += len(doomed)
        if self._timeline is not None:
            self._timeline.record(
                "cache_flush",
                f"serving cache flushed ({reason}): {dropped} entries "
                + (f"for tenant {tenant!r} " if tenant else "")
                + (f"generation {generation} " if generation else "")
                + "invalidated",
                tenant=tenant or "",
                generation=generation or "",
                reason=reason,
                dropped=dropped,
            )
        return dropped

    def close(self) -> None:
        """Release every entry and fail any in-flight waiters (server
        shutdown)."""
        for shard in self._shards:
            with shard.lock:
                shard.entries.clear()
                shard.resident = 0
                flights = list(shard.inflight.values())
                shard.inflight.clear()
            for flight in flights:
                flight.error = RuntimeError("query cache closed")
                flight.done.set()
