"""Adaptive overload control plane for the serving tier.

A fixed batcher queue bound (shed at a static depth) and a hardcoded
``Retry-After: 1`` let a saturated server's tail latency grow while
its goodput stays flat. This module is the layer the
TensorFlow-Serving production experience calls the thing that keeps a
fleet alive: graceful degradation under overload, not raw peak QPS.
Three coordinated mechanisms, wired through
:mod:`~predictionio_tpu_torch.serving.http`, the engine/event servers, the
micro-batcher, :mod:`~predictionio_tpu_torch.serving.router`, and
:mod:`~predictionio_tpu_torch.client`:

Counterpart of ``predictionio_tpu/serving/admission.py``, copied: the port keeps
its own copy of this standard-library module, so the same inputs
and clock give the same decisions in both packages
(``tests/test_torch_admission.py``).

* **Adaptive concurrency limiting** — :class:`GradientLimiter`, a
  Vegas/gradient-style limit per server: observed latency (EWMA) is
  compared against a windowed-minimum baseline; when latency inflates
  past ``tolerance`` × baseline the limit shrinks toward measured
  capacity, and deadline misses / downstream sheds apply an AIMD
  multiplicative decrease. The limit follows what the hardware can
  actually serve instead of a static queue depth
  (``pio_admission_limit`` / ``pio_admission_inflight`` gauges).
* **Criticality classes** — requests carry
  ``X-PIO-Criticality: critical|default|sheddable`` (propagated across
  hops like ``X-PIO-Deadline``). Under pressure the lowest class sheds
  first: each class is admitted only while in-flight work is below its
  fraction of the live limit, so ``sheddable`` traffic absorbs the
  first wave of overload and ``critical`` traffic keeps its tail.
* **Per-tenant fair share** — keyed by access key / app (or the
  ``X-PIO-Tenant`` header): once the server is under pressure, a
  tenant holding more than its share of the limit is refused (429)
  before it can starve the rest. ``critical`` work is exempt.

Rejections raise :class:`AdmissionRejected` carrying a computed
``Retry-After`` derived from the live latency/limit state — the
cooperative-backpressure hint :mod:`~predictionio_tpu_torch.client` honors
and the router uses to treat a saturated replica as soft-unhealthy.

Env knobs (all optional; docs/robustness.md "Overload & backpressure"):

* ``PIO_ADMISSION`` (1; 0 disables the controller entirely)
* ``PIO_ADMISSION_INITIAL`` (32), ``PIO_ADMISSION_MIN`` (4),
  ``PIO_ADMISSION_MAX`` (1024)
* ``PIO_ADMISSION_TOLERANCE`` (2.0), ``PIO_ADMISSION_SMOOTHING``
  (0.2), ``PIO_ADMISSION_DECREASE`` (0.9),
  ``PIO_ADMISSION_WINDOW_S`` (30)
* ``PIO_ADMISSION_FAIR_PRESSURE`` (0.75)
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable

from predictionio_tpu_torch.obs import MetricRegistry, get_registry
from predictionio_tpu_torch.obs.context import log_json

logger = logging.getLogger(__name__)

#: request criticality, propagated across hops like X-PIO-Deadline
CRITICALITY_HEADER = "X-PIO-Criticality"

#: explicit tenant key for fair-share accounting on servers whose API
#: has no access key (engine server, router); the event server keys
#: tenants by the ``accessKey`` query param
TENANT_HEADER = "X-PIO-Tenant"

#: set on shed responses that GUARANTEE the request was not processed
#: (refused at admission / at the batch queue, before any side effect)
#: — the condition under which even a non-idempotent POST replays
#: safely. A 503 WITHOUT this marker (e.g. a dependency's open breaker
#: surfacing mid-handler) may have partially run and must not be
#: replayed by method-unsafe callers.
SHED_HEADER = "X-PIO-Shed"

#: shed last: user-facing must-answer traffic (checkout, health-critical)
CRITICAL = "critical"
#: the implicit class of every unlabeled request
DEFAULT = "default"
#: shed first: batch backfill, prefetch, speculative work
SHEDDABLE = "sheddable"

#: shed order: lower rank sheds first
CLASS_RANK = {SHEDDABLE: 0, DEFAULT: 1, CRITICAL: 2}

#: fraction of the live limit each class may fill before it sheds —
#: as in-flight work climbs, sheddable refuses first, then default,
#: and critical keeps the full limit
CLASS_FRACTION = {SHEDDABLE: 0.6, DEFAULT: 0.85, CRITICAL: 1.0}


def parse_criticality(raw: str | None) -> str:
    """Header value → class name; absent or unrecognized → default
    (an unknown class from a newer client must not be silently
    promoted to critical, nor refused outright)."""
    if not raw:
        return DEFAULT
    value = raw.strip().lower()
    return value if value in CLASS_RANK else DEFAULT


_criticality: contextvars.ContextVar[str] = contextvars.ContextVar(
    "pio_criticality", default=DEFAULT
)


def set_criticality(value: str) -> None:
    """Install the request's class for the current context (the HTTP
    layer calls this once per request — unconditionally, so a stale
    class cannot leak into the next request on a reused keep-alive
    handler thread)."""
    _criticality.set(value if value in CLASS_RANK else DEFAULT)


def get_criticality() -> str:
    return _criticality.get()


@contextlib.contextmanager
def criticality(value: str):
    """Scope a criticality class over a block (client SDK sugar)."""
    token = _criticality.set(
        value if value in CLASS_RANK else DEFAULT
    )
    try:
        yield
    finally:
        _criticality.reset(token)


_tenant: contextvars.ContextVar[str] = contextvars.ContextVar(
    "pio_tenant", default=""
)


def set_tenant(value: str) -> None:
    """Install the request's tenant identity for the current context.
    Like :func:`set_criticality`, the HTTP layer calls this once per
    request — unconditionally, so a stale tenant cannot leak into the
    next request on a reused keep-alive handler thread. Empty string
    means "no tenant" (single-tenant servers, unkeyed traffic)."""
    _tenant.set(value or "")


def get_tenant() -> str:
    return _tenant.get()


@contextlib.contextmanager
def tenant(value: str):
    """Scope a tenant identity over a block (client SDK sugar)."""
    token = _tenant.set(value or "")
    try:
        yield
    finally:
        _tenant.reset(token)


def format_retry_after(seconds: float) -> str:
    """The Retry-After wire value: decimal seconds, two places, never
    below 0.05 (the contract documented in docs/robustness.md — our
    clients parse floats; sub-second hints matter at serving speed)."""
    return f"{max(0.05, seconds):.2f}"


def parse_retry_after(raw: str | None) -> float | None:
    """Parse a Retry-After header (decimal seconds). Malformed or
    non-finite → None; HTTP-date forms are not produced by this stack
    and parse as None."""
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        return None
    if not math.isfinite(value) or value < 0:
        return None
    return value


class AdmissionRejected(Exception):
    """The admission controller refused the request before any handler
    ran. ``status`` is 503 (over the adaptive limit) or 429 (over the
    tenant's fair share); ``retry_after_s`` is the computed
    backpressure hint."""

    def __init__(
        self,
        status: int,
        reason: str,
        criticality: str,
        retry_after_s: float,
    ):
        super().__init__(
            f"admission refused ({reason}, class={criticality})"
        )
        self.status = status
        self.reason = reason
        self.criticality = criticality
        self.retry_after_s = retry_after_s


@dataclass(frozen=True)
class AdmissionConfig:
    initial_limit: float = 32.0
    min_limit: float = 4.0
    max_limit: float = 1024.0
    tolerance: float = 2.0
    smoothing: float = 0.2
    decrease_ratio: float = 0.9
    baseline_window_s: float = 30.0
    #: in-flight fraction of the limit past which fair-share enforcement
    #: kicks in (below it, a hot tenant is harmless)
    fair_pressure: float = 0.75

    @classmethod
    def from_env(cls) -> "AdmissionConfig":
        from predictionio_tpu_torch.serving.resilience import _env_float

        return cls(
            initial_limit=max(
                1.0, _env_float("PIO_ADMISSION_INITIAL", 32.0)
            ),
            min_limit=max(1.0, _env_float("PIO_ADMISSION_MIN", 4.0)),
            max_limit=max(1.0, _env_float("PIO_ADMISSION_MAX", 1024.0)),
            tolerance=max(
                1.0, _env_float("PIO_ADMISSION_TOLERANCE", 2.0)
            ),
            smoothing=min(
                1.0, max(0.01, _env_float("PIO_ADMISSION_SMOOTHING", 0.2))
            ),
            decrease_ratio=min(
                0.99, max(0.1, _env_float("PIO_ADMISSION_DECREASE", 0.9))
            ),
            baseline_window_s=max(
                1.0, _env_float("PIO_ADMISSION_WINDOW_S", 30.0)
            ),
            fair_pressure=min(
                1.0, max(0.1, _env_float("PIO_ADMISSION_FAIR_PRESSURE", 0.75))
            ),
        )


class GradientLimiter:
    """Vegas/gradient-style adaptive concurrency limit.

    Tracks two latency signals: a short EWMA of observed request
    latency and a windowed-minimum baseline (two rotating buckets of
    ``baseline_window_s`` each — the no-queueing RTT the server showed
    recently). Each sample moves the limit toward
    ``limit * gradient + sqrt(limit)`` where
    ``gradient = clamp(tolerance * baseline / ewma, 0.5, 1.0)``: while
    latency stays within ``tolerance`` × baseline the limit climbs by
    its queue allowance; once queueing inflates latency past the
    tolerance band the limit shrinks toward measured capacity.

    :meth:`on_drop` is the AIMD backoff for explicit overload evidence
    (a deadline miss or a downstream shed): one multiplicative
    decrease, rate-limited to one per latency interval so a burst of
    sheds doesn't slam the limit to the floor in a single tick.

    NOT thread-safe by itself — the :class:`AdmissionController` calls
    it under its own lock.
    """

    def __init__(
        self,
        config: AdmissionConfig | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or AdmissionConfig()
        self._clock = clock
        self._limit = min(
            self.config.max_limit,
            max(self.config.min_limit, float(self.config.initial_limit)),
        )
        self._ewma = 0.0
        self._bucket_min = math.inf
        self._prev_bucket_min = math.inf
        self._bucket_started = clock()
        self._last_decrease = -math.inf
        #: samples accepted so far — lets tests (and the no-verdict
        #: contract: circuit-open fast-fails are NOT samples) assert
        #: exactly what fed the limiter
        self.samples = 0
        self.drops = 0

    @property
    def limit(self) -> float:
        return self._limit

    @property
    def latency_ewma_s(self) -> float:
        return self._ewma

    def baseline_s(self) -> float:
        """The windowed-min latency baseline (0.0 until a sample)."""
        baseline = min(self._bucket_min, self._prev_bucket_min)
        return baseline if math.isfinite(baseline) else 0.0

    def on_sample(self, latency_s: float) -> None:
        """Feed one completed request's latency and adapt the limit."""
        if latency_s < 0 or not math.isfinite(latency_s):
            return
        now = self._clock()
        self.samples += 1
        if now - self._bucket_started >= self.config.baseline_window_s:
            # rotate the min window so a long-gone fast sample cannot
            # anchor the baseline forever (capacity changes: model
            # swaps, thermal throttling, noisy neighbors)
            self._prev_bucket_min = self._bucket_min
            self._bucket_min = math.inf
            self._bucket_started = now
        self._bucket_min = min(self._bucket_min, latency_s)
        self._ewma = (
            latency_s
            if self._ewma == 0.0
            else 0.7 * self._ewma + 0.3 * latency_s
        )
        baseline = min(self._bucket_min, self._prev_bucket_min)
        gradient = max(
            0.5,
            min(
                1.0,
                self.config.tolerance * baseline / max(self._ewma, 1e-9),
            ),
        )
        target = self._limit * gradient + math.sqrt(self._limit)
        smoothing = self.config.smoothing
        self._limit = min(
            self.config.max_limit,
            max(
                self.config.min_limit,
                (1.0 - smoothing) * self._limit + smoothing * target,
            ),
        )

    def on_drop(self) -> None:
        """Explicit overload evidence (deadline miss / downstream
        shed): multiplicative decrease, at most once per latency
        interval — a storm of sheds is ONE signal, not N."""
        now = self._clock()
        if now - self._last_decrease < max(0.05, 2.0 * self._ewma):
            return
        self._last_decrease = now
        self.drops += 1
        self._limit = max(
            self.config.min_limit,
            self._limit * self.config.decrease_ratio,
        )


#: release() outcomes
OUTCOME_OK = "ok"          # served: latency feeds the limiter
OUTCOME_DROP = "drop"      # deadline miss / downstream shed: AIMD
OUTCOME_IGNORE = "ignore"  # no capacity verdict (circuit fast-fail,
#                            injected fault, slammed connection)


class AdmissionController:
    """Per-server admission: adaptive limit + criticality shedding +
    per-tenant fair share, with computed Retry-After hints.

    The HTTP layer pairs every successful :meth:`try_acquire` with
    exactly one :meth:`release` carrying the request's latency and an
    outcome (``ok`` feeds the limiter a sample, ``drop`` applies the
    AIMD decrease, ``ignore`` records nothing — a circuit-open
    fast-fail says nothing about THIS server's capacity and must not
    drag the latency signal down).
    """

    def __init__(
        self,
        service: str,
        registry: MetricRegistry | None = None,
        config: AdmissionConfig | None = None,
        limiter: GradientLimiter | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.service = service
        self.config = config or AdmissionConfig.from_env()
        self.limiter = (
            limiter
            if limiter is not None
            else GradientLimiter(self.config, clock=clock)
        )
        self._lock = threading.Lock()
        self._inflight = 0
        self._tenant_inflight: dict[str, int] = {}
        registry = registry if registry is not None else get_registry()
        # scrape-time functions: in a process that rebuilds servers
        # (tests, reload) the latest controller wins the service label
        registry.gauge(
            "pio_admission_limit",
            "Adaptive concurrency limit the admission controller is "
            "currently enforcing",
            ("service",),
        ).labels(service).set_function(lambda: float(self.limiter.limit))
        registry.gauge(
            "pio_admission_inflight",
            "Requests currently admitted past the admission controller",
            ("service",),
        ).labels(service).set_function(lambda: float(self.inflight))
        self._shed_total = registry.counter(
            "pio_admission_shed_total",
            "Requests refused by the admission controller, by class "
            "and reason (limit | fairshare)",
            ("service", "class", "reason"),
        )

    @classmethod
    def from_env(
        cls,
        service: str,
        registry: MetricRegistry | None = None,
        min_limit: float | None = None,
    ) -> "AdmissionController | None":
        """The deploy-time constructor: ``None`` when ``PIO_ADMISSION``
        is 0/false (the server then runs with only the static batcher
        queue bound, the pre-admission behavior).

        ``min_limit`` raises the configured floor — a batched server
        passes its pipeline quantum (``max_batch × (pipeline_depth +
        1)``): limiting below one full pipeline of slots starves the
        device without improving anyone's latency."""
        raw = os.environ.get("PIO_ADMISSION", "1").strip().lower()
        if raw in ("0", "false", "no", "off"):
            return None
        config = AdmissionConfig.from_env()
        if min_limit is not None and min_limit > config.min_limit:
            import dataclasses

            config = dataclasses.replace(
                config, min_limit=min(min_limit, config.max_limit)
            )
        return cls(service, registry=registry, config=config)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def try_acquire(self, criticality: str, tenant: str = "") -> None:
        """Admit or raise :class:`AdmissionRejected`. Callers MUST pair
        an admit with exactly one :meth:`release` (same tenant)."""
        cls = criticality if criticality in CLASS_RANK else DEFAULT
        with self._lock:
            limit = self.limiter.limit
            # every class can always use at least one slot: a tiny
            # limit times a class fraction must never starve an IDLE
            # server into shedding everything
            allowed = max(1.0, limit * CLASS_FRACTION[cls])
            if self._inflight + 1 > allowed:
                hint = self._retry_after_locked()
                self._shed_total.labels(self.service, cls, "limit").inc()
                raise AdmissionRejected(503, "limit", cls, hint)
            if (
                tenant
                and cls != CRITICAL
                and self._inflight + 1 > limit * self.config.fair_pressure
            ):
                # under pressure, a tenant past its equal share of the
                # limit is refused before it starves the rest; the
                # incoming request counts itself among active tenants
                active = len(self._tenant_inflight)
                if tenant not in self._tenant_inflight:
                    active += 1
                share = max(1, int(math.ceil(limit / max(1, active))))
                if self._tenant_inflight.get(tenant, 0) + 1 > share:
                    hint = self._retry_after_locked()
                    self._shed_total.labels(
                        self.service, cls, "fairshare"
                    ).inc()
                    raise AdmissionRejected(429, "fairshare", cls, hint)
            self._inflight += 1
            if tenant:
                self._tenant_inflight[tenant] = (
                    self._tenant_inflight.get(tenant, 0) + 1
                )

    def release(
        self, latency_s: float, outcome: str, tenant: str = ""
    ) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            if tenant:
                left = self._tenant_inflight.get(tenant, 1) - 1
                if left <= 0:
                    self._tenant_inflight.pop(tenant, None)
                else:
                    self._tenant_inflight[tenant] = left
            if outcome == OUTCOME_OK:
                self.limiter.on_sample(latency_s)
            elif outcome == OUTCOME_DROP:
                old = self.limiter.limit
                self.limiter.on_drop()
                if self.limiter.limit < old:
                    log_json(
                        logger, logging.INFO, "admission_limit_decrease",
                        service=self.service,
                        limit=round(self.limiter.limit, 1),
                    )
            # OUTCOME_IGNORE: no verdict about this server's capacity

    def _retry_after_locked(self) -> float:
        """Lock held. Backpressure hint from live queue state: roughly
        one observed-latency interval scaled by how far past the limit
        demand is — 'come back after about one slot's worth of work
        frees up', clamped to [0.05, 5] so a transient spike cannot
        push clients away for minutes."""
        limit = max(1.0, self.limiter.limit)
        base = max(self.limiter.latency_ewma_s, 0.02)
        pressure = self._inflight / limit
        return min(5.0, max(0.05, base * max(1.0, pressure)))

    def retry_after_s(self) -> float:
        with self._lock:
            return self._retry_after_locked()

    def retry_after_header(self) -> str:
        return format_retry_after(self.retry_after_s())
