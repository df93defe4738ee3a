"""Resilience primitives for the serving tier.

At the ROADMAP's scale ("heavy traffic from millions of users") partial
failure is the steady state, not the exception: a store server restarts
mid-deploy, a network hiccup eats a keep-alive socket, a slow device
dispatch outlives the client that asked for it. The serving tier is a
chain of HTTP hops (client → engine, engine → store, event → store) and
every hop used to have exactly one defense: a fixed socket timeout.
This module gives the chain four coordinated behaviors, used by
:mod:`~predictionio_tpu_torch.serving.http`, :mod:`~predictionio_tpu_torch.client`,
:mod:`~predictionio_tpu_torch.data.storage.httpstore`, and
:mod:`~predictionio_tpu_torch.serving.batching`:

Counterpart of ``predictionio_tpu/serving/resilience.py``, copied: the port keeps
its own copy of this standard-library module, so the same inputs
and clock give the same decisions in both packages
(``tests/test_torch_resilience.py``).

* **Deadline propagation** — a request carries its remaining time
  budget in the ``X-PIO-Deadline`` header (milliseconds). Each server
  rejects already-expired work at admission (504, before any handler
  runs), installs the deadline in a contextvar, and every outbound hop
  re-mints the header from what is left, so the budget shrinks across
  the chain instead of resetting. The micro-batcher drops expired
  slots *before* device dispatch — no computing answers nobody is
  waiting for.
* **Budgeted retries** — jittered exponential backoff for idempotent
  operations, capped by the remaining deadline (a retry that cannot
  finish in budget is not attempted).
* **Circuit breakers** — one closed/open/half-open breaker per remote
  target. Open breakers fast-fail instead of burning sockets and
  timeouts on a host that is down; a half-open probe re-closes the
  breaker when the target recovers. State is exported as gauges
  (``pio_breaker_state``) and transitions as counters.
* **Graceful drain** — SIGTERM flips ``GET /healthz`` from ``ok`` to
  ``draining``, new work is refused with 503 + ``Retry-After``,
  in-flight requests and the current device batch finish, then the
  server exits. Rolling restarts become lossless.
* **Fault injection** — a deterministic, seed-driven chaos middleware
  (env ``PIO_CHAOS``) that injects latency, errors, and connection
  resets at the HTTP boundary, so all of the above can be rehearsed
  (``scripts/chaos_smoke.py``) instead of first exercised by an outage.

Overload is NOT failure: the adaptive admission layer
(:mod:`~predictionio_tpu_torch.serving.admission`) composes with these
primitives — a 429/503 shed carrying a computed ``Retry-After`` is the
server ANSWERING, so it never counts as a breaker failure, a
dependency's :class:`CircuitOpenError` fast-fail never feeds the
limiter's latency signal, and shed-retry hints are honored only inside
the propagated deadline budget (docs/robustness.md "Overload &
backpressure").

Env knobs (all optional; see docs/robustness.md):

* ``PIO_RETRY_MAX_ATTEMPTS`` (3), ``PIO_RETRY_BASE_MS`` (50),
  ``PIO_RETRY_MAX_MS`` (2000), ``PIO_RETRY_MULTIPLIER`` (2.0),
  ``PIO_RETRY_JITTER`` (0.5)
* ``PIO_BREAKER_FAILURES`` (5), ``PIO_BREAKER_RESET_S`` (30),
  ``PIO_BREAKER_HALF_OPEN_MAX`` (1)
* ``PIO_DRAIN_GRACE_S`` (30)
* ``PIO_CHAOS`` (e.g. ``latency:p=0.1,ms=200;error:p=0.05;reset:p=0.02``),
  ``PIO_CHAOS_SEED``
"""

from __future__ import annotations

import contextvars
import logging
import math
import os
import random
import signal
import threading
import time
from dataclasses import dataclass
from typing import Callable

from predictionio_tpu_torch.obs import MetricRegistry, get_registry
from predictionio_tpu_torch.obs import timeline as timeline_mod
from predictionio_tpu_torch.obs.context import log_json

logger = logging.getLogger(__name__)

#: remaining time budget, in milliseconds, decremented across hops
DEADLINE_HEADER = "X-PIO-Deadline"


def _env_float(name: str, default: float) -> float:
    """One malformed-env policy for every knob in this module: warn
    and fall back to the default (a typo'd knob must degrade to stock
    resilience, never crash a server at startup)."""
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        logger.warning("ignoring malformed %s", name)
        return default


class DeadlineExceeded(Exception):
    """The request's time budget ran out before the work happened."""


class CircuitOpenError(RuntimeError):
    """Fast-fail: the target's breaker is open (recent failures)."""

    def __init__(self, target: str, message: str | None = None):
        super().__init__(
            message
            or f"circuit open for {target}; fast-failing without a request"
        )
        self.target = target


# --------------------------------------------------------------------------
# deadlines
# --------------------------------------------------------------------------


class Deadline:
    """An absolute point on the monotonic clock a request must not
    outlive. Created from a *relative* budget (``after``/``from_header``)
    because wall clocks differ across hosts — only budgets travel on
    the wire, never absolute times."""

    __slots__ = ("expires_mono",)

    #: budgets above this are clamped (a hostile or buggy header must
    #: not pin a deadline years in the future)
    MAX_BUDGET_S = 3600.0

    def __init__(self, expires_mono: float):
        self.expires_mono = expires_mono

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + min(seconds, cls.MAX_BUDGET_S))

    @classmethod
    def from_header(cls, raw: str | None) -> "Deadline | None":
        """Parse an ``X-PIO-Deadline`` value (remaining ms). ``None``
        or malformed → no deadline; ``<= 0`` → an already-expired
        deadline (the admission check turns it into a 504)."""
        if not raw:
            return None
        try:
            ms = float(raw)
        except ValueError:
            ms = math.nan
        if not math.isfinite(ms):
            # nan/inf float()-parse fine but poison every later
            # comparison (nan bypasses the clamp AND `expired`) —
            # treat them as malformed
            logger.debug("ignoring malformed %s: %r", DEADLINE_HEADER, raw)
            return None
        return cls.after(max(ms, 0.0) / 1000.0)

    def remaining_s(self) -> float:
        return self.expires_mono - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1000.0

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def to_header(self) -> str:
        """The header value for the NEXT hop: whatever budget is left
        now (so the budget decrements across hops)."""
        return str(max(0, int(self.remaining_ms())))

    def cap(self, timeout_s: float) -> float:
        """``timeout_s`` bounded by the remaining budget (never below
        a tiny positive floor, so socket APIs don't treat it as
        blocking-forever)."""
        return max(0.001, min(timeout_s, self.remaining_s()))

    def reserved(self, seconds: float) -> "Deadline":
        """A deadline ending ``seconds`` earlier — the slice a caller
        holds back for one more hop (the router reserves failover
        budget this way). When the budget is already too tight to
        slice (less than twice the reservation), the full deadline is
        returned: starving the FIRST attempt to protect a retry that
        could never fit anyway helps nobody."""
        if self.remaining_s() <= seconds * 2.0:
            return self
        return Deadline(self.expires_mono - seconds)


_deadline: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar(
    "pio_deadline", default=None
)


def set_deadline(deadline: Deadline | None) -> None:
    """Install the request's deadline for the current context (the
    HTTP layer calls this once per request, ``None`` when the request
    carried no budget — which also clears any stale value left on a
    reused keep-alive handler thread)."""
    _deadline.set(deadline)


def get_deadline() -> Deadline | None:
    return _deadline.get()


# --------------------------------------------------------------------------
# retries
# --------------------------------------------------------------------------

#: HTTP methods safe to replay — the ONE definition the client SDK and
#: the store hop both use, so retry semantics cannot drift between them
#: (every store-DAO PUT here is a keyed upsert)
IDEMPOTENT_METHODS = ("GET", "HEAD", "PUT", "DELETE")

_RETRY_ENV_KEYS = (
    "PIO_RETRY_MAX_ATTEMPTS",
    "PIO_RETRY_BASE_MS",
    "PIO_RETRY_MULTIPLIER",
    "PIO_RETRY_MAX_MS",
    "PIO_RETRY_JITTER",
)
_retry_policy_cache: dict[tuple, "RetryPolicy"] = {}


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff for idempotent operations.

    ``max_attempts`` counts the first try: 3 means one request plus at
    most two retries. Jitter subtracts up to ``jitter`` of the raw
    delay (spreading retry storms instead of synchronizing them)."""

    max_attempts: int = 3
    base_backoff_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.5

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        # called per outbound request on hot paths: cache per env-value
        # tuple so a test's monkeypatched env still takes effect while
        # the steady state skips the parse + construction
        key = tuple(os.environ.get(k) for k in _RETRY_ENV_KEYS)
        cached = _retry_policy_cache.get(key)
        if cached is not None:
            return cached
        policy = cls(
            max_attempts=max(
                1, int(_env_float("PIO_RETRY_MAX_ATTEMPTS", 3))
            ),
            base_backoff_s=_env_float("PIO_RETRY_BASE_MS", 50.0) / 1000.0,
            multiplier=_env_float("PIO_RETRY_MULTIPLIER", 2.0),
            max_backoff_s=_env_float("PIO_RETRY_MAX_MS", 2000.0) / 1000.0,
            jitter=min(
                1.0, max(0.0, _env_float("PIO_RETRY_JITTER", 0.5))
            ),
        )
        _retry_policy_cache[key] = policy
        return policy

    def backoff_s(self, attempt: int, rng: random.Random | None = None) -> float:
        """Delay before retry number ``attempt`` (0-based: the delay
        after the first failure is ``backoff_s(0)``)."""
        raw = min(
            self.base_backoff_s * (self.multiplier ** attempt),
            self.max_backoff_s,
        )
        r = (rng or random).random()
        return raw * (1.0 - self.jitter * r)

    def sleep_before_retry(
        self,
        attempt: int,
        deadline: Deadline | None,
        rng: random.Random | None = None,
    ) -> bool:
        """Sleep for the backoff if another attempt fits the budget;
        returns False (without sleeping) when retries or budget are
        exhausted — the caller surfaces the last error."""
        if attempt + 1 >= self.max_attempts:
            return False
        delay = self.backoff_s(attempt, rng)
        if deadline is not None and deadline.remaining_s() <= delay:
            return False
        time.sleep(delay)
        return True


# --------------------------------------------------------------------------
# circuit breakers
# --------------------------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: gauge encoding (documented in docs/robustness.md)
_STATE_VALUE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


@dataclass(frozen=True)
class BreakerConfig:
    failure_threshold: int = 5
    reset_after_s: float = 30.0
    half_open_max: int = 1

    @classmethod
    def from_env(cls) -> "BreakerConfig":
        return cls(
            failure_threshold=max(
                1, int(_env_float("PIO_BREAKER_FAILURES", 5))
            ),
            reset_after_s=max(
                0.0, _env_float("PIO_BREAKER_RESET_S", 30.0)
            ),
            half_open_max=max(
                1, int(_env_float("PIO_BREAKER_HALF_OPEN_MAX", 1))
            ),
        )


class CircuitBreaker:
    """Per-target closed → open → half-open → closed state machine.

    * ``closed``: requests flow; ``failure_threshold`` CONSECUTIVE
      failures trip it open (any success resets the count).
    * ``open``: ``allow()`` returns False (callers fast-fail) until
      ``reset_after_s`` elapses, then the next ``allow()`` moves to
      half-open.
    * ``half_open``: up to ``half_open_max`` probe requests pass; a
      probe success re-closes the breaker, a probe failure re-trips it
      open (and restarts the reset clock).

    Callers MUST pair every allowed request with exactly one
    ``record_success``/``record_failure``. State is exported on
    ``registry`` as ``pio_breaker_state{target}`` (0=closed, 1=open,
    2=half-open) and transitions as
    ``pio_breaker_transitions_total{target,to}``.
    """

    def __init__(
        self,
        target: str,
        config: BreakerConfig | None = None,
        registry: MetricRegistry | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.target = target
        self.config = config or BreakerConfig.from_env()
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._half_open_inflight = 0
        #: idents of threads holding a probe slot in the CURRENT
        #: half-open episode — a verdict is only a probe verdict if the
        #: recording thread was admitted as a probe (callers are
        #: synchronous, so allow() and the matching record run on one
        #: thread); anything else in half-open is a stale pre-trip
        #: verdict that must not steal the probe's slot
        self._probe_threads: set[int] = set()
        registry = registry if registry is not None else get_registry()
        self._state_gauge = registry.gauge(
            "pio_breaker_state",
            "Circuit breaker state per target "
            "(0=closed, 1=open, 2=half-open)",
            ("target",),
        ).labels(target)
        self._transitions = registry.counter(
            "pio_breaker_transitions_total",
            "Circuit breaker transitions by target and destination state",
            ("target", "to"),
        )
        self._state_gauge.set(_STATE_VALUE[CLOSED])

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str) -> None:
        # lock held by caller
        self._state = to
        if to != HALF_OPEN:
            # probe bookkeeping is per half-open episode
            self._probe_threads.clear()
            self._half_open_inflight = 0
        self._state_gauge.set(_STATE_VALUE[to])
        self._transitions.labels(self.target, to).inc()
        # incident timeline: a breaker flip is exactly the kind of
        # control-plane event that explains a goodput dip. record() is
        # a deque append — safe under the breaker lock.
        timeline_mod.get_timeline().record(
            "breaker_transition",
            f"breaker {self.target!r} -> {to}",
            severity=(
                timeline_mod.ERROR
                if to == OPEN
                else timeline_mod.INFO
            ),
            target=self.target,
            to=to,
        )
        log_json(
            logger,
            logging.WARNING if to == OPEN else logging.INFO,
            "breaker_transition",
            target=self.target,
            to=to,
        )

    def allow(self) -> bool:
        """May a request go to the target right now? A True answer
        must be followed by record_success/record_failure."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if (
                    self._clock() - self._opened_at
                    < self.config.reset_after_s
                ):
                    return False
                self._transition(HALF_OPEN)
                self._half_open_inflight = 0
                self._probe_threads.clear()
            # half-open: admit a bounded number of probes
            if self._half_open_inflight >= self.config.half_open_max:
                return False
            self._half_open_inflight += 1
            self._probe_threads.add(threading.get_ident())
            return True

    def _release_probe_slot(self) -> bool:
        """Lock held. True when the CALLING thread holds a probe slot
        in the current half-open episode (and releases it); a verdict
        from any other request predates the trip and proves nothing."""
        ident = threading.get_ident()
        if ident not in self._probe_threads:
            return False
        self._probe_threads.discard(ident)
        self._half_open_inflight = max(0, self._half_open_inflight - 1)
        return True

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                if not self._release_probe_slot():
                    return  # stale pre-trip verdict: ignore
                self._failures = 0
                self._transition(CLOSED)
            elif self._state == CLOSED:
                self._failures = 0
            # open: a late success from a request admitted before the
            # trip proves nothing about recovery — the reset clock rules

    def release(self) -> None:
        """The admitted request produced NO evidence about the target —
        it was never delivered whole (stale keep-alive replay) or the
        caller's own budget expired before the target could answer.
        Releases a half-open probe slot without a verdict; without this
        a verdict-less probe would wedge the breaker half-open forever."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._release_probe_slot()

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                if not self._release_probe_slot():
                    # a LATE failure from a request admitted before the
                    # trip: like a late success in OPEN, it predates
                    # this episode — re-tripping (or stealing the
                    # outstanding probe's slot) would delay a recovered
                    # target by another reset window
                    return
                self._opened_at = self._clock()
                self._transition(OPEN)
            elif self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.config.failure_threshold:
                    self._opened_at = self._clock()
                    self._transition(OPEN)
            # open: already tripped; more failures don't restart the clock
            # (a recovering target must get its half-open probe on time)


_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def get_breaker(
    target: str,
    config: BreakerConfig | None = None,
    registry: MetricRegistry | None = None,
) -> CircuitBreaker:
    """The process-wide breaker for ``target`` (``host:port``); created
    on first use (``config``/``registry`` only apply then — every later
    caller shares the same state, which is the point)."""
    with _breakers_lock:
        breaker = _breakers.get(target)
        if breaker is None:
            breaker = CircuitBreaker(
                target, config=config, registry=registry
            )
            _breakers[target] = breaker
        return breaker


def reset_breakers() -> None:
    """Forget all breaker state (tests)."""
    with _breakers_lock:
        _breakers.clear()


# --------------------------------------------------------------------------
# graceful drain
# --------------------------------------------------------------------------


class DrainState:
    """Shared between the HTTP handler threads (begin/end per request)
    and the drain sequence (waits for in-flight to reach zero)."""

    __slots__ = ("draining", "_lock", "_inflight")

    def __init__(self):
        self.draining = threading.Event()
        self._lock = threading.Lock()
        self._inflight = 0

    def begin_request(self) -> None:
        with self._lock:
            self._inflight += 1

    def end_request(self) -> None:
        with self._lock:
            self._inflight -= 1

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight


def drain_grace_s() -> float:
    return _env_float("PIO_DRAIN_GRACE_S", 30.0)


def install_signal_drain(
    *servers, grace_s: float | None = None
) -> Callable[[], None]:
    """SIGTERM → graceful drain for ``servers`` (HTTPServer instances).

    The handler immediately flips every server's ``/healthz`` to
    ``draining`` (load balancers stop routing), then a background
    thread runs each server's full drain: refuse new work with 503,
    wait for in-flight requests (bounded by ``grace_s`` /
    ``PIO_DRAIN_GRACE_S``), run drain hooks (closing micro-batchers —
    the current device batch finishes), and shut the listener down,
    which returns ``serve_forever`` and lets the process exit.

    Returns a callable restoring the previous handler (tests)."""

    def _handler(signum, frame):
        log_json(
            logger, logging.WARNING, "sigterm_drain",
            servers=len(servers),
        )
        for server in servers:
            server.begin_drain()

        def _go():
            for server in servers:
                server.drain(grace_s=grace_s)

        threading.Thread(target=_go, name="pio-drain", daemon=True).start()

    try:
        previous = signal.signal(signal.SIGTERM, _handler)
    except ValueError:
        # not the main thread (embedded/test usage): drain must be
        # driven explicitly via server.drain()
        return lambda: None

    def _restore() -> None:
        signal.signal(signal.SIGTERM, previous)

    return _restore


# --------------------------------------------------------------------------
# fault injection
# --------------------------------------------------------------------------


class ChaosError(Exception):
    """Injected HTTP error (the middleware's ``error`` fault)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class ChaosReset(Exception):
    """Injected connection reset: the HTTP layer slams the socket shut
    without writing a response (the client sees a peer reset — the
    exact failure a crashed server produces)."""


class ChaosPartition(ChaosReset):
    """Injected network partition: the connection is accepted and the
    request read, then the handler holds the socket for ``ms`` (packets
    into a black hole — the client just waits) before slamming it shut
    without a response. Subclasses :class:`ChaosReset` so the HTTP
    layer's no-response socket-close path handles both."""


@dataclass(frozen=True)
class _ChaosRule:
    fault: str  # latency | error | reset | partition
    p: float
    ms: float = 0.0
    status: int = 503


class ChaosMiddleware:
    """Deterministic, seed-driven fault injector for the HTTP boundary.

    Spec format (env ``PIO_CHAOS``), semicolon-separated rules::

        latency:p=0.1,ms=200;error:p=0.05;reset:p=0.02;partition:p=0.01,ms=100

    Rules are evaluated in order per request, each consuming exactly
    one PRNG draw — so for a given seed (``PIO_CHAOS_SEED``) and a
    serialized request sequence the fault schedule is reproducible.
    ``latency`` sleeps and continues to the next rule; ``error`` raises
    :class:`ChaosError` (default status 503, override with
    ``status=``); ``reset`` raises :class:`ChaosReset`; ``partition``
    accepts the connection, holds it for ``ms`` (default 0), then
    raises :class:`ChaosPartition` — the client sees a stall followed
    by a dead socket with no response, the shape of a network
    partition rather than a crashed process.

    The telemetry surface (``/healthz``, ``/metrics*``, ``/debug/*``)
    is exempted by the HTTP layer: chaos must not blind the operator
    watching the experiment. Injections are counted in
    ``pio_chaos_injected_total{fault}``. Flip :attr:`enabled` to stage
    brownouts mid-run (``scripts/chaos_smoke.py`` does)."""

    def __init__(
        self,
        rules: list[_ChaosRule] | str,
        seed: int | None = None,
        registry: MetricRegistry | None = None,
    ):
        self.rules = self.parse(rules) if isinstance(rules, str) else rules
        self.enabled = True
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        registry = registry if registry is not None else get_registry()
        self._injected = registry.counter(
            "pio_chaos_injected_total",
            "Faults injected by the chaos middleware, by fault kind",
            ("fault",),
        )

    @staticmethod
    def parse(spec: str) -> list[_ChaosRule]:
        rules: list[_ChaosRule] = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            fault, _, arg_str = part.partition(":")
            fault = fault.strip()
            if fault not in ("latency", "error", "reset", "partition"):
                raise ValueError(
                    f"chaos spec: unknown fault {fault!r} "
                    "(expected latency|error|reset|partition)"
                )
            args: dict[str, float] = {}
            for pair in filter(None, arg_str.split(",")):
                key, _, value = pair.partition("=")
                try:
                    args[key.strip()] = float(value)
                except ValueError as e:
                    raise ValueError(
                        f"chaos spec: bad value in {pair!r}"
                    ) from e
            p = args.pop("p", None)
            if p is None or not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"chaos spec: {fault} needs p=<0..1>, got {p!r}"
                )
            ms = args.pop("ms", 0.0)
            status = int(args.pop("status", 503))
            if args:
                raise ValueError(
                    f"chaos spec: unknown args for {fault}: "
                    f"{sorted(args)}"
                )
            rules.append(_ChaosRule(fault=fault, p=p, ms=ms, status=status))
        if not rules:
            raise ValueError("chaos spec parsed to no rules")
        return rules

    @classmethod
    def from_env(
        cls, registry: MetricRegistry | None = None
    ) -> "ChaosMiddleware | None":
        spec = os.environ.get("PIO_CHAOS")
        if not spec:
            return None
        seed_raw = os.environ.get("PIO_CHAOS_SEED")
        seed = int(seed_raw) if seed_raw else None
        middleware = cls(spec, seed=seed, registry=registry)
        log_json(
            logger, logging.WARNING, "chaos_enabled",
            spec=spec, seed=seed,
        )
        return middleware

    def apply(self, path: str) -> None:
        """Run the rule chain for one request; sleeps and/or raises."""
        if not self.enabled:
            return
        for rule in self.rules:
            with self._lock:
                hit = self._rng.random() < rule.p
            if not hit:
                continue
            self._injected.labels(rule.fault).inc()
            if rule.fault == "latency":
                time.sleep(rule.ms / 1000.0)
            elif rule.fault == "error":
                raise ChaosError(
                    rule.status, f"chaos: injected error on {path}"
                )
            elif rule.fault == "partition":
                # accept, swallow, stall, then reset without a
                # response — what a mid-connection network partition
                # looks like from the client side (vs `reset`, which
                # fails fast like a crashed process)
                if rule.ms > 0:
                    time.sleep(rule.ms / 1000.0)
                raise ChaosPartition()
            else:  # reset
                raise ChaosReset()
