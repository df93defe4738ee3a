"""SLO burn-rate monitor: per-criticality-class availability and
latency objectives tracked over multi-window rolling rates.

Counterpart of ``predictionio_tpu/obs/slo.py``, copied: the port keeps
its own copy of this standard-library module, so the same inputs
and clock give the same decisions in both packages
(``tests/test_torch_slo.py``).

Every served request is scored good or bad against its class
objective (``good`` = non-5xx, not shed with 429, and under the
class latency threshold). Goods and bads accumulate into coarse
time buckets on the monotonic clock, and the monitor derives the
SRE-style *burn rate* over a short and a long window:

    burn = bad_fraction_in_window / (1 - availability_target)

``burn == 1`` means the error budget is being consumed exactly at the
sustainable rate; ``burn == 14`` on the short window is the classic
page-now threshold. Exported per class as
``pio_slo_burn_rate{class,window}`` and
``pio_slo_budget_remaining{class}`` (scrape-time gauges), plus the
mergeable ``pio_slo_requests_total{class,outcome}`` counter so the
router can compute *fleet-level* burn from federated counter deltas
without seeing individual requests.

Objectives are env-configurable (``PIO_SLO_<CLASS>_AVAILABILITY``,
``PIO_SLO_<CLASS>_LATENCY_MS``, ``PIO_SLO_SHORT_WINDOW_S``,
``PIO_SLO_LONG_WINDOW_S``) — see ``docs/observability.md``.

Stdlib-only, like the rest of ``obs/``.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable

from predictionio_tpu_torch.obs import timeline
from predictionio_tpu_torch.obs.registry import MetricRegistry

#: short-window burn rate at which the incident timeline records an
#: ``slo_burn_alert`` — the classic page-now threshold
PAGE_BURN_RATE = 14.0

#: criticality classes tracked, mirroring ``serving.admission``
#: (admission is not imported: obs/ stays dependency-free)
CRITICAL = "critical"
DEFAULT = "default"
SHEDDABLE = "sheddable"
CLASSES = (CRITICAL, DEFAULT, SHEDDABLE)

WINDOWS = ("short", "long")

#: accumulation granularity — fine enough that a 60 s short window
#: has 12 buckets, coarse enough that pruning stays O(windows)
_BUCKET_S = 5.0

_DEFAULT_AVAILABILITY = {
    CRITICAL: 0.999,
    DEFAULT: 0.99,
    SHEDDABLE: 0.95,
}
_DEFAULT_LATENCY_MS = {
    CRITICAL: 500.0,
    DEFAULT: 1000.0,
    SHEDDABLE: 2000.0,
}


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        return default


@dataclass(frozen=True)
class Objective:
    """One class's SLO: availability target plus a latency threshold
    a request must beat to count as good."""

    availability: float
    latency_s: float

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - self.availability)


def objectives_from_env() -> dict[str, Objective]:
    out = {}
    for cls in CLASSES:
        upper = cls.upper()
        out[cls] = Objective(
            availability=min(
                1.0 - 1e-9,
                _env_float(
                    f"PIO_SLO_{upper}_AVAILABILITY",
                    _DEFAULT_AVAILABILITY[cls],
                ),
            ),
            latency_s=_env_float(
                f"PIO_SLO_{upper}_LATENCY_MS",
                _DEFAULT_LATENCY_MS[cls],
            )
            / 1000.0,
        )
    return out


class SLOMonitor:
    """Rolling good/bad rates per criticality class with short- and
    long-window burn-rate derivation.

    Servers feed it per-request via :meth:`observe` (wired inside the
    HTTP server's telemetry tail); the router feeds it *deltas* of
    federated ``pio_slo_requests_total`` counters via :meth:`ingest`
    to get the fleet-level view. Thread-safe; gauges evaluate at
    scrape time.
    """

    def __init__(
        self,
        registry: MetricRegistry | None = None,
        *,
        objectives: dict[str, Objective] | None = None,
        short_window_s: float | None = None,
        long_window_s: float | None = None,
        clock: Callable[[], float] = time.monotonic,
        export_counter: bool = True,
    ) -> None:
        self._objectives = dict(objectives or objectives_from_env())
        short = (
            short_window_s
            if short_window_s is not None
            else _env_float("PIO_SLO_SHORT_WINDOW_S", 60.0)
        )
        long = (
            long_window_s
            if long_window_s is not None
            else _env_float("PIO_SLO_LONG_WINDOW_S", 600.0)
        )
        self._windows = {
            "short": max(_BUCKET_S, short),
            "long": max(_BUCKET_S, short, long),
        }
        self._clock = clock
        self._lock = threading.Lock()
        # class -> {bucket index -> [good, bad]}
        self._buckets: dict[str, dict[int, list[float]]] = {
            cls: {} for cls in self._objectives
        }
        #: classes currently past the page-now burn threshold — the
        #: incident-timeline alert fires on the crossing, not per
        #: request, and clears with hysteresis at half the threshold
        self._alerting: set[str] = set()
        self._requests = None
        if registry is not None:
            if export_counter:
                self._requests = registry.counter(
                    "pio_slo_requests_total",
                    "Requests scored against the class SLO "
                    "(outcome=good|bad)",
                    ("class", "outcome"),
                )
            burn = registry.gauge(
                "pio_slo_burn_rate",
                "Error-budget burn rate per criticality class "
                "(1.0 = burning exactly at budget)",
                ("class", "window"),
            )
            remaining = registry.gauge(
                "pio_slo_budget_remaining",
                "Fraction of the class error budget left within the "
                "long window",
                ("class",),
            )
            for cls in self._objectives:
                for window in WINDOWS:
                    burn.labels(cls, window).set_function(
                        self._burn_fn(cls, window)
                    )
                remaining.labels(cls).set_function(
                    self._remaining_fn(cls)
                )

    def _burn_fn(self, cls: str, window: str):
        return lambda: self.burn_rate(cls, window)

    def _remaining_fn(self, cls: str):
        return lambda: self.budget_remaining(cls)

    # -- ingestion ----------------------------------------------------

    def objective(self, criticality: str) -> Objective:
        return self._objectives.get(
            criticality, self._objectives[DEFAULT]
        )

    def observe(
        self, criticality: str, status: int, elapsed_s: float
    ) -> None:
        """Score one finished request against its class objective."""
        cls = (
            criticality
            if criticality in self._objectives
            else DEFAULT
        )
        obj = self._objectives[cls]
        good = (
            status < 500
            and status != 429
            and elapsed_s <= obj.latency_s
        )
        self.ingest(cls, good=float(good), bad=float(not good))

    def ingest(self, cls: str, good: float, bad: float) -> None:
        """Add pre-scored counts (federated counter deltas on the
        router, or a test fixture)."""
        if good <= 0.0 and bad <= 0.0:
            return
        if cls not in self._objectives:
            cls = DEFAULT
        idx = int(self._clock() / _BUCKET_S)
        with self._lock:
            bucket = self._buckets[cls].setdefault(idx, [0.0, 0.0])
            bucket[0] += max(0.0, good)
            bucket[1] += max(0.0, bad)
            self._prune(cls, idx)
        if self._requests is not None:
            if good > 0.0:
                self._requests.labels(cls, "good").inc(good)
            if bad > 0.0:
                self._requests.labels(cls, "bad").inc(bad)
        self._check_burn(cls)

    def _check_burn(self, cls: str) -> None:
        """Emit an incident-timeline event when the class's
        short-window burn rate crosses the classic page-now threshold
        (burn 14 ~= the budget gone in <2 days at a 30-day window);
        clears with hysteresis at half the threshold so a rate
        hovering at the line doesn't flap events."""
        burn = self.burn_rate(cls, "short")
        fire = 0
        with self._lock:
            if burn >= PAGE_BURN_RATE and cls not in self._alerting:
                self._alerting.add(cls)
                fire = 1
            elif cls in self._alerting and burn < PAGE_BURN_RATE / 2.0:
                self._alerting.discard(cls)
                fire = -1
        if fire > 0:
            timeline.get_timeline().record(
                "slo_burn_alert",
                f"class {cls!r} short-window burn rate {burn:.1f}x is "
                f"past the page threshold ({PAGE_BURN_RATE:.0f}x)",
                severity=timeline.ERROR,
                **{"class": cls, "burn": round(burn, 2)},
            )
        elif fire < 0:
            timeline.get_timeline().record(
                "slo_burn_alert",
                f"class {cls!r} burn rate recovered "
                f"({burn:.1f}x, below {PAGE_BURN_RATE / 2.0:.0f}x)",
                **{"class": cls, "burn": round(burn, 2)},
            )

    def _prune(self, cls: str, now_idx: int) -> None:
        horizon = now_idx - int(self._windows["long"] / _BUCKET_S) - 1
        buckets = self._buckets[cls]
        for idx in [i for i in buckets if i < horizon]:
            del buckets[idx]

    # -- derivation ---------------------------------------------------

    def _window_counts(
        self, cls: str, window_s: float
    ) -> tuple[float, float]:
        now_idx = int(self._clock() / _BUCKET_S)
        first = now_idx - int(window_s / _BUCKET_S) + 1
        good = bad = 0.0
        with self._lock:
            for idx, (g, b) in self._buckets.get(cls, {}).items():
                if first <= idx <= now_idx:
                    good += g
                    bad += b
        return good, bad

    def burn_rate(self, cls: str, window: str = "short") -> float:
        """Bad fraction over the window divided by the error budget;
        0.0 when the window is empty (no traffic burns nothing)."""
        if cls not in self._objectives:
            return 0.0
        good, bad = self._window_counts(
            cls, self._windows.get(window, self._windows["short"])
        )
        total = good + bad
        if total <= 0.0:
            return 0.0
        return (bad / total) / self._objectives[cls].error_budget

    def budget_remaining(self, cls: str) -> float:
        """Error-budget fraction left within the long window — 1.0
        untouched, 0.0 fully burned (clamped)."""
        return min(
            1.0, max(0.0, 1.0 - self.burn_rate(cls, "long"))
        )

    def max_burn_rate(self, window: str = "short") -> float:
        """Worst short-window burn across classes — the scalar the
        autoscaler keys scale-up on."""
        return max(
            (
                self.burn_rate(cls, window)
                for cls in self._objectives
            ),
            default=0.0,
        )

    def snapshot(self) -> dict:
        """JSON-friendly burn/budget state (status endpoints, CLI)."""
        out = {}
        for cls in self._objectives:
            out[cls] = {
                "burnShort": round(self.burn_rate(cls, "short"), 4),
                "burnLong": round(self.burn_rate(cls, "long"), 4),
                "budgetRemaining": round(
                    self.budget_remaining(cls), 4
                ),
                "availability": self._objectives[cls].availability,
                "latencyMs": round(
                    self._objectives[cls].latency_s * 1000.0, 3
                ),
            }
        return out
