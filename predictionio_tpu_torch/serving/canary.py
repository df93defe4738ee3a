"""Shadow-scored canary promotion with automatic rollback.

The guarded half of hot model swap (docs/training.md "Canary
promotion"): ``/reload`` stages the new generation BESIDE the serving
one, a sampled fraction of live traffic is *shadow-scored* on it —
serve old, score new, compare — and the new generation is promoted only
when the canary gate passes:

Counterpart of ``predictionio_tpu/serving/canary.py``, copied: the port keeps
its own copy of this standard-library module, so the same inputs
and clock give the same decisions in both packages
(``tests/test_torch_canary.py``).

* mean divergence between old and new predictions bounded,
* zero NaNs and zero model exceptions on the shadow path,
* the new generation's warmup compiled every bucket.

After promotion the canary keeps the OLD generation staged and watches
a post-promotion window; if the served error rate or latency regresses
against the pre-promotion baseline, it rolls back to the previous
generation automatically. A rejected or rolled-back generation never
takes (or keeps) traffic — users only ever see the last-good model.

Threading model: the request path calls :meth:`ShadowCanary.observe`
(cheap bookkeeping) and enqueues sampled queries for the single shadow
worker thread, which scores them on the staged batchers. Gate/watch
verdicts are computed under the canary lock exactly once and handed to
the engine server via :meth:`take_decision`, which the server polls at
the end of each request — swaps happen on the request path, under the
server's own lock, never from the worker thread.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import queue
import threading
import time
from typing import Any

from predictionio_tpu_torch.obs import MetricRegistry, get_registry

logger = logging.getLogger(__name__)

#: canary states (also exported as the ``pio_canary_state`` gauge)
IDLE = "idle"
SHADOWING = "shadowing"
WATCHING = "watching"          # promoted, regression watch running
STABLE = "stable"
REJECTED = "rejected"
ROLLED_BACK = "rolled_back"

_STATE_CODE = {
    IDLE: 0, SHADOWING: 1, WATCHING: 2, STABLE: 3, REJECTED: 4,
    ROLLED_BACK: 5,
}

DIVERGENCE_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0
)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class CanaryConfig:
    """Gate/watch policy. Every field has a ``PIO_CANARY_*`` env
    override (:meth:`from_env`) so deploys tune the gate without code."""

    #: fraction of live single-query traffic shadow-scored (0..1]
    shadow_sample: float = 0.25
    #: comparisons required before the gate may promote
    min_shadow: int = 20
    #: mean-divergence bound for promotion
    max_divergence: float = 0.05
    #: post-promotion requests required before a stability verdict
    watch_min_requests: int = 20
    #: minimum post-promotion watch window (seconds)
    watch_s: float = 10.0
    #: rollback when post-promotion mean latency exceeds
    #: baseline × this factor
    latency_factor: float = 3.0
    #: rollback when the post-promotion server error rate exceeds this
    error_rate_limit: float = 0.02
    #: shadow result wait bound (seconds)
    shadow_timeout_s: float = 10.0

    @staticmethod
    def from_env() -> "CanaryConfig":
        d = CanaryConfig()
        return CanaryConfig(
            shadow_sample=_env_float(
                "PIO_CANARY_SAMPLE", d.shadow_sample
            ),
            min_shadow=int(_env_float(
                "PIO_CANARY_MIN_SHADOW", d.min_shadow
            )),
            max_divergence=_env_float(
                "PIO_CANARY_MAX_DIVERGENCE", d.max_divergence
            ),
            watch_min_requests=int(_env_float(
                "PIO_CANARY_WATCH_MIN_REQUESTS", d.watch_min_requests
            )),
            watch_s=_env_float("PIO_CANARY_WATCH_S", d.watch_s),
            latency_factor=_env_float(
                "PIO_CANARY_LATENCY_FACTOR", d.latency_factor
            ),
            error_rate_limit=_env_float(
                "PIO_CANARY_ERROR_RATE", d.error_rate_limit
            ),
            shadow_timeout_s=_env_float(
                "PIO_CANARY_SHADOW_TIMEOUT_S", d.shadow_timeout_s
            ),
        )


# --------------------------------------------------------------------------
# Prediction divergence
# --------------------------------------------------------------------------


def _num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def contains_nan(value: Any) -> bool:
    """Any non-finite float anywhere in a JSON-ish prediction."""
    if _num(value):
        return not math.isfinite(float(value))
    if isinstance(value, dict):
        return any(contains_nan(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(contains_nan(v) for v in value)
    return False


def _walk_divergence(old: Any, new: Any, diffs: list[float]) -> None:
    if _num(old) and _num(new):
        a, b = float(old), float(new)
        if not (math.isfinite(a) and math.isfinite(b)):
            diffs.append(1.0)
            return
        diffs.append(
            min(abs(a - b) / max(abs(a), abs(b), 1e-9), 1.0)
        )
        return
    if isinstance(old, dict) and isinstance(new, dict):
        for key in old.keys() | new.keys():
            if key in old and key in new:
                _walk_divergence(old[key], new[key], diffs)
            else:
                diffs.append(1.0)
        return
    if isinstance(old, (list, tuple)) and isinstance(new, (list, tuple)):
        for i in range(max(len(old), len(new))):
            if i < len(old) and i < len(new):
                _walk_divergence(old[i], new[i], diffs)
            else:
                diffs.append(1.0)
        return
    diffs.append(0.0 if old == new else 1.0)


def divergence(old: Any, new: Any) -> float:
    """Structural prediction distance in [0, 1]: mean over aligned
    leaves of relative numeric difference / exact-match indicator, with
    shape mismatches (missing keys, length differences, type changes)
    scored 1.0. Identical predictions → 0.0."""
    diffs: list[float] = []
    _walk_divergence(old, new, diffs)
    return sum(diffs) / len(diffs) if diffs else 0.0


#: keys that identify WHICH process/generation answered, not WHAT the
#: model predicted — the fleet gate compares predictions from two
#: different replica processes, so these must not score as divergence
#: (the per-replica canary's ``prId`` strip is the same idea: only
#: model-comparable content enters the gate)
VOLATILE_PREDICTION_KEYS = frozenset({"prId", "pid", "generation"})


def strip_volatile(
    prediction: Any, keys: frozenset[str] = VOLATILE_PREDICTION_KEYS
) -> Any:
    """Drop provenance keys from a dict-shaped prediction before it
    enters a divergence comparison. Non-dict predictions pass through
    untouched — the gate scores them whole."""
    if isinstance(prediction, dict):
        return {k: v for k, v in prediction.items() if k not in keys}
    return prediction


# --------------------------------------------------------------------------
# The canary state machine
# --------------------------------------------------------------------------


class ShadowCanary:
    """One staged generation under evaluation, plus its verdict state.

    ``staged`` and ``retained`` are opaque to this class (the engine
    server's staged-generation records); the canary only sequences
    them. Lifecycle::

        SHADOWING --gate passes--> WATCHING --window clean--> STABLE
            |  NaN / model exception / divergence     |  latency or
            v                                         v  error regress
         REJECTED                                ROLLED_BACK
    """

    def __init__(
        self,
        staged: Any,
        config: CanaryConfig | None = None,
        registry: MetricRegistry | None = None,
        shadow_fn=None,
    ):
        """``shadow_fn(supplemented) -> prediction`` scores one query on
        the staged generation (provided by the engine server: submit to
        the staged batchers + staged serving.serve). Runs only on the
        shadow worker thread."""
        self.staged = staged
        self.retained: Any = None  # pre-promotion generation, for rollback
        self._config = config or CanaryConfig()
        self._registry = (
            registry if registry is not None else get_registry()
        )
        self._shadow_fn = shadow_fn
        self._lock = threading.Lock()
        self._state = SHADOWING
        self._decision: str | None = None
        self._decision_taken = False
        # shadow stats
        self._samples = 0
        self._divergence_sum = 0.0
        self._max_divergence_seen = 0.0
        self._nan = 0
        self._exceptions = 0
        self._seen_requests = 0
        # latency baseline (pre-promotion) and watch (post-promotion)
        self._baseline_ewma: float | None = None
        self._watch_started_mono = 0.0
        self._watch_requests = 0
        self._watch_errors = 0
        self._watch_latency_sum = 0.0
        self._reason = ""
        self._div_hist = self._registry.histogram(
            "pio_shadow_divergence",
            "Old-vs-new prediction divergence per shadow-scored query "
            "(0 identical .. 1 disjoint)",
            buckets=DIVERGENCE_BUCKETS,
        )
        self._events = self._registry.counter(
            "pio_canary_events_total",
            "Canary lifecycle events (shadow samples, verdicts)",
            ("event",),
        )
        self._state_gauge = self._registry.gauge(
            "pio_canary_state",
            "Canary state: 0 idle, 1 shadowing, 2 watching (promoted), "
            "3 stable, 4 rejected, 5 rolled back",
        )
        self._state_gauge.set(_STATE_CODE[SHADOWING])
        # bounded handoff to ONE worker: shadow scoring must never
        # block or amplify live traffic; overflow = dropped sample
        self._queue: queue.Queue = queue.Queue(maxsize=64)
        self._worker = threading.Thread(
            target=self._shadow_worker, name="canary-shadow", daemon=True
        )
        self._worker.start()

    # -- request-path API --------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    @property
    def reason(self) -> str:
        return self._reason

    def observe(self, supplemented: Any, prediction: Any,
                elapsed_s: float, ok: bool = True) -> None:
        """One served request: feeds the latency baseline (while
        shadowing) or the regression watch (after promotion), and —
        when the deterministic sampler selects it — enqueues the query
        for shadow scoring. Never blocks, never raises."""
        with self._lock:
            state = self._state
            if state == SHADOWING:
                if ok:
                    self._baseline_ewma = (
                        elapsed_s
                        if self._baseline_ewma is None
                        else 0.9 * self._baseline_ewma + 0.1 * elapsed_s
                    )
                self._seen_requests += 1
                n, s = self._seen_requests, self._config.shadow_sample
                # divergence needs BOTH sides: a served request with no
                # comparable prediction (e.g. a 4xx answered upstream of
                # the model) may feed the baseline but never the sampler
                sampled = (
                    ok
                    and prediction is not None
                    and int(n * s) > int((n - 1) * s)
                )
            elif state == WATCHING:
                self._watch_requests += 1
                self._watch_latency_sum += elapsed_s
                if not ok:
                    self._watch_errors += 1
                self._maybe_verdict_watch_locked()
                sampled = False
            else:
                return
        if sampled:
            try:
                self._queue.put_nowait((supplemented, prediction))
            except queue.Full:
                self._events.labels("shadow_dropped").inc()

    def take_decision(self) -> str | None:
        """The single-fire verdict ("promote" | "reject" | "rollback" |
        "stable"), or None. The engine server polls this on the request
        path and applies the swap under its own lock."""
        with self._lock:
            if self._decision is None or self._decision_taken:
                return None
            self._decision_taken = True
            return self._decision

    def cancel(self, reason: str) -> bool:
        """Claim the verdict slot for an operator-initiated supersede
        (a manual /reload while the canary is live). Returns False when
        a gate/watch verdict was already claimed — that verdict's
        applier owns the teardown and the caller should let it settle."""
        with self._lock:
            if self._decision_taken:
                return False
            self._decision = "cancelled"
            self._decision_taken = True
            self._reason = reason
            return True

    def promoted(self, retained: Any) -> None:
        """The server swapped the staged generation in; ``retained`` is
        the previous generation kept loaded for rollback."""
        with self._lock:
            self.retained = retained
            self._state = WATCHING
            self._state_gauge.set(_STATE_CODE[WATCHING])
            self._decision = None
            self._decision_taken = False
            self._watch_started_mono = time.monotonic()
        self._events.labels("promoted").inc()

    def finished(self, outcome: str) -> None:
        """Terminal bookkeeping after the server applied a verdict."""
        with self._lock:
            self._state = outcome
            self._state_gauge.set(_STATE_CODE[outcome])
        self._events.labels(outcome).inc()
        self.close()

    def to_dict(self) -> dict:
        with self._lock:
            mean_div = (
                self._divergence_sum / self._samples
                if self._samples else 0.0
            )
            return {
                "state": self._state,
                "reason": self._reason,
                "shadowSamples": self._samples,
                "meanDivergence": round(mean_div, 6),
                "maxDivergence": round(self._max_divergence_seen, 6),
                "nanPredictions": self._nan,
                "shadowExceptions": self._exceptions,
                "baselineLatencySec": self._baseline_ewma,
                "watchRequests": self._watch_requests,
                "watchErrors": self._watch_errors,
            }

    def close(self) -> None:
        """Stop the shadow worker (sentinel; the queue is bounded and
        the worker drains fast — a full queue at close means dropped
        shadows, which is exactly their contract)."""
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            # worker is alive and draining (bounded ≤64 × shadow
            # timeout); it will see the state flip and exit
            pass

    # -- worker + verdicts -------------------------------------------------
    def _shadow_worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            with self._lock:
                if self._state != SHADOWING:
                    if self._state in (STABLE, REJECTED, ROLLED_BACK):
                        return
                    continue
            supplemented, old_prediction = item
            try:
                new_prediction = self._shadow_fn(supplemented)
            except ShadowDropped:
                self._events.labels("shadow_dropped").inc()
                continue
            except Exception as e:  # noqa: BLE001 - model exception = veto
                logger.warning("canary shadow scoring raised: %s", e)
                self._events.labels("shadow_error").inc()
                with self._lock:
                    self._exceptions += 1
                    self._verdict_locked(
                        "reject",
                        f"model exception on shadow path: {e}",
                    )
                continue
            self._record_shadow(old_prediction, new_prediction)

    def _record_shadow(self, old_prediction, new_prediction) -> None:
        div = divergence(old_prediction, new_prediction)
        has_nan = contains_nan(new_prediction)
        self._div_hist.observe(div)
        self._events.labels(
            "shadow_nan" if has_nan else "shadow_ok"
        ).inc()
        with self._lock:
            self._samples += 1
            self._divergence_sum += div
            self._max_divergence_seen = max(
                self._max_divergence_seen, div
            )
            if has_nan:
                self._nan += 1
                self._verdict_locked(
                    "reject", "NaN in shadow prediction"
                )
                return
            cfg = self._config
            if self._samples >= cfg.min_shadow:
                mean_div = self._divergence_sum / self._samples
                if mean_div > cfg.max_divergence:
                    self._verdict_locked(
                        "reject",
                        f"mean divergence {mean_div:.4f} > "
                        f"{cfg.max_divergence}",
                    )
                else:
                    self._verdict_locked(
                        "promote",
                        f"gate passed: {self._samples} samples, mean "
                        f"divergence {mean_div:.4f}, 0 NaN, "
                        "0 exceptions",
                    )

    def _maybe_verdict_watch_locked(self) -> None:
        cfg = self._config
        if self._watch_requests < max(1, cfg.watch_min_requests):
            return
        error_rate = self._watch_errors / self._watch_requests
        mean_latency = self._watch_latency_sum / self._watch_requests
        baseline = self._baseline_ewma
        if error_rate > cfg.error_rate_limit:
            self._verdict_locked(
                "rollback",
                f"post-promotion error rate {error_rate:.3f} > "
                f"{cfg.error_rate_limit}",
            )
            return
        if (
            baseline is not None
            and baseline > 0
            and mean_latency > cfg.latency_factor * baseline
        ):
            self._verdict_locked(
                "rollback",
                f"post-promotion latency {mean_latency * 1e3:.1f}ms > "
                f"{cfg.latency_factor}x baseline "
                f"{baseline * 1e3:.1f}ms",
            )
            return
        if time.monotonic() - self._watch_started_mono >= cfg.watch_s:
            self._verdict_locked(
                "stable",
                f"watch window clean: {self._watch_requests} requests, "
                f"error rate {error_rate:.3f}, mean latency "
                f"{mean_latency * 1e3:.1f}ms",
            )

    def _verdict_locked(self, decision: str, reason: str) -> None:
        if self._decision is not None:
            return
        # state-guard every transition: a shadow score already in
        # flight when promotion landed must not re-fire "promote" into
        # the reset decision slot (the second application would capture
        # the just-promoted generation as its own rollback target)
        if decision in ("promote", "reject") and self._state != SHADOWING:
            return
        if decision in ("rollback", "stable") and self._state != WATCHING:
            return
        self._decision = decision
        self._reason = reason
        logger.info("canary verdict: %s (%s)", decision, reason)


class ShadowDropped(Exception):
    """Raised by the engine server's shadow_fn when the staged batcher
    shed/expired the query — an infrastructure drop, not a model fault;
    never counts against the canary gate."""
