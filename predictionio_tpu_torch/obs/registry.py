"""Thread-safe counters, gauges, and fixed-bucket latency histograms.

Counterpart of ``predictionio_tpu/obs/registry.py``, copied: the same
families, buckets, label handling and renderings (Prometheus text and
JSON with derived quantiles), so one scrape reads alike from either
package. ``pio_build_info`` carries the port's own version.

Design constraints, in priority order:

* **allocation-light on the hot path** — ``observe()``/``inc()`` on a
  bound (already-labeled) metric is a lock, an index, an add. Label
  resolution (``labels(...)``) allocates once and is meant to be done
  at wiring time, not per request.
* **fixed buckets** — histograms never grow; percentiles (p50/p95/p99)
  are derived at scrape time by linear interpolation inside the
  containing bucket, the standard Prometheus-client approach.
* **one registry, many feeders** — training loops and every server in
  the process share :func:`get_registry` so train-time and serve-time
  telemetry are one scrape; tests build private registries.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
import time
from typing import Callable, Iterable

#: default latency buckets (seconds): sub-ms through 10 s, roughly
#: log-spaced — covers HTTP-tier microseconds and cold-compile spikes
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: batch-size buckets: powers of two, matching the micro-batcher's
#: compile buckets so occupancy reads directly as "which program ran"
OCCUPANCY_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

#: training-step buckets (seconds): steps span sub-second solves to
#: multi-hour epochs; the serving LATENCY_BUCKETS top out at 10 s and
#: would clamp every long step's derived percentiles to 10.0
TRAIN_STEP_BUCKETS = (
    0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0,
    300.0, 900.0, 3600.0, 14400.0,
)


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers without the trailing .0."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _label_str(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    pairs = ",".join(
        f'{n}="{_escape(v)}"' for n, v in zip(names, values)
    )
    return "{" + pairs + "}"


def _escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class _Metric:
    """Base: a named family holding one child per label-value tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}

    def labels(self, *values, **kv):
        """Bound child for a label-value combination — resolve once at
        wiring time, then hit the child on the hot path."""
        if kv:
            if values:
                raise ValueError("pass labels positionally or by name")
            values = tuple(kv[n] for n in self.label_names)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name} expects labels {self.label_names}, "
                f"got {values}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                self._children[values] = child
            return child

    def _make_child(self):
        raise NotImplementedError

    def _ensure_default(self):
        """Unlabeled metrics expose the family itself as the single
        child, so ``counter.inc()`` works without ``labels()``."""
        if self.label_names:
            raise ValueError(
                f"{self.name} has labels {self.label_names}; "
                "call .labels(...) first"
            )
        return self.labels()

    def samples(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class Counter(_Metric):
    kind = "counter"

    def _make_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._ensure_default().inc(amount)

    @property
    def value(self) -> float:
        return self._ensure_default().value


class _GaugeChild:
    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Callable[[], float] | None = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Evaluate ``fn`` at scrape time (queue depths, pool sizes)."""
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 - a scrape must not 500
                return float("nan")
        with self._lock:
            return self._value


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._ensure_default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._ensure_default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._ensure_default().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._ensure_default().set_function(fn)

    @property
    def value(self) -> float:
        return self._ensure_default().value


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...]):
        self._lock = threading.Lock()
        self._bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1

    def time(self):
        """``with histogram.time():`` — observe the block's wall clock."""
        return _Timer(self)

    def percentile(self, q: float) -> float:
        """Derived quantile (0 < q < 1): linear interpolation inside
        the containing bucket, Prometheus ``histogram_quantile`` style.
        Returns NaN with no observations; the top bound for the +Inf
        bucket (nothing finer is knowable)."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
        return _quantile(self._bounds, counts, total, q)

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
        # percentiles derive from the SAME copied counts — computing
        # them from live state could disagree with count/buckets when
        # a scrape races an observe()
        buckets = {_fmt(b): c for b, c in zip(self._bounds, counts)}
        # the overflow bucket travels explicitly so two snapshots can
        # be merged bucket-wise (fleet federation) without deriving it
        # as count - sum(buckets) — backward-compatible: finite-bound
        # readers (render_prometheus) never look the key up
        buckets["+Inf"] = counts[len(self._bounds)]
        return {
            "count": total,
            "sum": round(s, 6),
            "buckets": buckets,
            "p50": _nan_none(_quantile(self._bounds, counts, total, 0.50)),
            "p95": _nan_none(_quantile(self._bounds, counts, total, 0.95)),
            "p99": _nan_none(_quantile(self._bounds, counts, total, 0.99)),
        }


def _quantile(
    bounds: tuple[float, ...], counts: list[int], total: int, q: float
) -> float:
    if total == 0:
        return float("nan")
    rank = q * total
    seen = 0.0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            if i >= len(bounds):
                return bounds[-1] if bounds else float("nan")
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - (seen - c)) / c if c else 0.0
            return lo + (hi - lo) * frac
    return bounds[-1] if bounds else float("nan")


def _nan_none(v: float) -> float | None:
    return None if math.isnan(v) else round(v, 6)


class _Timer:
    __slots__ = ("_child", "_t0")

    def __init__(self, child: _HistogramChild):
        self._child = child

    def __enter__(self):
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        self._child.observe(time.perf_counter() - self._t0)
        return False


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        label_names: Iterable[str] = (),
        buckets: tuple[float, ...] = LATENCY_BUCKETS,
    ):
        super().__init__(name, help, label_names)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._ensure_default().observe(value)

    def time(self):
        return self._ensure_default().time()

    def percentile(self, q: float) -> float:
        return self._ensure_default().percentile(q)


class MetricRegistry:
    """Get-or-create metric families; render Prometheus text or JSON."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, label_names, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or (
                    existing.label_names != tuple(label_names)
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels "
                        f"{existing.label_names}"
                    )
                return existing
            metric = cls(name, help, label_names, **kw)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help: str = "", label_names: Iterable[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, tuple(label_names))

    def gauge(
        self, name: str, help: str = "", label_names: Iterable[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help, tuple(label_names))

    def histogram(
        self,
        name: str,
        help: str = "",
        label_names: Iterable[str] = (),
        buckets: tuple[float, ...] = LATENCY_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, tuple(label_names), buckets=buckets
        )

    # -- export -----------------------------------------------------------

    def _families(self) -> list[_Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        for metric in self._families():
            lines.append(f"# HELP {metric.name} {metric.help}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            for values, child in metric.samples():
                label = _label_str(metric.label_names, values)
                if isinstance(child, _HistogramChild):
                    cumulative = 0
                    # render from ONE snapshot: mixing live counts with
                    # it would let a concurrent observe() make the
                    # cumulative buckets disagree with _count
                    snap = child.snapshot()
                    for bound in metric.buckets:
                        cumulative += snap["buckets"][_fmt(bound)]
                        le = _label_str(
                            metric.label_names + ("le",),
                            values + (_fmt(bound),),
                        )
                        lines.append(
                            f"{metric.name}_bucket{le} {cumulative}"
                        )
                    le = _label_str(
                        metric.label_names + ("le",), values + ("+Inf",)
                    )
                    lines.append(
                        f"{metric.name}_bucket{le} {snap['count']}"
                    )
                    lines.append(
                        f"{metric.name}_sum{label} {_fmt(snap['sum'])}"
                    )
                    lines.append(
                        f"{metric.name}_count{label} {snap['count']}"
                    )
                else:
                    lines.append(
                        f"{metric.name}{label} {_fmt(child.value)}"
                    )
        return "\n".join(lines) + "\n"

    def to_dict(self) -> dict:
        """JSON form: per family → per label-set → value/snapshot."""
        out: dict = {}
        for metric in self._families():
            entries = []
            for values, child in metric.samples():
                labels = dict(zip(metric.label_names, values))
                if isinstance(child, _HistogramChild):
                    entry = {"labels": labels, **child.snapshot()}
                else:
                    value = child.value
                    entry = {
                        "labels": labels,
                        "value": None if (
                            isinstance(value, float) and math.isnan(value)
                        ) else value,
                    }
                entries.append(entry)
            out[metric.name] = {
                "type": metric.kind,
                "help": metric.help,
                "samples": entries,
            }
        return out


#: telemetry-import wall clock — the uptime anchor for scrapes. (A
#: /proc/self/stat read would be a few ms more precise but platform-
#: bound; servers import telemetry within moments of process start.)
#: Prometheus defines process_start_time_seconds as a unix epoch —
#: scrapers compute uptime as time() - this on THEIR clock, so a
#: monotonic value here would be meaningless off-host.
_PROCESS_START_TIME = time.time()


def _read_resident_bytes() -> float:
    """RSS from ``/proc/self/statm`` (field 2, in pages)."""
    with open("/proc/self/statm", "rb") as f:
        pages = int(f.read().split()[1])
    return float(pages * os.sysconf("SC_PAGE_SIZE"))


def _count_open_fds() -> float:
    return float(len(os.listdir("/proc/self/fd")))


def _install_process_metrics(registry: MetricRegistry) -> None:
    """Deploy-correlation gauges on the default registry:
    ``pio_build_info{version=...} 1`` identifies which build answered a
    scrape (regressions line up with deploys), and
    ``pio_process_start_time_seconds`` lets dashboards compute uptime
    (``time() - pio_process_start_time_seconds``)."""
    from predictionio_tpu_torch.version import __version__

    registry.gauge(
        "pio_build_info",
        "Constant 1, labeled with the running package version",
        ("version",),
    ).labels(__version__).set(1)
    registry.gauge(
        "pio_process_start_time_seconds",
        "Unix time this process's telemetry started",
    ).set(_PROCESS_START_TIME)
    # self-telemetry: resident set + open fds, read at scrape time from
    # /proc so replica memory/fd creep is visible before the OOM killer
    # (or EMFILE) sees it. Registered only where /proc exists — off
    # Linux the families are simply absent, not NaN noise.
    if os.path.isdir("/proc/self"):
        registry.gauge(
            "pio_process_resident_bytes",
            "Resident set size of this process (/proc/self/statm)",
        ).set_function(_read_resident_bytes)
        registry.gauge(
            "pio_process_open_fds",
            "Open file descriptors of this process (/proc/self/fd)",
        ).set_function(_count_open_fds)


_default_registry = MetricRegistry()
_install_process_metrics(_default_registry)


def get_registry() -> MetricRegistry:
    """The process-wide registry every server and training loop feeds."""
    return _default_registry
