"""Device runtime telemetry: background device-memory sampler and
compile/retrace counters.

Counterpart of ``predictionio_tpu/obs/device.py``. ``DeviceSampler``
runs a daemon thread that periodically reads, for every visible CUDA
card, ``torch.cuda.mem_get_info`` (free and total bytes of the card)
and ``torch.cuda.memory_allocated`` (bytes this process's live tensors
hold), and publishes the JAX package's gauge names:

* ``pio_device_hbm_used_bytes{device}`` (total − free: the whole card,
  every process) / ``pio_device_hbm_limit_bytes{device}`` (total)
* ``pio_device_live_array_bytes`` — bytes held by live tensors of this
  process on every card (the host-side view of model + batch residency)

Without CUDA (a CPU context) a sample is empty and nothing is
published; the thread keeps its cadence, as the JAX sampler does on a
backend without memory stats.

``CompileTracker`` is copied as it is: ``pio_jit_compiles_total{site}``
on every new signature a site sees and ``pio_jit_retraces_total{site}``
when a site that already compiled sees a *different* one.
"""

from __future__ import annotations

import os
import threading
from typing import Callable

from predictionio_tpu_torch.obs.registry import MetricRegistry

_MIN_SAMPLE_S = 0.05


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def sample_devices() -> dict:
    """One synchronous read of every visible card's memory. Returns
    ``{"devices": {"cuda:<i>": {"used": .., "limit": ..}},
    "liveArrayBytes": float}``, or ``{}`` without CUDA."""
    import torch

    if not torch.cuda.is_available():
        return {}
    devices = {}
    live = 0.0
    for i in range(torch.cuda.device_count()):
        try:
            free, total = torch.cuda.mem_get_info(i)
            live += float(torch.cuda.memory_allocated(i))
        except RuntimeError:
            continue  # a card that cannot be read publishes nothing
        devices[f"cuda:{i}"] = {
            "used": float(total - free),
            "limit": float(total),
        }
    return {"devices": devices, "liveArrayBytes": live}


class DeviceSampler:
    """Daemon thread publishing device memory gauges on a fixed cadence
    (``PIO_DEVICE_SAMPLE_S``, default 10 s, monotonic clock via
    ``Event.wait``). ``start`` takes an eager first sample so gauges
    are live before the first tick; ``stop`` joins the thread."""

    def __init__(
        self,
        registry: MetricRegistry,
        *,
        interval_s: float | None = None,
        sample_fn: Callable[[], dict] = sample_devices,
    ) -> None:
        self._interval_s = max(
            _MIN_SAMPLE_S,
            interval_s
            if interval_s is not None
            else _env_float("PIO_DEVICE_SAMPLE_S", 10.0),
        )
        self._sample_fn = sample_fn
        self._used = registry.gauge(
            "pio_device_hbm_used_bytes",
            "Device memory bytes in use (torch.cuda.mem_get_info)",
            ("device",),
        )
        self._limit = registry.gauge(
            "pio_device_hbm_limit_bytes",
            "Device memory capacity bytes (torch.cuda.mem_get_info)",
            ("device",),
        )
        self._live = registry.gauge(
            "pio_device_live_array_bytes",
            "Bytes held by live tensors of this process on the cards",
        )
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._last: dict = {}

    def sample_once(self) -> dict:
        """Take and publish one sample; returns what was read (the
        profile-capture artifact snapshots this)."""
        sample = self._sample_fn() or {}
        for label, stats in (sample.get("devices") or {}).items():
            self._used.labels(label).set(stats.get("used") or 0.0)
            if stats.get("limit") is not None:
                self._limit.labels(label).set(stats["limit"])
        if "liveArrayBytes" in sample:
            self._live.set(sample["liveArrayBytes"])
        with self._lock:
            self._last = sample
        return sample

    def last_sample(self) -> dict:
        with self._lock:
            return dict(self._last)

    def start(self) -> "DeviceSampler":
        with self._lock:
            if self._thread is not None:
                return self
            self._stopped.clear()
            thread = threading.Thread(
                target=self._run,
                name="pio-device-sampler",
                daemon=True,
            )
            self._thread = thread
        try:
            self.sample_once()
        except Exception:
            pass  # eager sample is best-effort; cadence still starts
        thread.start()
        return self

    def _run(self) -> None:
        while not self._stopped.wait(self._interval_s):
            try:
                self.sample_once()
            except Exception:
                continue  # a flaky device read must not kill cadence

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)


class CompileTracker:
    """Counts compile work at named call sites. ``record(site,
    signature)`` increments ``pio_jit_compiles_total{site}`` for every
    signature the site has not seen before, and additionally
    ``pio_jit_retraces_total{site}`` when the site had already
    compiled a *different* signature (shape churn). Re-recording a
    known signature is a no-op — cache hits are free."""

    def __init__(self, registry: MetricRegistry) -> None:
        self._compiles = registry.counter(
            "pio_jit_compiles_total",
            "jit trace compilations per instrumented site",
            ("site",),
        )
        self._retraces = registry.counter(
            "pio_jit_retraces_total",
            "jit recompilations of an already-compiled site with a "
            "new signature",
            ("site",),
        )
        self._lock = threading.Lock()
        self._seen: dict[str, set] = {}

    def record(self, site: str, signature) -> bool:
        """Returns True when this (site, signature) compiled fresh."""
        key = repr(signature)
        with self._lock:
            seen = self._seen.setdefault(site, set())
            if key in seen:
                return False
            retrace = bool(seen)
            seen.add(key)
        self._compiles.labels(site).inc()
        if retrace:
            self._retraces.labels(site).inc()
        return True
