"""Unified telemetry: metric registry, tracing and request-ID propagation.

Counterpart of ``predictionio_tpu/obs``: serving records per-route
latency into the registry, the event server its ingest counts, training
loops publish :class:`~predictionio_tpu_torch.utils.profiling.StepTimer`
records, and every server that mounts the telemetry routes scrapes it at
``GET /metrics`` (Prometheus text) and ``GET /metrics.json``. Tracing
gives every request and every training run a span tree, exported as
Chrome trace-event JSON.

Stdlib-only at import (the device sampler imports ``torch`` when it
samples). Fleet federation (``obs/federation.py``) and SLO scoring
(``obs/slo.py``) belong to the fleet and are not ported yet (ROADMAP.md,
queue 1, item 5b).
"""

from predictionio_tpu_torch.obs.context import (
    get_request_id,
    new_request_id,
    set_request_id,
)
from predictionio_tpu_torch.obs.device import CompileTracker, DeviceSampler
from predictionio_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS,
    MetricRegistry,
    TRAIN_STEP_BUCKETS,
    get_registry,
)
from predictionio_tpu_torch.obs.timeline import (
    Timeline,
    get_timeline,
    merge_timelines,
    set_timeline,
)
from predictionio_tpu_torch.obs.tracing import (
    Span,
    Tracer,
    current_span,
    get_tracer,
    span,
)

__all__ = [
    "CompileTracker",
    "Counter",
    "DeviceSampler",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "MetricRegistry",
    "Span",
    "TRAIN_STEP_BUCKETS",
    "Timeline",
    "Tracer",
    "current_span",
    "get_registry",
    "get_request_id",
    "get_timeline",
    "get_tracer",
    "merge_timelines",
    "new_request_id",
    "set_request_id",
    "set_timeline",
    "span",
]
