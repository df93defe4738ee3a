"""Step timing with a device barrier, the device profiler, and profile
capture.

Counterpart of ``predictionio_tpu/utils/profiling.py``:

* :class:`StepTimer` — per-step wall-clock records for training loops;
  each step is also a :mod:`~predictionio_tpu_torch.obs.tracing` span
  (a no-op outside an open trace), and :meth:`StepTimer.publish` folds
  the records into a metric registry as ``pio_train_step_seconds{step}``.
* :func:`trace` — ``torch.profiler`` writing a Chrome trace (Perfetto)
  into a directory when one is given or ``PIO_TRACE_DIR`` is set, where
  the JAX package runs ``jax.profiler``; transparent otherwise.
* :func:`capture` / :func:`bundle` — one on-demand profile artifact
  (profiler output, the tracer's spans, a device sample) and its
  ``tar.gz``.

PyTorch returns before the card finishes, so a timed step that should
include device work ends in :func:`sync`.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import tarfile
import tempfile
import time
import uuid
from collections import defaultdict

import torch

from predictionio_tpu_torch.obs import tracing

logger = logging.getLogger(__name__)


def sync(value=None) -> None:
    """Device barrier: ``torch.cuda.synchronize`` for a CUDA tensor (or,
    with no argument, for the current CUDA device when there is one); a
    no-op on the CPU, where every op has finished when it returns."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
        return
    if value is None and torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Named per-step wall-clock records."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.records: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def step(self, name: str, sync_value=None):
        # each step is also a tracing span (a no-op outside an open
        # trace), so a training run emits the same Perfetto timeline the
        # servers do
        if not self.enabled:
            yield
            return
        with tracing.span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync_value is not None:
                    sync(sync_value)
                self.records[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        if self.enabled:
            self.records[name].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.records.items():
            out[name] = {
                "count": len(xs),
                "total_s": round(sum(xs), 6),
                "mean_s": round(sum(xs) / len(xs), 6),
                "max_s": round(max(xs), 6),
            }
        return out

    def to_json(self) -> str:
        return json.dumps(self.summary())

    def publish(self, registry, name: str = "pio_train_step_seconds"):
        """Fold the records into a metric registry
        (:class:`~predictionio_tpu_torch.obs.MetricRegistry`) as a
        per-step labelled histogram, so train-time timing is scrapeable
        from the same ``/metrics`` surface as serving."""
        from predictionio_tpu_torch.obs import TRAIN_STEP_BUCKETS

        hist = registry.histogram(
            name,
            "Training-loop step wall clock (StepTimer records)",
            ("step",),
            buckets=TRAIN_STEP_BUCKETS,
        )
        for step, xs in self.records.items():
            child = hist.labels(step)
            for seconds in xs:
                child.observe(seconds)
        return hist

    def log_summary(self, prefix: str = "") -> None:
        for name, s in self.summary().items():
            logger.info(
                "%s%s: %d step(s), mean %.4fs, total %.2fs",
                prefix, name, s["count"], s["mean_s"], s["total_s"],
            )


@contextlib.contextmanager
def trace(trace_dir: str | None = None):
    """``torch.profiler`` over the block (host ops, and the card's
    kernels when CUDA is available), written as one Chrome trace
    ``torch_<pid>_<id>.trace.json`` into ``trace_dir`` or
    ``PIO_TRACE_DIR``; transparent when neither is set."""
    trace_dir = trace_dir or os.environ.get("PIO_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(
        trace_dir, f"torch_{os.getpid()}_{uuid.uuid4().hex[:8]}.trace.json"
    )
    logger.info("writing profiler trace to %s", path)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)


def capture(
    duration_s: float,
    tracer: "tracing.Tracer | None" = None,
    device_sample_fn=None,
    out_dir: str | None = None,
) -> dict:
    """On-demand profile capture: a duration-bounded :func:`trace` plus
    the same window's flight-recorder spans (Chrome trace-event JSON)
    and the current device gauges, in ONE artifact directory:

    * ``torch_trace/`` — the ``torch.profiler`` output
    * ``spans.json`` — the tracing flight recorder's chrome trace
    * ``device.json`` — a device-memory sample (when a sampler is given)
    * ``manifest.json`` — id, window, file list

    Returns the manifest. The artifact root is ``out_dir``, else
    ``PIO_PROFILE_DIR``, else a fresh temp dir."""
    art_id = uuid.uuid4().hex[:12]
    base = (
        out_dir
        or os.environ.get("PIO_PROFILE_DIR")
        or tempfile.mkdtemp(prefix="pio-profile-")
    )
    artifact_dir = os.path.join(base, f"profile-{art_id}")
    trace_dir = os.path.join(artifact_dir, "torch_trace")
    os.makedirs(trace_dir, exist_ok=True)
    t0 = time.perf_counter()
    with trace(trace_dir):
        time.sleep(max(0.0, duration_s))
    elapsed = time.perf_counter() - t0
    tracer = tracer if tracer is not None else tracing.get_tracer()
    with open(os.path.join(artifact_dir, "spans.json"), "w") as f:
        json.dump(tracer.chrome_trace(), f, default=str)
    files = ["torch_trace/", "manifest.json", "spans.json"]
    if device_sample_fn is not None:
        try:
            sample = device_sample_fn()
        except Exception:  # noqa: BLE001 - capture must not fail on a flaky device read
            sample = None
        if sample is not None:
            with open(
                os.path.join(artifact_dir, "device.json"), "w"
            ) as f:
                json.dump(sample, f)
            files.append("device.json")
    manifest = {
        "id": art_id,
        "durationS": round(elapsed, 6),
        "artifactDir": artifact_dir,
        "files": sorted(files),
    }
    with open(os.path.join(artifact_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    logger.info(
        "profile capture %s: %.2fs window -> %s",
        art_id, elapsed, artifact_dir,
    )
    return manifest


def bundle(artifact_dir: str) -> bytes:
    """One capture artifact as an in-memory ``tar.gz``."""
    buf = io.BytesIO()
    arcname = os.path.basename(artifact_dir.rstrip(os.sep))
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        tar.add(artifact_dir, arcname=arcname)
    return buf.getvalue()
