"""Step timing, the device profiler, and profile capture.

Counterpart of ``predictionio_tpu/utils/profiling.py``:

* :class:`StepTimer` — per-step records for training loops; each step
  is also a :mod:`~predictionio_tpu_torch.obs.tracing` span (a no-op
  outside an open trace), and :meth:`StepTimer.publish` folds the
  records into a metric registry as ``pio_train_step_seconds{step}``. A
  step taken inside :func:`steps_on` a CUDA device is the card's
  interval, between two CUDA events, read after the caller's own
  closing fetch: timing a step waits for nothing.
* :func:`trace` — ``torch.profiler`` writing a Chrome trace (Perfetto)
  into a directory when one is given or ``PIO_TRACE_DIR`` is set, where
  the JAX package runs ``jax.profiler``; transparent otherwise. What it
  yields (:class:`ProfilerTrace`) puts the tracer's spans on that
  file's clock and merges them into it.
* :func:`capture` / :func:`bundle` — one on-demand profile artifact
  (profiler output, the tracer's spans, a device sample) and its
  ``tar.gz``.

PyTorch returns before the card finishes, so a host-clock measurement
that should include device work ends in :func:`sync`.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
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


#: the device whose stream :class:`StepTimer` steps time (:func:`steps_on`)
_step_device: contextvars.ContextVar = contextvars.ContextVar(
    "pio_step_device", default=None
)


@contextlib.contextmanager
def steps_on(device):
    """:class:`StepTimer` steps taken in the block time the work the
    block enqueues on ``device``'s current stream: on a CUDA device
    between two CUDA events, with no wait; elsewhere on the host clock.
    The epoch loop of :func:`~predictionio_tpu_torch.ops.als.train_als`
    runs in one."""
    token = _step_device.set(torch.device(device))
    try:
        yield
    finally:
        _step_device.reset(token)


class StepTimer:
    """Named per-step records, in seconds.

    A step on the host clock is recorded as it ends. A step inside
    :func:`steps_on` a CUDA device records a CUDA event on the device's
    current stream at each end, and its span (the current span over the
    block) waits with them: :meth:`resolve` reads both once the events
    have run, after the caller's own closing fetch. It places the span
    on the tracer's clock through an *anchor*, an event recorded when
    the stream was seen empty at a step's start, so that it ran as it
    was recorded, at a known host time (:func:`_anchor_event`): the
    latest before the step, else the first after it. ``summary``,
    ``publish`` and ``log_summary`` resolve first; ``records`` read
    directly may lack steps not yet resolved."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.records: dict[str, list[float]] = defaultdict(list)
        #: (name, span or None, start event, end event, anchors taken
        #: before the step, stream)
        self._pending: list[tuple] = []
        #: (event, host time on the tracer's clock) of each drain
        self._anchors: list[tuple] = []

    @contextlib.contextmanager
    def step(self, name: str):
        if not self.enabled:
            yield
            return
        device = _step_device.get()
        if device is None or device.type != "cuda":
            # each step is also a tracing span (a no-op outside an open
            # trace), so a training run emits the same Perfetto timeline
            # the servers do
            with tracing.span(name):
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self.records[name].append(time.perf_counter() - t0)
            return
        stream = torch.cuda.current_stream(device)
        if stream.query():
            anchor = _anchor_event(stream)
            if anchor is not None:
                self._anchors.append(anchor)
        sp = tracing.span(name)
        sp = None if sp is tracing.NOOP else sp
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        with sp.current() if sp is not None else contextlib.nullcontext():
            yield
        end.record(stream)
        self._pending.append((name, sp, start, end, len(self._anchors),
                              stream))

    def resolve(self) -> None:
        """Read the device steps taken so far into ``records`` and record
        their spans. The caller has waited for the card (its closing
        fetch), so no event is waited for; a run whose stream was never
        seen empty gets its anchor here, from the drained stream."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        anchors = self._anchors
        stream = pending[-1][5]
        tries = 0
        while not anchors:
            # the stream drained by the caller's fetch; the last try
            # takes the record however long it took
            tries += 1
            stream.synchronize()
            anchor = _anchor_event(
                stream, ANCHOR_RECORD_S if tries < 100 else float("inf"))
            if anchor is not None:
                anchor[0].synchronize()
                anchors.append(anchor)
        for name, sp, start, end, before, _stream in pending:
            seconds = start.elapsed_time(end) / 1e3
            self.records[name].append(seconds)
            if sp is not None:
                if before:
                    event, host = anchors[before - 1]
                    offset_ms = event.elapsed_time(start)
                else:
                    event, host = anchors[0]
                    offset_ms = -start.elapsed_time(event)
                sp.start = host + offset_ms / 1e3
                sp.duration = seconds
                sp.tracer.record(sp)
        self._anchors = anchors[-1:]

    def record(self, name: str, seconds: float) -> None:
        if self.enabled:
            self.records[name].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        self.resolve()
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

        self.resolve()
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


#: the longest an anchor's record call may take, in seconds: the card
#: stamps the event inside the call, so half of it bounds the error
ANCHOR_RECORD_S = 50e-6


def _anchor_event(stream, limit: float = ANCHOR_RECORD_S) -> tuple | None:
    """``(event, host time)``: a timing event recorded on ``stream``,
    which the caller saw empty, so the card stamps it while the record
    call runs; the host time is the call's midpoint on the tracer's
    clock. None when the call took longer than ``limit`` (a cold
    context, a preempted thread)."""
    event = torch.cuda.Event(enable_timing=True)
    t0 = tracing.now()
    event.record(stream)
    t1 = tracing.now()
    if t1 - t0 > limit:
        return None
    return event, (t0 + t1) / 2


class ProfilerTrace:
    """The Chrome trace :func:`trace` wrote (``path``), with its window
    on the tracer's clock (``start``, ``end``, seconds).

    ``torch.profiler`` stamps its events in wall-clock microseconds less
    the file's ``baseTimeNanoseconds``; the tracer's spans are
    wall-clock seconds as of import (:func:`~predictionio_tpu_torch.obs.
    tracing.clock_drift`). :meth:`overlay` puts spans on the file's time
    base, so a span file and the profiler file overlay in Perfetto."""

    #: pid of the first span process merged into a profiler file (clear
    #: of the profiler's own: process ids and device indices)
    PID_BASE = 1 << 30

    def __init__(self, path: str):
        self.path = path
        self.start = tracing.now()
        self.end = self.start
        self._drift_us = tracing.clock_drift() * 1e6

    def overlay(self, spans: dict) -> dict:
        """``spans`` (a ``Tracer.chrome_trace()``) placed on this file's
        time base, returned; the placed spans that overlap the traced
        window are merged into the file, each trace a process of its
        own. With no file written (the block raised), ``spans`` as
        given."""
        try:
            with open(self.path, encoding="utf-8") as f:
                prof = json.load(f)
        except FileNotFoundError:
            return spans
        shift = self._drift_us - prof.get("baseTimeNanoseconds", 0) / 1e3
        placed = copy.deepcopy(spans)
        for ev in placed["traceEvents"]:
            if "ts" in ev:
                ev["ts"] = round(ev["ts"] + shift, 3)
        lo = self.start * 1e6 + shift
        hi = self.end * 1e6 + shift
        inside = [ev for ev in placed["traceEvents"] if ev["ph"] == "X"
                  and ev["ts"] <= hi and ev["ts"] + ev["dur"] >= lo]
        pids = {ev["pid"] for ev in inside}
        names = [ev for ev in placed["traceEvents"]
                 if ev["ph"] == "M" and ev["pid"] in pids]
        prof.setdefault("traceEvents", []).extend(
            dict(ev, pid=self.PID_BASE + ev["pid"]) for ev in names + inside)
        with open(self.path, "w", encoding="utf-8") as f:
            json.dump(prof, f, default=str)
        return placed


@contextlib.contextmanager
def trace(trace_dir: str | None = None):
    """``torch.profiler`` over the block (host ops, and the card's
    kernels when CUDA is available), written as one Chrome trace
    ``torch_<pid>_<id>.trace.json`` into ``trace_dir`` or
    ``PIO_TRACE_DIR``; transparent when neither is set. Yields the
    :class:`ProfilerTrace` (None when transparent): once the block is
    done, its ``overlay`` merges spans into the file."""
    trace_dir = trace_dir or os.environ.get("PIO_TRACE_DIR")
    if not trace_dir:
        yield None
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
    out = ProfilerTrace(path)
    with profile(activities=activities) as prof:
        yield out
    out.end = tracing.now()
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

    * ``torch_trace/`` — the ``torch.profiler`` output, with the spans
      of the window merged in
    * ``spans.json`` — the tracing flight recorder's chrome trace, on
      the profiler file's time base
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
    with trace(trace_dir) as prof:
        time.sleep(max(0.0, duration_s))
    elapsed = time.perf_counter() - t0
    tracer = tracer if tracer is not None else tracing.get_tracer()
    spans = prof.overlay(tracer.chrome_trace())
    with open(os.path.join(artifact_dir, "spans.json"), "w") as f:
        json.dump(spans, f, default=str)
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
