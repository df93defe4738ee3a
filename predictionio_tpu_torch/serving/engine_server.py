"""Engine Server — the predict REST service.

Counterpart of ``EngineServer`` and ``create_engine_server`` in
``predictionio_tpu/serving/engine_server.py`` for the serving slice:

* ``GET  /``                   → status JSON (instance, warmup, counts)
* ``POST /queries.json``       → one query: supplement → per-algorithm
  micro-batcher → serve → JSON
* ``POST /batch/queries.json`` → up to 100 queries in one round trip,
  each with its own status; all are submitted before any is collected,
  so they coalesce into full kernel launches
* ``POST /reload``             → stage the newest loadable COMPLETED
  generation and swap it in (``{"message": "reloaded",
  "engineInstanceId": ...}``); a corrupt newest generation is
  quarantined and the last good one keeps serving. Queries racing the
  swap retry once against the new batchers, which is how a continuous
  trainer's fresh generation reaches a running server. With
  ``{"canary": true}`` (or a server built with ``canary``) it answers
  202 and stages the generation *beside* the serving one: a sampled
  share of live queries is shadow-scored on it, and it is promoted on
  a clean gate, watched, and rolled back on a regression
  (:mod:`~predictionio_tpu_torch.serving.canary`)
* ``GET  /canary``             → the canary's state and counts
* ``POST /stop``               → ``{"message": "stopping"}``; the listener
  shuts down from a thread of its own (a handler cannot wait for the
  loop it runs in), then the batchers close, so the process exits
* ``GET  /metrics``, ``/metrics.json``, ``/debug/traces``,
  ``/debug/traces.json``, ``/debug/timeline.json``

``serve`` first posts ``/stop`` to whatever engine server holds the port
(:func:`undeploy_existing`, the undeploy-before-deploy handshake), then
binds with retries.

The deployed generation is staged on the card once
(``load_deployment`` → ``Algorithm.stage_model``), optionally quantized
to int8 or bf16, and every power-of-two batch bucket up to ``max_batch``
is run once before traffic (warmup builds and loads the kernel library).
Under load, as in the JAX package: the adaptive admission controller
(on by default; its floor keeps one full pipeline of batches
admissible) sheds by criticality class before the batcher sees the
request; the generation-keyed query cache (``PIO_CACHE`` or ``cache``)
answers a repeated query with the bytes it served, or joins an
identical query in flight, before the batcher, so neither launches a
kernel; every swap (``/reload``, promotion, rollback) bumps the cache
token. A shed carries ``Retry-After`` and ``X-PIO-Shed``; an expired
``X-PIO-Deadline`` is a 504 and its slot is cut before the launch.

The tenant pool (the per-tenant ``/reload``), feedback events,
engine-server plugins, TLS and key auth, the remote error log, the HTML
status page and ``/debug/profile`` come with a later slice (ROADMAP.md,
queue 1, item 5a); the constructor does not accept their options, and
``/reload`` answers 400 to a tenant.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime as _dt
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any

from predictionio_tpu_torch.core.controller import Algorithm
from predictionio_tpu_torch.core.engine import Engine, EngineParams
from predictionio_tpu_torch.core.workflow import load_deployment
from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.obs import MetricRegistry, get_registry
from predictionio_tpu_torch.obs import timeline as timeline_mod
from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.obs.device import CompileTracker, DeviceSampler
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving import admission as admission_mod
from predictionio_tpu_torch.serving import canary as canary_mod
from predictionio_tpu_torch.serving import querycache as querycache_mod
from predictionio_tpu_torch.serving import resilience
from predictionio_tpu_torch.serving.batching import (
    BatcherClosed,
    BatcherOverloaded,
    MicroBatcher,
    TwoPhaseBatchFn,
)
from predictionio_tpu_torch.serving.http import (
    HTTPError,
    HTTPServer,
    Request,
    Response,
    Router,
    install_metrics_routes,
)
from predictionio_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _StagedGeneration:
    """One loaded generation: its instance record, serving layer and
    warmed batchers, buildable beside the serving one, so canary
    promotion and rollback are pointer swaps, not reloads."""

    instance: Any
    serving: Any
    batchers: list
    warmed: bool
    #: bytes the generation's models hold on the device
    nbytes: int = 0


class EngineServer:
    def __init__(
        self,
        engine: Engine,
        params: EngineParams,
        engine_id: str,
        engine_version: str = "1",
        engine_variant: str = "default",
        *,
        storage: Storage | None = None,
        ctx: ComputeContext | None = None,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        max_queue: int | None = None,
        pipeline_depth: int = 2,
        adaptive_wait: bool = True,
        warmup: bool = True,
        quantize: str | None = None,
        predict_timeout_s: float = 30.0,
        registry: MetricRegistry | None = None,
        tracer: tracing.Tracer | None = None,
        admission: bool | admission_mod.AdmissionController = True,
        canary: bool | canary_mod.CanaryConfig = False,
        cache: bool | querycache_mod.QueryCache | None = None,
    ):
        if quantize and quantize not in ("int8", "bf16"):
            raise ValueError(
                f"unknown quantize mode {quantize!r} "
                "(expected int8, bf16, or empty)"
            )
        self._engine = engine
        self._params = params
        self._engine_id = engine_id
        self._engine_version = engine_version
        self._engine_variant = engine_variant
        self._storage = storage or get_storage()
        self._ctx = ctx or ComputeContext.create(
            batch=f"serving:{engine_id}"
        )
        self._max_batch = max_batch
        self._max_wait_ms = max_wait_ms
        self._max_queue = max_queue
        self._pipeline_depth = pipeline_depth
        self._adaptive_wait = adaptive_wait
        self._warmup = warmup
        self._quantize = quantize or ""
        self._predict_timeout_s = predict_timeout_s

        self._lock = threading.Lock()
        self._request_count = 0
        self._last_serving_sec = 0.0
        self._last_batch_per_query_sec = 0.0
        self._avg_serving_sec = 0.0
        self._start_time = _dt.datetime.now(_dt.timezone.utc)
        self._registry = registry if registry is not None else get_registry()
        self._tracer = tracer if tracer is not None else tracing.get_tracer()
        # one bounded incident ring per process, served at
        # /debug/timeline.json and installed as the process-global one,
        # so canary verdicts, cache flushes and noisy-neighbor flags land
        # on it together
        self._timeline = timeline_mod.Timeline(registry=self._registry)
        timeline_mod.set_timeline(self._timeline)
        self._timeline.record(
            "server_start", f"engine server {engine_id!r} starting",
        )
        self._shed_wasted = self._registry.counter(
            "pio_shed_wasted_dispatch_total",
            "Per-algorithm dispatches abandoned by partially-shed batch "
            "slots that could not be cancelled before device dispatch",
        )
        if canary is True:
            self._canary_config = canary_mod.CanaryConfig.from_env()
        elif isinstance(canary, canary_mod.CanaryConfig):
            self._canary_config = canary
        else:
            self._canary_config = None
        self._canary: canary_mod.ShadowCanary | None = None
        self._last_canary: dict | None = None
        # serializes /reload: staging takes a warm-up, two reloads must
        # not both stage, and a manual reload supersedes a live canary
        self._reload_mutex = threading.Lock()
        self._generation = 0
        self._generation_gauge = self._registry.gauge(
            "pio_model_generation",
            "Monotonic count of model hot-swaps this process served "
            "(promotions AND rollbacks each advance it — every serving-"
            "model transition is scrape-visible; labeled per tenant in "
            "multi-tenant mode, empty label otherwise)",
            ("tenant",),
        )
        self._warmed_gauge = self._registry.gauge(
            "pio_warmup_complete",
            "1 once the newest generation's warmup compiled every "
            "attempted bucket; 0 while cold (warmup running, disabled, "
            "or every compile failed)",
        )
        self._age_gauge = self._registry.gauge(
            "pio_model_age_seconds",
            "Seconds since the serving generation finished training "
            "(freshness of the model users are hitting; labeled per "
            "tenant in multi-tenant mode, empty label otherwise)",
            ("tenant",),
        )
        self._age_gauge.labels("").set_function(self._model_age_seconds)
        # card memory gauges (started by serve()) and the warm-up's
        # compile counters: a warm-up bucket's first launch is where the
        # kernel library is built and loaded
        self._device_sampler = DeviceSampler(self._registry)
        self._compile_tracker = CompileTracker(self._registry)
        if cache is None:
            cache = querycache_mod.cache_enabled_from_env()
        if cache is True:
            self._cache: querycache_mod.QueryCache | None = (
                querycache_mod.QueryCache(
                    registry=self._registry, timeline=self._timeline
                )
            )
        elif isinstance(cache, querycache_mod.QueryCache):
            self._cache = cache
        else:
            self._cache = None
        #: flush epoch, part of the cache key: every swap bumps it, so a
        #: child generation of the same lineage still changes every key
        self._cache_epoch = 0
        self._batchers: list[MicroBatcher] = []
        self._load()

        self.router = Router()
        self.router.route("GET", "/", self._status)
        self.router.route("POST", "/queries.json", self._queries)
        self.router.route(
            "POST", "/batch/queries.json", self._batch_queries
        )
        self.router.route("POST", "/reload", self._reload)
        self.router.route("GET", "/canary", self._canary_status)
        self.router.route("POST", "/stop", self._stop)
        install_metrics_routes(
            self.router, self._registry, self._tracer,
            timeline=self._timeline,
        )
        # the limit follows observed latency; attached before serve() so
        # the HTTP server picks it up. Its floor keeps one full pipeline
        # of batches admissible, so the limit never starves the card.
        if admission is True:
            self.router.admission = admission_mod.AdmissionController.from_env(
                "engine", registry=self._registry,
                min_limit=float(
                    self._max_batch * (max(0, self._pipeline_depth) + 1)
                ),
            )
        elif isinstance(admission, admission_mod.AdmissionController):
            self.router.admission = admission
        self._http: HTTPServer | None = None

    # -- model loading ----------------------------------------------------
    def _model_age_seconds(self) -> float:
        instance = getattr(self, "_instance", None)
        if instance is None:
            return 0.0
        age = (
            _dt.datetime.now(_dt.timezone.utc) - instance.end_time
        ).total_seconds()
        return max(0.0, age)

    def _load(self) -> None:
        """Load the latest generation and swap it in immediately (the
        initial load, and ``/reload`` without a canary)."""
        self._activate(self._stage())

    # -- serving query cache ----------------------------------------------
    def _bump_cache_generation(self, reason: str, generation=None) -> None:
        """Invalidate the cache: bump the flush epoch so new lookups miss
        by key at once, then drop the resident entries (one
        ``cache_flush{reason}`` timeline event). Every swap path comes
        here: ``/reload``, canary promotion and rollback."""
        if self._cache is None:
            return
        with self._lock:
            self._cache_epoch += 1
        self._cache.flush(
            None, reason=reason,
            generation=(
                str(generation) if generation is not None else None
            ),
        )

    def _cache_token(self) -> str:
        """Generation token of the cache keys: the serving instance id
        and the flush epoch."""
        with self._lock:
            return f"{self._instance.id}:{self._cache_epoch}"

    def _cache_bypass(self, request: Request) -> bool:
        """``Cache-Control: no-cache`` (or ``no-store``) bypasses the
        cache: the read-your-writes escape hatch."""
        directives = (
            request.headers.get(querycache_mod.CACHE_CONTROL_HEADER)
            or ""
        ).lower()
        return "no-cache" in directives or "no-store" in directives

    def _activate(self, staged: _StagedGeneration) -> None:
        """Swap ``staged`` in, then close the old batchers: queries
        already submitted to them still complete, and a query whose
        submit loses the race retries against the new ones."""
        with self._lock:
            old = self._batchers
            self._instance = staged.instance
            self._serving = staged.serving
            self._batchers = staged.batchers
            self._warmed = staged.warmed
            self._nbytes = staged.nbytes
            self._generation += 1
            generation = self._generation
        self._generation_gauge.labels("").set(generation)
        self._warmed_gauge.set(1 if staged.warmed else 0)
        if generation > 1:
            # the answers just changed; a trainer's fold-in is flushed
            # under its own reason
            self._bump_cache_generation(
                "foldin"
                if getattr(staged.instance, "batch", "") == "fold-in"
                else "reload",
                generation=staged.instance.id,
            )
        for b in old:
            b.close()
        logger.info(
            "engine server serving instance %s (%d algorithm(s), "
            "generation %d)",
            staged.instance.id, len(staged.batchers), generation,
        )

    def _stage(self, for_canary: bool = False) -> _StagedGeneration:
        """Load, stage, optionally quantize and warm the newest loadable
        generation and build its batchers, without touching the serving
        pointers: the canary path scores it beside live traffic before
        :meth:`_activate` (or a promotion) ever runs."""
        if not for_canary:
            # the gauge describes the newest generation, cold until its
            # warm-up ends; a canary leaves it alone, since the warm old
            # generation keeps serving
            self._warmed_gauge.set(0)
        instance, algorithms, models, serving = load_deployment(
            self._engine,
            self._params,
            engine_id=self._engine_id,
            engine_version=self._engine_version,
            engine_variant=self._engine_variant,
            ctx=self._ctx,
            storage=self._storage,
        )
        from predictionio_tpu_torch.ops import quantize as quantize_mod

        if self._quantize:
            models = [
                quantize_mod.quantize_model_factors(m, self._quantize)
                for m in models
            ]
        nbytes = sum(quantize_mod.model_resident_bytes(m) for m in models)
        warmed = bool(
            self._warmup and self._precompile(algorithms, models)
        )

        def batch_fn(a, m):
            has_launch = (
                type(a).batch_predict_launch
                is not Algorithm.batch_predict_launch
            )
            has_collect = (
                type(a).batch_predict_collect
                is not Algorithm.batch_predict_collect
            )
            if has_launch and has_collect:
                # two-phase: the collector launches batch N+1 while the
                # completer still waits for batch N's copy back
                def dispatch(qs):
                    return a.batch_predict_launch(m, qs), qs

                def collect(state):
                    handle, qs = state
                    return a.batch_predict_collect(m, handle, qs)

                return TwoPhaseBatchFn(dispatch, collect)
            if has_launch != has_collect:
                logger.warning(
                    "%s overrides only one of batch_predict_launch/"
                    "batch_predict_collect — serving single-phase",
                    type(a).__name__,
                )

            def single(qs):
                out = a.batch_predict(m, qs)
                # the card finishes before the batcher stops its sync
                # clock, so pio_device_sync_seconds times the work
                profiling.sync()
                return out

            return single

        batchers = [
            MicroBatcher(
                batch_fn(algo, model),
                max_batch=self._max_batch,
                max_wait_ms=self._max_wait_ms,
                max_queue=self._max_queue,
                pipeline_depth=self._pipeline_depth,
                adaptive_wait=self._adaptive_wait,
                registry=self._registry,
                name=f"{self._engine_id}/algo{i}",
            )
            for i, (algo, model) in enumerate(zip(algorithms, models))
        ]
        return _StagedGeneration(
            instance=instance,
            serving=serving,
            batchers=batchers,
            warmed=warmed,
            nbytes=nbytes,
        )

    def _precompile(self, algorithms, models) -> bool:
        """Run every power-of-two batch bucket up to ``max_batch`` once
        before traffic: the first call builds and loads the kernel
        library, and each bucket's first launch pays its one-time costs
        here instead of in a request. Each bucket is one
        ``CompileTracker`` record at the batcher's site and one
        ``pio_warmup_seconds{batcher,bucket}`` reading. Algorithms
        expose a neutral ``warmup_query`` (default ``{}``; ``None`` =
        serve cold).

        Returns True when every attempted bucket ran. One failing bucket
        does not skip the rest; three failures stop an algorithm's
        warmup."""
        t0 = time.perf_counter()
        bucket_gauge = self._registry.gauge(
            "pio_warmup_seconds",
            "Wall time spent warming one power-of-two compile bucket "
            "(set whether the compile succeeded or failed)",
            ("batcher", "bucket"),
        )
        total_failures = 0
        for i, (algo, model) in enumerate(zip(algorithms, models)):
            name = type(algo).__name__
            batcher_name = f"{self._engine_id}/algo{i}"
            query = getattr(algo, "warmup_query", lambda: {})()
            if query is None:
                logger.info("%s: no warmup query — serving cold", name)
                continue
            bucket, failures = 1, 0
            while True:
                b0 = time.perf_counter()
                try:
                    algo.batch_predict(model, [query] * bucket)
                except Exception as e:  # noqa: BLE001 - warmup best-effort
                    failures += 1
                    logger.warning(
                        "%s: warmup failed at batch %d: %s", name, bucket, e
                    )
                finally:
                    bucket_gauge.labels(batcher_name, str(bucket)).set(
                        time.perf_counter() - b0
                    )
                    self._compile_tracker.record(batcher_name, str(bucket))
                if failures >= 3 or bucket >= self._max_batch:
                    break
                bucket *= 2
            total_failures += failures
        profiling.sync()
        logger.info("warmup finished in %.1fs", time.perf_counter() - t0)
        return total_failures == 0

    # -- routes -----------------------------------------------------------
    def _status_data(self) -> dict:
        with self._lock:
            data = {
                "status": "alive",
                "pid": os.getpid(),
                "engineId": self._engine_id,
                "engineVersion": self._engine_version,
                "engineVariant": self._engine_variant,
                "engineInstanceId": self._instance.id,
                "generation": self._generation,
                "device": str(self._ctx.device),
                "quantize": self._quantize,
                "modelBytes": self._nbytes,
                "warmed": self._warmed,
                "canaryState": (
                    self._canary.state
                    if self._canary is not None
                    else (self._last_canary or {}).get(
                        "state", canary_mod.IDLE
                    )
                ),
                "startTime": self._start_time.isoformat(),
                "trainingStartTime": self._instance.start_time.isoformat(),
                "trainingEndTime": self._instance.end_time.isoformat(),
                "requestCount": self._request_count,
                "avgServingSec": round(self._avg_serving_sec, 6),
                "lastServingSec": round(self._last_serving_sec, 6),
                "lastBatchPerQuerySec": round(
                    self._last_batch_per_query_sec, 6
                ),
            }
        if self._cache is not None:
            # the cache's shard locks, never under ours
            data["cache"] = self._cache.stats()
        return data

    def _status(self, request: Request) -> Response:
        return Response(200, self._status_data())

    def _snapshot(self):
        with self._lock:
            return self._serving, self._batchers

    def _shed_headers(self) -> dict[str, str]:
        """What a batcher shed carries: a ``Retry-After`` from live queue
        state (the deepest backlog of the algorithm batchers) and the
        ``X-PIO-Shed`` marker (nothing ran, so a retry is safe)."""
        with self._lock:
            batchers = self._batchers or ()
        hint = max(
            (b.retry_after_s() for b in batchers), default=0.05
        )
        return {
            "Retry-After": admission_mod.format_retry_after(hint),
            admission_mod.SHED_HEADER: "batcher",
        }

    def _reload(self, request: Request) -> Response:
        """``/reload``: with ``{"canary": true}`` (or on a server built
        with a canary) stage the newest generation beside the serving
        one and answer 202; otherwise restage and swap at once, which
        resolves a live canary in favour of what is serving first."""
        body: Any = {}
        if request.body:
            try:
                body = request.json()
            except Exception:  # noqa: BLE001 - bad body is a 400
                raise HTTPError(400, "reload body must be JSON") from None
        if not isinstance(body, dict):
            raise HTTPError(400, "reload body must be a JSON object")
        if body.get("tenant"):
            raise HTTPError(
                400,
                "per-tenant reload needs the multi-tenant model pool, "
                "which is not ported yet (ROADMAP.md, queue 1, item 5a)",
            )
        want_canary = body.get("canary")
        if want_canary is None:
            want_canary = self._canary_config is not None
        with self._reload_mutex:
            if not want_canary:
                self._cancel_active_canary("superseded by manual reload")
                self._load()
                with self._lock:
                    instance_id = self._instance.id
                return Response(
                    200, {"message": "reloaded", "engineInstanceId": instance_id}
                )
            return self._start_canary()

    def _stop(self, request: Request) -> Response:
        if self._http is not None:
            threading.Thread(
                target=self._http.shutdown, daemon=True
            ).start()
        return Response(200, {"message": "stopping"})

    def _queries(self, request: Request) -> Response:
        t0 = time.perf_counter()
        query = request.json()
        if not isinstance(query, dict):
            raise HTTPError(400, "query must be a JSON object")
        claim = None
        if self._cache is not None and not self._cache_bypass(request):
            # after admission (the HTTP tier admitted us), before the
            # batcher: a hit or a coalesced waiter takes no batcher slot
            # and launches nothing
            claim = self._cache.claim(
                "", self._cache_token(),
                querycache_mod.canonical_query_bytes(query),
            )
            if claim.hit:
                return self._cached_response(claim.value, "hit", t0)
            if not claim.leader:
                return self._join_coalesced(claim, t0)
        try:
            return self._compute_query(query, t0, claim)
        except BaseException as exc:
            if claim is not None:
                # the leader failed: wake every waiter with the real
                # error and clear the slot, so the next claimant leads
                self._cache.abort(claim, exc)
            raise

    def _count_request(self, elapsed: float) -> None:
        with self._lock:
            self._request_count += 1
            self._last_serving_sec = elapsed
            self._avg_serving_sec += (
                elapsed - self._avg_serving_sec
            ) / self._request_count

    def _cached_response(
        self, value: bytes, state: str, t0: float
    ) -> Response:
        """A response from the cache (``hit``) or from an identical
        query in flight (``coalesced``), with the ``X-PIO-Cache`` header.
        The canary does not observe it: near-zero latencies would skew
        its watch baseline."""
        self._count_request(time.perf_counter() - t0)
        return Response(
            200, value, headers={querycache_mod.CACHE_HEADER: state},
        )

    def _join_coalesced(
        self, claim: querycache_mod.Claim, t0: float
    ) -> Response:
        """Waiter side of single-flight: wait for the leader's bytes under
        this request's own budget. Expiry detaches the waiter without
        cancelling the leader; a leader's failure is this request's."""
        timeout = self._predict_timeout_s
        request_deadline = resilience.get_deadline()
        if request_deadline is not None:
            timeout = min(
                timeout,
                max(0.001,
                    request_deadline.expires_mono - time.monotonic()),
            )
        try:
            value = self._cache.join(claim, timeout)
        except querycache_mod.WaiterTimeout:
            raise HTTPError(
                504,
                "deadline expired while coalesced on an identical "
                "in-flight query",
            ) from None
        except querycache_mod.LeaderFailed as exc:
            cause = exc.__cause__
            if isinstance(cause, HTTPError):
                raise HTTPError(
                    cause.status, cause.message,
                    headers=dict(cause.headers) or None,
                ) from None
            raise HTTPError(
                500, f"coalesced computation failed: {cause}"
            ) from exc
        return self._cached_response(value, "coalesced", t0)

    def _compute_query(
        self, query: dict, t0: float, claim: querycache_mod.Claim | None
    ) -> Response:
        for _attempt in range(2):
            serving, batchers = self._snapshot()
            supplemented = serving.supplement(query)
            futures = []
            # a single-flight leader submits at the highest class of its
            # waiters: a critical waiter must not sit behind a sheddable
            # leader's slot
            escalate = (
                admission_mod.criticality(claim.criticality())
                if claim is not None
                else contextlib.nullcontext()
            )
            try:
                with escalate:
                    for b in batchers:
                        futures.append(b.submit(supplemented))
            except BatcherOverloaded:
                # earlier algorithms' accepted submits must not run for
                # nothing
                self._abandon(futures)
                raise HTTPError(
                    503, "server overloaded; retry later",
                    headers=self._shed_headers(),
                )
            except resilience.DeadlineExceeded:
                self._abandon(futures)
                raise HTTPError(504, "deadline expired before dispatch")
            except BatcherClosed:
                # /reload swapped and closed the batchers between the
                # snapshot and the submit: retry against the new ones
                self._abandon(futures)
                continue
            try:
                prediction = self._serve_one(serving, supplemented, futures)
            except resilience.DeadlineExceeded:
                # the batcher cut the slot before its launch: the
                # client's budget ran out while it was queued
                raise HTTPError(
                    504, "deadline expired before device dispatch"
                )
            except BatcherOverloaded:
                # evicted by a higher-criticality submission while it
                # waited: a shed, not a fault
                self._abandon([f for f in futures if not f.done()])
                raise HTTPError(
                    503, "shed under overload; retry later",
                    headers=self._shed_headers(),
                )
            except Exception:
                # a serving error feeds the post-promotion watch (sheds
                # and expiries indict the load, not the model)
                self._canary_observe(
                    supplemented, None, time.perf_counter() - t0, ok=False,
                )
                raise
            elapsed = time.perf_counter() - t0
            self._count_request(elapsed)
            self._canary_observe(supplemented, prediction, elapsed, ok=True)
            if claim is not None:
                # serialized once, by the call the dict response path
                # uses, so hits and coalesced answers are byte-identical
                # to uncached ones; fill wakes every coalesced waiter
                body = json.dumps(prediction).encode("utf-8")
                self._cache.fill(claim, body)
                return Response(
                    200, body,
                    headers={querycache_mod.CACHE_HEADER: "miss"},
                )
            return Response(200, prediction)
        raise HTTPError(503, "server is reloading; retry")

    def _serve_one(self, serving, supplemented, futures, deadline=None):
        """Collect one query's per-algorithm futures and combine them.
        The total wait is bounded by ``deadline`` (a ``time.monotonic()``
        value, default one predict timeout from now), further capped by
        the request's ``X-PIO-Deadline``."""
        if deadline is None:
            deadline = time.monotonic() + self._predict_timeout_s
        request_deadline = resilience.get_deadline()
        if request_deadline is not None:
            deadline = min(deadline, request_deadline.expires_mono)
        try:
            predictions = [
                f.result(timeout=max(0.001, deadline - time.monotonic()))
                for f in futures
            ]
        except FuturesTimeout:
            if request_deadline is not None and request_deadline.expired:
                # the client's budget ran out while the query was queued;
                # the batcher cuts the slot before its launch (counted
                # as expired there)
                raise resilience.DeadlineExceeded(
                    "deadline expired while queued for dispatch"
                ) from None
            self._abandon(futures)
            raise HTTPError(504, "prediction timed out") from None
        return serving.serve(supplemented, predictions)

    #: queries per /batch/queries.json call, bounding one request's memory
    MAX_QUERY_BATCH = 100

    def _batch_queries(self, request: Request) -> Response:
        t0 = time.perf_counter()
        payload = request.json()
        if not isinstance(payload, list):
            raise HTTPError(400, "batch must be a JSON array of queries")
        if len(payload) > self.MAX_QUERY_BATCH:
            raise HTTPError(
                400,
                f"batch too large: {len(payload)} queries "
                f"(max {self.MAX_QUERY_BATCH})",
            )
        if not payload:
            return Response(200, [])
        for _attempt in range(2):
            serving, batchers = self._snapshot()
            entries, any_submitted = self._submit_batch(
                serving, batchers, payload
            )
            if _attempt == 0 and not any_submitted and any(
                e[0] == "reloading" for e in entries
            ):
                # a /reload raced us before any submit was accepted:
                # nothing was dispatched, so a retry is safe
                continue
            results = self._collect_batch(serving, entries)
            break
        elapsed = time.perf_counter() - t0
        n = len(payload)
        with self._lock:
            self._request_count += n
            self._last_serving_sec = elapsed
            self._last_batch_per_query_sec = elapsed / n
            self._avg_serving_sec += (
                elapsed / n - self._avg_serving_sec
            ) * n / self._request_count
        return Response(200, results)

    def _submit_batch(self, serving, batchers, payload) -> tuple:
        """Submit every query; returns ``(entries, any_submitted)``.
        Entries: ``("ok", supplemented, futures)`` |
        ``("bad"|"shed"|"reloading"|"expired", None, None)`` |
        ``("error", exc, None)``. ``any_submitted`` is True once any
        submit was accepted, which is when a whole-batch retry would
        dispatch twice."""
        entries: list[tuple[str, Any, list | None]] = []
        reloading = False
        any_submitted = False
        for q in payload:
            if reloading:
                # /reload closed the snapshot's batchers mid-submit; the
                # accepted slots still run (the close is graceful)
                entries.append(("reloading", None, None))
                continue
            if not isinstance(q, dict):
                entries.append(("bad", None, None))
                continue
            try:
                supplemented = serving.supplement(q)
            except Exception as exc:  # noqa: BLE001 - per-slot status
                entries.append(("error", exc, None))
                continue
            futures = []
            try:
                for b in batchers:
                    futures.append(b.submit(supplemented))
                    any_submitted = True
            except BatcherOverloaded:
                self._abandon(futures)
                entries.append(("shed", None, None))
                continue
            except resilience.DeadlineExceeded:
                self._abandon(futures)
                entries.append(("expired", None, None))
                continue
            except BatcherClosed:
                self._abandon(futures)
                reloading = True
                entries.append(("reloading", None, None))
                continue
            entries.append(("ok", supplemented, futures))
        return entries, any_submitted

    def _collect_batch(self, serving, entries) -> list[dict]:
        # one deadline for the whole batch: a hung launch must not hold
        # the connection for N sequential predict timeouts
        deadline = time.monotonic() + self._predict_timeout_s
        results = []
        for state, data, futures in entries:
            if state == "bad":
                results.append(
                    {"status": 400, "message": "query must be a JSON object"}
                )
            elif state == "shed":
                results.append(
                    {"status": 503, "message": "server overloaded; retry later"}
                )
            elif state == "reloading":
                results.append(
                    {"status": 503, "message": "server is reloading; retry"}
                )
            elif state == "expired":
                results.append(
                    {"status": 504,
                     "message": "deadline expired before dispatch"}
                )
            elif state == "error":
                results.append({"status": 500, "message": str(data)})
            else:
                try:
                    prediction = self._serve_one(
                        serving, data, futures, deadline=deadline
                    )
                    results.append({"status": 200, "prediction": prediction})
                except resilience.DeadlineExceeded:
                    results.append(
                        {"status": 504,
                         "message": "deadline expired before device dispatch"}
                    )
                except BatcherOverloaded:
                    self._abandon([f for f in futures if not f.done()])
                    results.append(
                        {"status": 503,
                         "message": "shed under overload; retry later"}
                    )
                except HTTPError as exc:
                    results.append(
                        {"status": exc.status, "message": exc.message}
                    )
                except Exception as exc:  # noqa: BLE001 - per-slot status
                    results.append({"status": 500, "message": str(exc)})
        return results

    def _abandon(self, futures) -> None:
        """Cancel accepted submits whose query is being given up, so the
        batcher drops them before launch. A future past that point is
        launched work for nothing, counted in
        ``pio_shed_wasted_dispatch_total``."""
        for f in futures:
            if not f.cancel():
                self._shed_wasted.inc()

    # -- canary -----------------------------------------------------------
    def _cancel_active_canary(self, reason: str) -> None:
        """Resolve a live canary in favour of what is serving:
        shadowing → discard the staged generation; watching → keep the
        promoted one and release the retained one. Claims the verdict
        slot first, so no request thread applies a competing verdict; if
        one was already claimed, a short settle-retry lets its applier
        finish."""
        for _attempt in range(3):
            canary = self._canary
            if canary is None:
                return
            if canary.cancel(reason):
                if canary.state == canary_mod.WATCHING:
                    canary.finished(canary_mod.STABLE)
                    retained = canary.retained
                    if (
                        retained is not None
                        and retained.batchers is not self._batchers
                    ):
                        self._close_batchers_async(retained.batchers)
                else:
                    canary.finished(canary_mod.REJECTED)
                    if canary.staged.batchers is not self._batchers:
                        self._close_batchers_async(canary.staged.batchers)
                self._finish_canary(canary)
                return
            time.sleep(0.05)
        logger.warning(
            "could not cancel the active canary (verdict applier racing)"
        )

    def _start_canary(self) -> Response:
        active = self._canary
        if active is not None and active.state in (
            canary_mod.SHADOWING, canary_mod.WATCHING
        ):
            raise HTTPError(
                409,
                f"a canary is already {active.state}; wait for its "
                "verdict (GET /canary)",
            )
        staged = self._stage(for_canary=True)
        with self._lock:
            serving_id = self._instance.id
        if staged.instance.id == serving_id:
            self._close_batchers_async(staged.batchers)
            return Response(
                200,
                {
                    "message": "already serving the latest generation",
                    "engineInstanceId": serving_id,
                },
            )
        if self._warmup and not staged.warmed:
            # the gate needs a warm candidate; a generation whose
            # warm-up failed is refused with the old one untouched
            self._close_batchers_async(staged.batchers)
            raise HTTPError(
                409,
                f"canary rejected: generation {staged.instance.id} "
                "did not complete warmup",
            )
        fresh = canary_mod.ShadowCanary(
            staged,
            config=self._canary_config or canary_mod.CanaryConfig(),
            registry=self._registry,
            shadow_fn=self._shadow_score,
        )
        with self._lock:
            self._canary = fresh
        logger.info(
            "canary shadowing generation %s beside %s",
            staged.instance.id, serving_id,
        )
        return Response(
            202,
            {
                "message": "canary shadowing; promotion is gated on "
                           "live-traffic shadow scores (GET /canary)",
                "engineInstanceId": staged.instance.id,
                "state": canary_mod.SHADOWING,
            },
        )

    def _canary_status(self, request: Request) -> Response:
        canary = self._canary
        if canary is not None:
            data = canary.to_dict()
        else:
            data = self._last_canary or {"state": canary_mod.IDLE}
        with self._lock:
            data = {
                **data,
                "servingInstanceId": self._instance.id,
                "generation": self._generation,
            }
        return Response(200, data)

    def _shadow_score(self, supplemented):
        """Score one sampled query on the staged generation (the shadow
        worker thread only): it launches on the staged generation's
        batchers, on the card. A shed, an expiry, the shadow timeout or
        a closed batcher raises ``ShadowDropped``, never a veto; any
        other exception, a failed launch's ``RuntimeError`` included,
        propagates and vetoes the canary."""
        canary = self._canary
        if canary is None:
            raise canary_mod.ShadowDropped()
        staged = canary.staged
        timeout = (
            self._canary_config or canary_mod.CanaryConfig()
        ).shadow_timeout_s
        futures = []
        try:
            for b in staged.batchers:
                futures.append(b.submit(supplemented))
            predictions = [f.result(timeout=timeout) for f in futures]
        except (
            BatcherOverloaded,
            resilience.DeadlineExceeded,
            FuturesTimeout,
            BatcherClosed,
        ) as e:
            self._abandon([f for f in futures if not f.done()])
            raise canary_mod.ShadowDropped() from e
        return staged.serving.serve(supplemented, predictions)

    def _canary_observe(
        self, supplemented, prediction, elapsed_s: float, ok: bool
    ) -> None:
        """Request-path canary hook: feed the baseline and the watch,
        maybe queue a shadow score, and apply a pending verdict."""
        canary = self._canary
        if canary is None:
            return
        canary.observe(supplemented, prediction, elapsed_s, ok=ok)
        decision = canary.take_decision()
        if decision is not None:
            self._apply_canary_decision(canary, decision)

    def _apply_canary_decision(
        self, canary: canary_mod.ShadowCanary, decision: str
    ) -> None:
        """Apply a single-fire verdict on a request thread: swaps under
        the server lock, batcher teardown on a closer thread (``close``
        joins batcher threads)."""
        if decision == "promote":
            staged = canary.staged
            with self._lock:
                retained = _StagedGeneration(
                    instance=self._instance,
                    serving=self._serving,
                    batchers=self._batchers,
                    warmed=True,
                    nbytes=self._nbytes,
                )
                self._instance = staged.instance
                self._serving = staged.serving
                self._batchers = staged.batchers
                self._warmed = staged.warmed
                self._nbytes = staged.nbytes
                self._generation += 1
                generation = self._generation
            self._generation_gauge.labels("").set(generation)
            self._warmed_gauge.set(1 if staged.warmed else 0)
            self._bump_cache_generation(
                "promote", generation=staged.instance.id
            )
            canary.promoted(retained)
            self._timeline.record(
                "canary_verdict",
                f"canary PROMOTED instance {staged.instance.id} "
                f"(now generation {generation})",
                generation=generation, decision="promote",
            )
            logger.info(
                "canary PROMOTED generation %s (now generation %d); "
                "watching for regression, previous %s retained",
                staged.instance.id, generation, retained.instance.id,
            )
        elif decision == "reject":
            canary.finished(canary_mod.REJECTED)
            self._close_batchers_async(canary.staged.batchers)
            self._finish_canary(canary)
            self._timeline.record(
                "canary_verdict",
                f"canary REJECTED instance {canary.staged.instance.id}: "
                f"{canary.reason}",
                severity=timeline_mod.WARN, decision="reject",
            )
            logger.warning(
                "canary REJECTED generation %s: %s (still serving %s)",
                canary.staged.instance.id, canary.reason,
                self._instance.id,
            )
        elif decision == "rollback":
            retained = canary.retained
            rolled_back = canary.staged
            with self._lock:
                self._instance = retained.instance
                self._serving = retained.serving
                self._batchers = retained.batchers
                self._warmed = retained.warmed
                self._nbytes = retained.nbytes
                self._generation += 1
                generation = self._generation
            self._generation_gauge.labels("").set(generation)
            self._warmed_gauge.set(1 if retained.warmed else 0)
            # the rolled-back generation's answers must vanish from the
            # cache: the epoch bump renames every key
            self._bump_cache_generation(
                "rollback", generation=retained.instance.id
            )
            canary.finished(canary_mod.ROLLED_BACK)
            self._close_batchers_async(rolled_back.batchers)
            self._finish_canary(canary)
            self._timeline.record(
                "canary_verdict",
                f"canary ROLLED BACK to instance {retained.instance.id}: "
                f"{canary.reason}",
                severity=timeline_mod.ERROR, generation=generation,
                decision="rollback",
            )
            logger.warning(
                "canary ROLLED BACK to generation %s: %s",
                retained.instance.id, canary.reason,
            )
        elif decision == "stable":
            canary.finished(canary_mod.STABLE)
            self._close_batchers_async(canary.retained.batchers)
            self._finish_canary(canary)
            self._timeline.record(
                "canary_verdict",
                f"canary STABLE on instance {canary.staged.instance.id} "
                f"({canary.reason})",
                decision="stable",
            )
            logger.info(
                "canary STABLE on generation %s (%s)",
                canary.staged.instance.id, canary.reason,
            )

    def _finish_canary(self, canary: canary_mod.ShadowCanary) -> None:
        self._last_canary = canary.to_dict()
        # compare-and-clear under the lock: a late verdict applier must
        # not clear a newer canary a reload installed meanwhile
        with self._lock:
            if self._canary is canary:
                self._canary = None

    @staticmethod
    def _close_batchers_async(batchers) -> None:
        # close() lets the launched batches finish and joins the
        # batcher threads; a request thread must not wait for that
        threading.Thread(
            target=lambda: [b.close() for b in batchers],
            name="generation-close",
            daemon=True,
        ).start()

    # -- lifecycle --------------------------------------------------------
    def serve(
        self,
        host: str = "0.0.0.0",
        port: int = 8000,
        bind_retries: int = 3,
    ) -> HTTPServer:
        """Bind the REST service: the undeploy-before-deploy handshake
        on a fixed port, then the bind with retries (reference
        MasterActor StartServer → undeploy() → BindServer with retry 3,
        CreateServer.scala:280-378). The JAX package's
        ``undeploy_first=False`` serves only ``--reuse-port`` (ROADMAP.md,
        queue 1, item 5b). The caller starts it with ``start()`` or
        ``serve_forever()``; its shutdown (``POST /stop`` included)
        closes the batchers, and its ``drain()`` closes them after the
        in-flight requests have finished."""
        if port:
            undeploy_existing(host, port)
        last_exc: OSError | None = None
        for attempt in range(max(1, bind_retries)):
            try:
                self._http = HTTPServer(
                    self.router, host=host, port=port, service="engine",
                    registry=self._registry, tracer=self._tracer,
                )
                # once the listener stops (a drain ends in shutdown,
                # after the in-flight requests have left; /stop too) the
                # batchers close and the batch on the card completes
                self._http.add_shutdown_hook(self._close_serving)
                self._device_sampler.start()
                return self._http
            except OSError as exc:
                last_exc = exc
                if attempt + 1 >= bind_retries:
                    break
                logger.error(
                    "bind to %s:%d failed (%s); retrying", host, port, exc
                )
                time.sleep(1.0)
        raise last_exc  # type: ignore[misc]

    def _close_serving(self) -> None:
        """Close every generation's batchers (the serving one, and a live
        canary's staged or retained one), then the cache and the device
        sampler. Queued queries still complete."""
        with self._lock:
            canary = self._canary
            self._canary = None
            batchers = self._batchers
            self._batchers = []
        if canary is not None:
            canary.close()
            for gen in (canary.staged, canary.retained):
                if gen is None or gen.batchers is batchers:
                    continue
                for b in gen.batchers:
                    b.close()
        for b in batchers:
            b.close()
        if self._cache is not None:
            # fails still-coalesced waiters instead of stranding them
            self._cache.close()
        self._device_sampler.stop()

    def close(self) -> None:
        """Stop the HTTP listener (when serving) and close the batchers:
        queued queries still complete."""
        if self._http is not None:
            self._http.shutdown()
            self._http = None
        self._close_serving()


def undeploy_existing(host: str, port: int) -> bool:
    """POST /stop to whatever occupies ``host:port`` before binding
    there (reference MasterActor.undeploy, CreateServer.scala:280-305).
    Returns True if an old server acknowledged the stop. It stops an
    engine server of either package that serves plain HTTP without key
    auth; the JAX package's TLS and ``accessKey`` forms of the handshake
    come with the port's TLS and key auth (ROADMAP.md, queue 1, item
    5a), and until then the ``undeploy`` verb refuses them."""
    probe_host = "127.0.0.1" if host in ("0.0.0.0", "") else host
    url = f"http://{probe_host}:{port}/stop"
    logger.info(
        "Undeploying any existing engine instance at %s:%d",
        probe_host, port,
    )
    try:
        with urllib.request.urlopen(
            urllib.request.Request(url, method="POST"), timeout=5
        ) as resp:
            if resp.status == 200:
                # give the old server a moment to release the socket
                time.sleep(1.0)
                return True
            logger.error(
                "Existing server at %s:%d answered HTTP %d to /stop; "
                "unable to undeploy",
                probe_host, port, resp.status,
            )
    except urllib.error.HTTPError as exc:
        logger.error(
            "Another process is using %s:%d (HTTP %d on /stop). "
            "Unable to undeploy.",
            probe_host, port, exc.code,
        )
    except OSError:
        logger.debug("Nothing at %s:%d", probe_host, port)
    return False


def create_engine_server(
    engine: Engine,
    params: EngineParams,
    engine_id: str,
    host: str = "0.0.0.0",
    port: int = 8000,
    **kwargs,
) -> tuple[EngineServer, HTTPServer]:
    """Load and warm the deployment, then bind the REST service. The
    returned ``HTTPServer`` is not yet started."""
    server = EngineServer(engine, params, engine_id, **kwargs)
    return server, server.serve(host=host, port=port)
