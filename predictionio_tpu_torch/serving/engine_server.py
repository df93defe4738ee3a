"""Engine Server — the predict REST service.

Counterpart of ``EngineServer`` and ``create_engine_server`` in
``predictionio_tpu/serving/engine_server.py`` for the serving slice:

* ``GET  /``                   → status JSON (instance, warmup, counts;
  the pool and its tenants in multi-tenant mode), or the HTML status
  page when the client prefers ``text/html``
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
* ``POST /debug/profile``      → a ``torch.profiler`` capture of
  ``durationMs`` (bounded by ``PIO_PROFILE_MAX_MS``) with the tracer's
  spans and a device sample, as a base64 ``tar.gz``; one at a time
  (409 on overlap)
* ``GET  /metrics``, ``/metrics.json``, ``/debug/traces``,
  ``/debug/traces.json``, ``/debug/timeline.json``, ``/plugins.json``,
  ``/plugins/outputsniffer/<name>/<path>``

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

Multi-tenant mode (``tenants={name: engine_variant}``): one process
serves many engine variants through a byte-budgeted
:class:`~predictionio_tpu_torch.serving.modelpool.ModelPool` on the
card. A query names its tenant by ``accessKey`` or ``X-PIO-Tenant``
(400 without one, 404 for an unknown one); the tenant's staged
generation (its tables in f32, or int8 + scale or bf16 under
``quantize`` / ``PIO_POOL_QUANT``) is pinned from submit through
collect, so an eviction never frees a table a launch still reads; a
cold tenant loads on the pool's one loader thread and a request waiting
past its predict timeout gets 503 with ``Retry-After``. ``/reload
{"tenant": ...}`` restages that tenant alone. The canary and the
tenants exclude each other.

A ``server_config`` (default: the environment's) gives the listener TLS
and key-auths ``/reload``, ``/stop``, ``/debug/profile`` and the
``/debug`` telemetry; queries stay open. ``feedback`` stores a
``predict`` event (entity ``pio_pr``) for every answer into
``feedback_app_id`` and injects its ``prId`` (the query cache is off
then); ``log_url`` ships every serving failure but a shed to a
collector from one bounded sender thread; ``plugins`` fold output
blockers over each answer and hand it to the output sniffers.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import datetime as _dt
import html as _html
import json
import logging
import os
import queue
import secrets
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any

from predictionio_tpu_torch.core.controller import Algorithm
from predictionio_tpu_torch.core.engine import Engine, EngineParams
from predictionio_tpu_torch.core.workflow import load_deployment
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.obs import MetricRegistry, get_registry
from predictionio_tpu_torch.obs import timeline as timeline_mod
from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.obs.device import CompileTracker, DeviceSampler
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving import admission as admission_mod
from predictionio_tpu_torch.serving import canary as canary_mod
from predictionio_tpu_torch.serving import modelpool as modelpool_mod
from predictionio_tpu_torch.serving import querycache as querycache_mod
from predictionio_tpu_torch.serving import resilience
from predictionio_tpu_torch.serving.batching import (
    BatcherClosed,
    BatcherOverloaded,
    MicroBatcher,
    TwoPhaseBatchFn,
)
from predictionio_tpu_torch.serving.http import (  # noqa: F401
    HTTPError,
    HTTPServer,
    Request,
    Response,
    Router,
    install_metrics_routes,
    undeploy_existing,
)
from predictionio_tpu_torch.serving.plugins import (
    OUTPUT_SNIFFER,
    PluginContext,
    install_plugin_routes,
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
        feedback: bool = False,
        feedback_app_id: int | None = None,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        max_queue: int | None = None,
        pipeline_depth: int = 2,
        adaptive_wait: bool = True,
        warmup: bool = True,
        quantize: str | None = None,
        predict_timeout_s: float = 30.0,
        plugins: PluginContext | None = None,
        server_config=None,
        log_url: str | None = None,
        log_prefix: str = "",
        registry: MetricRegistry | None = None,
        tracer: tracing.Tracer | None = None,
        admission: bool | admission_mod.AdmissionController = True,
        canary: bool | canary_mod.CanaryConfig = False,
        tenants: dict[str, str] | None = None,
        pool: modelpool_mod.ModelPool | None = None,
        cache: bool | querycache_mod.QueryCache | None = None,
    ):
        self._quantize = (
            quantize
            if quantize is not None
            else os.environ.get("PIO_POOL_QUANT", "").strip()
        )
        if self._quantize and self._quantize not in ("int8", "bf16"):
            raise ValueError(
                f"unknown quantize mode {self._quantize!r} "
                "(expected int8, bf16, or empty)"
            )
        if log_url:
            parsed = urllib.parse.urlsplit(log_url)
            if parsed.scheme not in ("http", "https") or not parsed.netloc:
                # fail at deploy, not per failing query
                raise ValueError(
                    f"--log-url {log_url!r} is not an http(s) URL"
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
        self._feedback = feedback
        self._feedback_app_id = feedback_app_id
        self._max_batch = max_batch
        self._max_wait_ms = max_wait_ms
        self._max_queue = max_queue
        self._pipeline_depth = pipeline_depth
        self._adaptive_wait = adaptive_wait
        self._warmup = warmup
        self._predict_timeout_s = predict_timeout_s
        self._plugins = plugins or PluginContext()
        self._log_url = log_url
        self._log_prefix = log_prefix
        # a bounded handoff to one sender thread: a slow or dead
        # collector must never grow threads or block serving. The thread
        # starts at the end of __init__ (a later failure here would leak
        # it) and close() stops it with a None sentinel.
        self._log_queue: queue.Queue | None = (
            queue.Queue(maxsize=64) if log_url else None
        )
        if server_config is None:
            from predictionio_tpu_torch.serving.config import ServerConfig

            server_config = ServerConfig.from_env()
        self._server_config = server_config

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
        self._tenants = dict(tenants) if tenants else None
        if self._tenants is not None and self._canary_config is not None:
            # a tenant's reload is immediate; the shadow canary assumes
            # one serving generation a process
            raise ValueError(
                "canary and multi-tenant mode are mutually exclusive"
            )
        self._pool: modelpool_mod.ModelPool | None = None
        self._owns_pool = False
        #: tenant → reload count and newest instance (under self._lock;
        #: the labelled generation and age gauges read these)
        self._tenant_generations: dict[str, int] = {}
        self._tenant_instances: dict[str, Any] = {}
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
        if self._tenants is None:
            self._age_gauge.labels("").set_function(
                self._model_age_seconds
            )
        # card memory gauges (started by serve()) and the warm-up's
        # compile counters: a warm-up bucket's first launch is where the
        # kernel library is built and loaded
        self._device_sampler = DeviceSampler(self._registry)
        self._compile_tracker = CompileTracker(self._registry)
        #: one profile capture at a time (the profiler is process-wide),
        #: a flag under self._lock, never a lock held across the capture
        self._profile_active = False
        if cache is None:
            cache = querycache_mod.cache_enabled_from_env()
        if cache and self._feedback:
            # every feedback answer carries a fresh prId and records an
            # event: answers are not replayable
            logger.warning(
                "serving cache disabled: incompatible with feedback mode"
            )
            cache = False
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
        #: flush epoch per tenant ("" in single-tenant mode), part of the
        #: cache key: every swap bumps it, so a child generation of the
        #: same lineage still changes every key
        self._cache_epochs: dict[str, int] = {}
        self._batchers: list[MicroBatcher] = []
        if self._tenants is None:
            self._load()
        else:
            self._instance = None
            self._serving = None
            if pool is not None:
                self._pool = pool
            else:
                self._pool = modelpool_mod.ModelPool(
                    registry=self._registry, timeline=self._timeline,
                )
                self._owns_pool = True
            self._preload_tenants()

        self.router = Router()
        self.router.route("GET", "/", self._status)
        self.router.route("POST", "/queries.json", self._queries)
        self.router.route(
            "POST", "/batch/queries.json", self._batch_queries
        )
        self.router.route("POST", "/reload", self._reload)
        self.router.route("GET", "/canary", self._canary_status)
        self.router.route("POST", "/stop", self._stop)
        self.router.route("POST", "/debug/profile", self._debug_profile)
        install_metrics_routes(
            self.router, self._registry, self._tracer,
            server_config=self._server_config,
            timeline=self._timeline,
        )
        install_plugin_routes(self.router, self._plugins, OUTPUT_SNIFFER)
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
        self._closed = False
        if self._log_queue is not None:
            threading.Thread(
                target=self._drain_log_queue,
                name="remote-error-log",
                daemon=True,
            ).start()

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
    def _bump_cache_generation(
        self, reason: str, tenant: str = "", generation=None
    ) -> None:
        """Invalidate the cache for one tenant ("" = the single-tenant
        namespace): bump its flush epoch so new lookups miss by key at
        once, then drop its resident entries (one
        ``cache_flush{reason}`` timeline event). Every swap path comes
        here: ``/reload`` (a tenant's too), canary promotion and
        rollback."""
        if self._cache is None:
            return
        with self._lock:
            self._cache_epochs[tenant] = self._cache_epochs.get(tenant, 0) + 1
        self._cache.flush(
            tenant if tenant else None,
            reason=reason,
            generation=(
                str(generation) if generation is not None else None
            ),
        )

    def _cache_token(self, tenant: str) -> str | None:
        """Generation token of the cache keys: the serving instance id
        and the tenant's flush epoch. None (compute, skip the cache)
        while the tenant has no instance yet: a hit must never force a
        pool load or take a pin."""
        with self._lock:
            if self._tenants is None:
                instance = self._instance
            else:
                instance = self._tenant_instances.get(tenant)
            epoch = self._cache_epochs.get(tenant, 0)
        if instance is None:
            return None
        return f"{instance.id}:{epoch}"

    def _cache_bypass(self, request: Request) -> bool:
        """``Cache-Control: no-cache`` (or ``no-store``) bypasses the
        cache: the read-your-writes escape hatch."""
        directives = (
            request.headers.get(querycache_mod.CACHE_CONTROL_HEADER)
            or ""
        ).lower()
        return "no-cache" in directives or "no-store" in directives

    # -- multi-tenant pool ------------------------------------------------
    def _tenant_age_seconds(self, tenant: str) -> float:
        with self._lock:
            instance = self._tenant_instances.get(tenant)
        if instance is None:
            return 0.0
        age = (
            _dt.datetime.now(_dt.timezone.utc) - instance.end_time
        ).total_seconds()
        return max(0.0, age)

    def _tenant_loader(self, tenant: str):
        """The pool's loader for one tenant: stage the tenant's engine
        variant (host load, staging on the card, quantization, warm-up,
        all on the pool's loader thread, never a request thread),
        advance its labelled generation and age, and hand the pool the
        staged generation with its bytes on the card. Its close ends the
        batchers; the pool then drops the generation, and its tables go
        with it."""

        def load():
            staged = self._stage(
                engine_variant=self._tenants[tenant], tenant=tenant
            )
            with self._lock:
                generation = self._tenant_generations.get(tenant, 0) + 1
                first = tenant not in self._tenant_generations
                self._tenant_generations[tenant] = generation
                self._tenant_instances[tenant] = staged.instance
            self._generation_gauge.labels(tenant).set(generation)
            if first:
                self._age_gauge.labels(tenant).set_function(
                    lambda t=tenant: self._tenant_age_seconds(t)
                )
            logger.info(
                "tenant %r serving instance %s (variant %r, "
                "generation %d, %d bytes)",
                tenant, staged.instance.id, self._tenants[tenant],
                generation, staged.nbytes,
            )

            def close():
                for b in staged.batchers:
                    b.close()

            return staged, staged.nbytes, close

        return load

    def _preload_tenants(self) -> None:
        """Load every tenant once through the pool (LRU keeps what fits
        the budget; the rest load again on their next query). The
        server reads warm once every tenant's warm-up ran."""
        warmed_all = True
        for tenant in self._tenants:
            with self._pool.pin(
                tenant, self._tenant_loader(tenant)
            ) as staged:
                warmed_all = warmed_all and staged.warmed
        self._warmed_gauge.set(1 if warmed_all else 0)
        logger.info(
            "multi-tenant server preloaded %d tenant(s), %d resident",
            len(self._tenants), len(self._pool.resident()),
        )

    def _resolve_tenant(self, request: Request) -> str:
        """A request's tenant: the ``accessKey`` query param, then the
        ``X-PIO-Tenant`` header (the admission controller's fair-share
        order)."""
        tenant = (
            request.query.get("accessKey")
            or request.headers.get(admission_mod.TENANT_HEADER)
            or ""
        )
        if not tenant:
            raise HTTPError(
                400,
                "multi-tenant server requires an accessKey query "
                f"param or {admission_mod.TENANT_HEADER} header",
            )
        if tenant not in self._tenants:
            raise HTTPError(404, f"unknown tenant {tenant!r}")
        return tenant

    @contextlib.contextmanager
    def _serving_snapshot(self, request: Request):
        """Yield ``(serving, batchers)`` for one request: the serving
        pointers in single-tenant mode; in multi-tenant mode the
        tenant's pool entry, pinned for the scope (submit through
        collect), so an eviction racing the query never closes the
        generation, nor frees the tables, under it."""
        if self._tenants is None:
            with self._lock:
                serving = self._serving
                batchers = self._batchers
            yield serving, batchers
            return
        tenant = self._resolve_tenant(request)
        try:
            with self._pool.pin(
                tenant,
                self._tenant_loader(tenant),
                timeout=self._predict_timeout_s,
            ) as staged:
                yield staged.serving, staged.batchers
        except modelpool_mod.PoolLoadTimeout:
            raise HTTPError(
                503,
                f"tenant {tenant!r} is still loading; retry",
                headers={
                    "Retry-After": admission_mod.format_retry_after(1.0)
                },
            ) from None
        except modelpool_mod.PoolLoadError as exc:
            raise HTTPError(
                500, f"tenant {tenant!r} failed to load: {exc}"
            ) from exc

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

    def _stage(
        self,
        for_canary: bool = False,
        engine_variant: str | None = None,
        tenant: str | None = None,
    ) -> _StagedGeneration:
        """Load, stage, optionally quantize and warm the newest loadable
        generation and build its batchers, without touching the serving
        pointers: the canary path scores it beside live traffic before
        :meth:`_activate` (or a promotion) ever runs.

        ``tenant`` stages one pooled tenant's variant: its batchers and
        warm-up sites are named per tenant, and the server's warm gauge
        is left alone (a tenant loading under traffic must not flap
        it)."""
        if not for_canary and tenant is None:
            # the gauge describes the newest generation, cold until its
            # warm-up ends; a canary leaves it alone, since the warm old
            # generation keeps serving
            self._warmed_gauge.set(0)
        instance, algorithms, models, serving = load_deployment(
            self._engine,
            self._params,
            engine_id=self._engine_id,
            engine_version=self._engine_version,
            engine_variant=(
                engine_variant
                if engine_variant is not None
                else self._engine_variant
            ),
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
        name_prefix = (
            f"{self._engine_id}/{tenant}/"
            if tenant is not None
            else f"{self._engine_id}/"
        )
        warmed = bool(
            self._warmup
            and self._precompile(algorithms, models, name_prefix)
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
                name=f"{name_prefix}algo{i}",
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

    def _precompile(self, algorithms, models, name_prefix: str) -> bool:
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
            batcher_name = f"{name_prefix}algo{i}"
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
                # the serving mesh: a model axis above 1 means the
                # factor catalog is row-sharded over the devices
                "mesh": {
                    str(name): int(size)
                    for name, size in self._ctx.mesh.shape.items()
                },
                "modelSharded": self._ctx.model_parallelism > 1,
                "device": str(self._ctx.device),
                "quantize": self._quantize,
                "canaryState": (
                    self._canary.state
                    if self._canary is not None
                    else (self._last_canary or {}).get(
                        "state", canary_mod.IDLE
                    )
                ),
                "startTime": self._start_time.isoformat(),
                "requestCount": self._request_count,
                "avgServingSec": round(self._avg_serving_sec, 6),
                "lastServingSec": round(self._last_serving_sec, 6),
                "lastBatchPerQuerySec": round(
                    self._last_batch_per_query_sec, 6
                ),
            }
            if self._tenants is None:
                data["engineInstanceId"] = self._instance.id
                data["generation"] = self._generation
                data["modelBytes"] = self._nbytes
                data["warmed"] = self._warmed
                data["trainingStartTime"] = (
                    self._instance.start_time.isoformat()
                )
                data["trainingEndTime"] = (
                    self._instance.end_time.isoformat()
                )
            else:
                data["multiTenant"] = True
                data["tenants"] = sorted(self._tenants)
                data["tenantGenerations"] = dict(self._tenant_generations)
        if self._tenants is not None:
            # the pool's own lock, never under ours
            data["pool"] = self._pool.stats()
        if self._cache is not None:
            # the cache's shard locks, never under ours
            data["cache"] = self._cache.stats()
        return data

    def _status(self, request: Request) -> Response:
        data = self._status_data()
        if "text/html" in (request.headers.get("Accept") or ""):
            # the reference's status page (twirl index.scala.html)
            return Response(
                200, self._status_html(data), content_type="text/html"
            )
        return Response(200, data)

    def _status_html(self, data: dict) -> str:
        e = _html.escape

        def table(rows: list[tuple[str, str]]) -> str:
            return "<table>" + "".join(
                f"<tr><th>{e(k)}</th><td>{e(v)}</td></tr>"
                for k, v in rows
            ) + "</table>"

        def params_rows(named) -> list[tuple[str, str]]:
            name, params = named
            return [("Class", name or type(params).__name__),
                    ("Parameters", repr(params))]

        p = self._params
        algo_rows: list[tuple[str, str]] = []
        for i, (name, params) in enumerate(p.algorithms):
            algo_rows.append((f"Algorithm {i}", name))
            algo_rows.append((f"Algorithm {i} Parameters", repr(params)))
        title = (
            f"{e(self._engine_id)} ({e(self._engine_variant)}) - "
            "Engine Server"
        )
        return f"""<!DOCTYPE html>
<html lang="en">
  <head>
    <title>{title}</title>
    <style>
      body {{ font-family: sans-serif; margin: 2em; }}
      table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
      th, td {{ border: 1px solid #ccc; padding: 4px 10px;
               font-family: monospace; text-align: left; }}
      th {{ background: #f3f3f3; }}
    </style>
  </head>
  <body>
    <h1>Engine Server</h1>
    <p>{e(self._engine_id)} {e(self._engine_version)}
       ({e(self._engine_variant)})</p>
    <h2>Engine Information</h2>
    {table([
        ("Training Start Time", data.get("trainingStartTime", "-")),
        ("Training End Time", data.get("trainingEndTime", "-")),
        ("Variant ID", data["engineVariant"]),
        ("Instance ID", data.get("engineInstanceId", "-")),
        ("Tenants", ", ".join(data.get("tenants", [])) or "-"),
    ])}
    <h2>Server Information</h2>
    {table([
        ("Start Time", data["startTime"]),
        ("Request Count", str(data["requestCount"])),
        ("Average Serving Time", f'{data["avgServingSec"]} seconds'),
        ("Last Serving Time", f'{data["lastServingSec"]} seconds'),
        ("Last Batch Per-Query Time",
         f'{data["lastBatchPerQuerySec"]} seconds'),
    ])}
    <h2>Data Source</h2>
    {table(params_rows(p.data_source))}
    <h2>Data Preparator</h2>
    {table(params_rows(p.preparator))}
    <h2>Algorithms</h2>
    {table(algo_rows)}
    <h2>Serving</h2>
    {table(params_rows(p.serving))}
  </body>
</html>"""

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
        resolves a live canary in favour of what is serving first. In
        multi-tenant mode it restages one tenant. Key-gated."""
        self._server_config.check_key(request)
        body: Any = {}
        if request.body:
            try:
                body = request.json()
            except Exception:  # noqa: BLE001 - bad body is a 400
                raise HTTPError(400, "reload body must be JSON") from None
        if not isinstance(body, dict):
            raise HTTPError(400, "reload body must be a JSON object")
        if self._tenants is not None:
            return self._reload_tenant(request, body)
        want_canary = body.get("canary")
        if want_canary is None:
            want_canary = self._canary_config is not None
        with self._reload_mutex:
            if not want_canary:
                # an explicit immediate reload supersedes whatever the
                # canary was evaluating — resolved deterministically
                # BEFORE the swap so a late watch verdict cannot roll a
                # freshly-loaded generation back to an ancient one. The
                # ≤0.15 s settle-retry inside deliberately holds the
                # reload mutex: serializing reloads behind a racing
                # verdict applier is the point of the mutex.
                # pio-lint: disable-next=lock-blocking -- bounded 0.15s settle; reload serialization is intentional
                self._cancel_active_canary("superseded by manual reload")
                self._load()
                with self._lock:
                    instance_id = self._instance.id
                return Response(
                    200, {"message": "reloaded", "engineInstanceId": instance_id}
                )
            return self._start_canary()

    def _reload_tenant(self, request: Request, body: dict) -> Response:
        """Restage one tenant's variant through the pool. Its in-flight
        queries keep the old generation pinned until they end; the other
        tenants are untouched."""
        tenant = (
            body.get("tenant")
            or request.query.get("accessKey")
            or request.headers.get(admission_mod.TENANT_HEADER)
            or ""
        )
        if not tenant:
            raise HTTPError(
                400,
                'multi-tenant reload requires a tenant (body '
                '{"tenant": ...}, accessKey param, or '
                f"{admission_mod.TENANT_HEADER} header)",
            )
        if tenant not in self._tenants:
            raise HTTPError(404, f"unknown tenant {tenant!r}")
        with self._reload_mutex:
            try:
                self._pool.replace(tenant, self._tenant_loader(tenant))
            except Exception as exc:  # noqa: BLE001 - surfaced as 500
                self._timeline.record(
                    "tenant_reload",
                    f"tenant {tenant!r} reload failed: {exc}",
                    severity=timeline_mod.ERROR, tenant=tenant,
                )
                raise HTTPError(
                    500, f"tenant {tenant!r} reload failed: {exc}"
                ) from exc
            with self._lock:
                generation = self._tenant_generations.get(tenant, 0)
                instance = self._tenant_instances.get(tenant)
            self._bump_cache_generation(
                "foldin"
                if getattr(instance, "batch", "") == "fold-in"
                else "reload",
                tenant=tenant,
                generation=getattr(instance, "id", generation),
            )
            self._timeline.record(
                "tenant_reload",
                f"tenant {tenant!r} reloaded to generation {generation}",
                tenant=tenant, generation=generation,
            )
        return Response(
            200,
            {"message": "reloaded", "tenant": tenant,
             "generation": generation},
        )

    def _stop(self, request: Request) -> Response:
        self._server_config.check_key(request)
        if self._http is not None:
            threading.Thread(
                target=self._http.shutdown, daemon=True
            ).start()
        return Response(200, {"message": "stopping"})

    def _queries(self, request: Request) -> Response:
        return self._with_remote_log(self._queries_inner, request)

    def _batch_queries(self, request: Request) -> Response:
        return self._with_remote_log(self._batch_queries_inner, request)

    def _with_remote_log(self, handler, request: Request) -> Response:
        try:
            return handler(request)
        except Exception as exc:
            # the remote error log (reference CreateServer.scala:446-457):
            # a serving failure goes to the collector before the error
            # answer goes out. Sheds (503) are left out: logging each
            # would amplify the overload that shedding protects against.
            shed = isinstance(exc, HTTPError) and exc.status == 503
            if self._log_queue is not None and not shed:
                self._post_remote_log(exc, request)
            raise

    #: a report carries at most this much of the failing query body: the
    #: 64-slot queue bounds bytes, not only entries
    _LOG_QUERY_LIMIT = 4096

    def _post_remote_log(self, exc: Exception, request: Request) -> None:
        """Queue an error report for the sender thread. Nothing here may
        raise: the serving error must reach the client as it is."""
        try:
            body = request.body[: self._LOG_QUERY_LIMIT]
            payload = json.dumps(
                {
                    "message":
                        f"{self._log_prefix}{type(exc).__name__}: {exc}",
                    "engineInstance": {
                        "engineId": self._engine_id,
                        "engineVersion": self._engine_version,
                        "engineVariant": self._engine_variant,
                    },
                    "query": body.decode("utf-8", "replace"),
                    "queryTruncated":
                        len(request.body) > self._LOG_QUERY_LIMIT,
                }
            ).encode("utf-8")
            self._log_queue.put_nowait(payload)
        except queue.Full:
            logger.debug("remote error log queue full; report dropped")
        except Exception as enc_exc:  # noqa: BLE001 - must not mask exc
            logger.debug("remote error log encode failed: %s", enc_exc)

    def _drain_log_queue(self) -> None:
        while True:
            payload = self._log_queue.get()
            if payload is None:  # close() sentinel
                return
            try:
                req = urllib.request.Request(
                    self._log_url,
                    data=payload,
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                urllib.request.urlopen(req, timeout=5).read()
            except Exception as send_exc:  # noqa: BLE001 - best effort
                logger.debug("remote error log failed: %s", send_exc)

    def _queries_inner(self, request: Request) -> Response:
        t0 = time.perf_counter()
        query = request.json()
        if not isinstance(query, dict):
            raise HTTPError(400, "query must be a JSON object")
        claim = None
        if self._cache is not None and not self._cache_bypass(request):
            tenant = (
                "" if self._tenants is None
                else self._resolve_tenant(request)
            )
            token = self._cache_token(tenant)
            if token is not None:
                # after admission (the HTTP tier admitted us), before the
                # batcher: a hit or a coalesced waiter takes no batcher
                # slot, no pool pin, and launches nothing
                claim = self._cache.claim(
                    tenant, token,
                    querycache_mod.canonical_query_bytes(query),
                )
                if claim.hit:
                    return self._cached_response(claim.value, "hit", t0)
                if not claim.leader:
                    return self._join_coalesced(claim, t0)
        try:
            return self._compute_query(request, query, t0, claim)
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
        self,
        request: Request,
        query: dict,
        t0: float,
        claim: querycache_mod.Claim | None,
    ) -> Response:
        for _attempt in range(2):
            # the snapshot holds the tenant's pool pin (multi-tenant) over
            # the whole submit → collect span
            with self._serving_snapshot(request) as (serving, batchers):
                supplemented = serving.supplement(query)
                futures = []
                # a single-flight leader submits at the highest class of
                # its waiters: a critical waiter must not sit behind a
                # sheddable leader's slot
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
                    # earlier algorithms' accepted submits must not run
                    # for nothing
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
                    # (a new pin in multi-tenant mode)
                    self._abandon(futures)
                    continue
                try:
                    prediction = self._serve_one(
                        serving, query, supplemented, futures
                    )
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
                    # a serving error feeds the post-promotion watch
                    # (sheds and expiries indict the load, not the model)
                    self._canary_observe(
                        supplemented, None, time.perf_counter() - t0,
                        ok=False,
                    )
                    raise
                elapsed = time.perf_counter() - t0
                self._count_request(elapsed)
                self._canary_observe(
                    supplemented, prediction, elapsed, ok=True
                )
                if claim is not None:
                    # serialized once, by the call the dict response path
                    # uses, so hits and coalesced answers are
                    # byte-identical to uncached ones; fill wakes every
                    # coalesced waiter
                    body = json.dumps(prediction).encode("utf-8")
                    self._cache.fill(claim, body)
                    return Response(
                        200, body,
                        headers={querycache_mod.CACHE_HEADER: "miss"},
                    )
                return Response(200, prediction)
        raise HTTPError(503, "server is reloading; retry")

    def _serve_one(self, serving, query, supplemented, futures,
                   deadline=None):
        """Collect one query's per-algorithm futures, then the shared tail
        of the single and batch routes: serve → feedback → the output
        blockers and sniffers (CreateServer.scala:603-606). The total
        wait is bounded by ``deadline`` (a ``time.monotonic()`` value,
        default one predict timeout from now), further capped by the
        request's ``X-PIO-Deadline``."""
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
        prediction = serving.serve(supplemented, predictions)
        if self._feedback:
            prediction = self._record_feedback(query, prediction)
        engine_info = {
            "engineId": self._engine_id,
            "engineVersion": self._engine_version,
            "engineVariant": self._engine_variant,
        }
        prediction = self._plugins.block_output(
            engine_info, query, prediction
        )
        self._plugins.sniff_output(engine_info, query, prediction)
        return prediction

    def _record_feedback(self, query: dict, prediction):
        """Store a ``predict`` event (entity ``pio_pr``) carrying the
        query and the answer, and inject its ``prId`` into the answer
        (reference CreateServer.scala:539-600). A failed store is logged
        and never fails the query."""
        pr_id = None
        if isinstance(prediction, dict):
            pr_id = prediction.get("prId")
        pr_id = pr_id or secrets.token_hex(16)
        try:
            with self._lock:
                instance = self._instance
            event = Event(
                event="predict",
                entity_type="pio_pr",
                entity_id=pr_id,
                properties=DataMap(
                    {
                        "engineInstanceId": (
                            instance.id if instance is not None else ""
                        ),
                        "query": query,
                        "prediction": prediction,
                    }
                ),
            )
            app_id = self._feedback_app_id
            if app_id is not None:
                with tracing.span("store/insert_event", kind="feedback"):
                    self._storage.get_events().insert(event, app_id)
        except Exception:  # noqa: BLE001 - feedback must not break serving
            logger.exception("feedback event failed")
        if isinstance(prediction, dict):
            prediction = {**prediction, "prId": pr_id}
        return prediction

    #: queries per /batch/queries.json call, bounding one request's memory
    MAX_QUERY_BATCH = 100

    def _batch_queries_inner(self, request: Request) -> Response:
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
            # the pin (multi-tenant) spans the submits and the collection
            with self._serving_snapshot(request) as (serving, batchers):
                entries, any_submitted = self._submit_batch(
                    serving, batchers, payload
                )
                if _attempt == 0 and not any_submitted and any(
                    e[0] == "reloading" for e in entries
                ):
                    # a /reload raced us before any submit was accepted:
                    # nothing was dispatched, so a retry is safe
                    continue
                results = self._collect_batch(
                    serving, entries, payload, request
                )
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

    def _collect_batch(self, serving, entries, payload, request) -> list[dict]:
        # one deadline for the whole batch: a hung launch must not hold
        # the connection for N sequential predict timeouts
        deadline = time.monotonic() + self._predict_timeout_s
        results = []
        logged = False  # one remote report a batch, not one a slot
        for (state, data, futures), q in zip(entries, payload):
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
                if self._log_queue is not None and not logged:
                    self._post_remote_log(data, request)
                    logged = True
                results.append({"status": 500, "message": str(data)})
            else:
                try:
                    prediction = self._serve_one(
                        serving, q, data, futures, deadline=deadline
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
                    if self._log_queue is not None and not logged:
                        self._post_remote_log(exc, request)
                        logged = True
                    results.append(
                        {"status": exc.status, "message": exc.message}
                    )
                except Exception as exc:  # noqa: BLE001 - per-slot status
                    if self._log_queue is not None and not logged:
                        self._post_remote_log(exc, request)
                        logged = True
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
        prediction = staged.serving.serve(supplemented, predictions)
        if self._feedback and isinstance(prediction, dict):
            # as on the serving side (_canary_observe): only what the
            # model answered enters the divergence score
            prediction = {
                k: v for k, v in prediction.items() if k != "prId"
            }
        return prediction

    def _canary_observe(
        self, supplemented, prediction, elapsed_s: float, ok: bool
    ) -> None:
        """Request-path canary hook: feed the baseline and the watch,
        maybe queue a shadow score, and apply a pending verdict."""
        canary = self._canary
        if canary is None:
            return
        if self._feedback and isinstance(prediction, dict):
            # feedback injected a random prId after serving; the shadow
            # path runs no feedback, so leaving it in would score a
            # key mismatch on every shadow sample and veto every canary
            prediction = {
                k: v for k, v in prediction.items() if k != "prId"
            }
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

    def _debug_profile(self, request: Request) -> Response:
        """Key-gated profile capture: a duration-bounded
        ``torch.profiler`` trace (the card's kernels among its events)
        with the flight recorder's spans and a device sample of the same
        window, returned as a base64 ``tar.gz``. One at a time (the
        profiler is process-wide): 409 on overlap."""
        self._server_config.check_key(request)
        body = request.json() if request.body else {}
        if body is None:
            body = {}
        if not isinstance(body, dict):
            raise HTTPError(400, "body must be a JSON object")
        max_ms = max(
            50.0, resilience._env_float("PIO_PROFILE_MAX_MS", 30000.0)
        )
        try:
            duration_ms = float(body.get("durationMs", 1000.0))
        except (TypeError, ValueError):
            raise HTTPError(400, "durationMs must be a number")
        duration_ms = min(max_ms, max(50.0, duration_ms))
        with self._lock:
            # a flag, not a held lock: the capture sleeps for durationMs
            # and must not block the status and metrics readers
            if self._profile_active:
                raise HTTPError(
                    409, "a profile capture is already running"
                )
            self._profile_active = True
        try:
            manifest = profiling.capture(
                duration_ms / 1000.0,
                tracer=self._tracer,
                device_sample_fn=self._device_sampler.sample_once,
            )
            bundle = profiling.bundle(manifest["artifactDir"])
        finally:
            with self._lock:
                self._profile_active = False
        return Response(
            200,
            {
                "profile": manifest,
                "bundle": base64.b64encode(bundle).decode("ascii"),
            },
        )

    # -- lifecycle --------------------------------------------------------
    def serve(
        self,
        host: str = "0.0.0.0",
        port: int = 8000,
        bind_retries: int = 3,
        undeploy_first: bool = True,
        reuse_port: bool = False,
    ) -> HTTPServer:
        """Bind the REST service: the undeploy-before-deploy handshake
        on a fixed port, then the bind with retries (reference
        MasterActor StartServer → undeploy() → BindServer with retry 3,
        CreateServer.scala:280-378). A re-exec'd ``--workers`` child
        binds with ``reuse_port`` and ``undeploy_first=False``: it must
        not stop its own parent. The caller starts it with ``start()`` or
        ``serve_forever()``; its shutdown (``POST /stop`` included)
        closes the batchers, and its ``drain()`` closes them after the
        in-flight requests have finished."""
        if undeploy_first and port:
            undeploy_existing(host, port, self._server_config)
        last_exc: OSError | None = None
        for attempt in range(max(1, bind_retries)):
            try:
                # enforce_key=False: TLS still applies, but the key is
                # asked per route (/reload, /stop, /debug); queries stay
                # open
                self._http = HTTPServer(
                    self.router, host=host, port=port,
                    server_config=self._server_config, enforce_key=False,
                    reuse_port=reuse_port,
                    service="engine", registry=self._registry,
                    tracer=self._tracer,
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
        """Close every generation's batchers (the serving one, a live
        canary's staged or retained one, every pooled tenant's through
        the pool it owns), then the cache, the device sampler, the
        plugins and the remote log's sender. Queued queries still
        complete. A second call does nothing."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
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
        if self._pool is not None and self._owns_pool:
            # ends the loader thread and closes every resident tenant
            self._pool.close()
        if self._cache is not None:
            # fails still-coalesced waiters instead of stranding them
            self._cache.close()
        self._device_sampler.stop()
        self._plugins.close()
        if self._log_queue is not None:
            # stop the sender, so a retired server can be collected; a
            # full queue is being drained (at most 5 s a send), so a
            # bounded wait suffices, after which the daemon thread is
            # left to the process's exit
            try:
                self._log_queue.put(None, timeout=10)
            except queue.Full:
                logger.debug("remote error log sender did not stop")

    def close(self) -> None:
        """Stop the HTTP listener (when serving) and close the batchers:
        queued queries still complete."""
        if self._http is not None:
            self._http.shutdown()
            self._http = None
        self._close_serving()


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
