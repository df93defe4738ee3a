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
  trainer's fresh generation reaches a running server
* ``POST /stop``               → ``{"message": "stopping"}``; the listener
  shuts down from a thread of its own (a handler cannot wait for the
  loop it runs in), then the batchers close, so the process exits

``serve`` first posts ``/stop`` to whatever engine server holds the port
(:func:`undeploy_existing`, the undeploy-before-deploy handshake), then
binds with retries.

The deployed generation is staged on the card once
(``load_deployment`` → ``Algorithm.stage_model``), optionally quantized
to int8 or bf16, and every power-of-two batch bucket up to ``max_batch``
is run once before traffic (warmup builds and loads the kernel library).
Admission control, the query cache, canary promotion (``/reload`` with
``{"canary": true}``), the tenant pool (the per-tenant ``/reload``),
feedback events, the metrics routes and the remote error log come with
later slices (ROADMAP.md, queue 1, item 5a); the constructor does not
accept their options, and ``/reload`` answers 400 to theirs.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
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
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving.batching import (
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
)
from predictionio_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _StagedGeneration:
    """One loaded generation: its instance record, serving layer and
    warmed batchers."""

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
        warmup: bool = True,
        quantize: str | None = None,
        predict_timeout_s: float = 30.0,
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
        self._warmup = warmup
        self._quantize = quantize or ""
        self._predict_timeout_s = predict_timeout_s

        self._lock = threading.Lock()
        self._request_count = 0
        self._last_serving_sec = 0.0
        self._last_batch_per_query_sec = 0.0
        self._avg_serving_sec = 0.0
        self._start_time = _dt.datetime.now(_dt.timezone.utc)
        self._generation = 0
        self._batchers: list[MicroBatcher] = []
        self._reload_mutex = threading.Lock()
        self._load()

        self.router = Router()
        self.router.route("GET", "/", self._status)
        self.router.route("POST", "/queries.json", self._queries)
        self.router.route(
            "POST", "/batch/queries.json", self._batch_queries
        )
        self.router.route("POST", "/reload", self._reload)
        self.router.route("POST", "/stop", self._stop)
        self._http: HTTPServer | None = None

    # -- model loading ----------------------------------------------------
    def _load(self) -> None:
        """Load the latest generation and swap it in immediately (the
        initial load, and ``/reload``)."""
        self._activate(self._stage())

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
        for b in old:
            b.close()
        logger.info(
            "engine server serving instance %s (%d algorithm(s))",
            staged.instance.id, len(staged.batchers),
        )

    def _stage(self) -> _StagedGeneration:
        """Load, stage, optionally quantize and warm the newest loadable
        generation, and build its batchers."""
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
                # completer is still collecting batch N
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
        here instead of in a request. Algorithms expose a neutral
        ``warmup_query`` (default ``{}``; ``None`` = serve cold).

        Returns True when every attempted bucket ran. One failing bucket
        does not skip the rest; three failures stop an algorithm's
        warmup."""
        t0 = time.perf_counter()
        total_failures = 0
        for algo, model in zip(algorithms, models):
            name = type(algo).__name__
            query = getattr(algo, "warmup_query", lambda: {})()
            if query is None:
                logger.info("%s: no warmup query — serving cold", name)
                continue
            bucket, failures = 1, 0
            while True:
                try:
                    algo.batch_predict(model, [query] * bucket)
                except Exception as e:  # noqa: BLE001 - warmup best-effort
                    failures += 1
                    logger.warning(
                        "%s: warmup failed at batch %d: %s", name, bucket, e
                    )
                    if failures >= 3:
                        break
                if bucket >= self._max_batch:
                    break
                bucket *= 2
            total_failures += failures
        profiling.sync()
        logger.info("warmup finished in %.1fs", time.perf_counter() - t0)
        return total_failures == 0

    # -- routes -----------------------------------------------------------
    def _status_data(self) -> dict:
        with self._lock:
            return {
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

    def _status(self, request: Request) -> Response:
        return Response(200, self._status_data())

    def _snapshot(self):
        with self._lock:
            return self._serving, self._batchers

    def _reload(self, request: Request) -> Response:
        """The immediate ``/reload``: restage the newest loadable
        COMPLETED generation and swap it in. Canary promotion and the
        per-tenant form are not ported yet."""
        body: Any = {}
        if request.body:
            try:
                body = request.json()
            except Exception:  # noqa: BLE001 - bad body is a 400
                raise HTTPError(400, "reload body must be JSON") from None
        if not isinstance(body, dict):
            raise HTTPError(400, "reload body must be a JSON object")
        if body.get("canary"):
            raise HTTPError(
                400,
                "canary reload is not ported yet (ROADMAP.md, queue 1, "
                "item 5a); reload without it swaps immediately",
            )
        if body.get("tenant"):
            raise HTTPError(
                400,
                "per-tenant reload needs the multi-tenant model pool, "
                "which is not ported yet (ROADMAP.md, queue 1, item 5a)",
            )
        with self._reload_mutex:
            self._load()
            with self._lock:
                instance_id = self._instance.id
        return Response(
            200, {"message": "reloaded", "engineInstanceId": instance_id}
        )

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
        for _attempt in range(2):
            serving, batchers = self._snapshot()
            supplemented = serving.supplement(query)
            futures = []
            try:
                for b in batchers:
                    futures.append(b.submit(supplemented))
            except BatcherOverloaded:
                # earlier algorithms' accepted submits must not run for
                # nothing
                self._abandon(futures)
                raise HTTPError(
                    503, "server overloaded; retry later",
                    headers={"Retry-After": "1"},
                )
            except RuntimeError:
                # /reload swapped and closed the batchers between the
                # snapshot and the submit: retry against the new ones
                self._abandon(futures)
                continue
            prediction = self._serve_one(serving, supplemented, futures)
            elapsed = time.perf_counter() - t0
            with self._lock:
                self._request_count += 1
                self._last_serving_sec = elapsed
                self._avg_serving_sec += (
                    elapsed - self._avg_serving_sec
                ) / self._request_count
            return Response(200, prediction)
        raise HTTPError(503, "server is reloading; retry")

    def _serve_one(self, serving, supplemented, futures, deadline=None):
        """Collect one query's per-algorithm futures (the total wait is
        bounded by ``deadline``, a ``time.monotonic()`` value, default
        one predict timeout from now) and combine them."""
        if deadline is None:
            deadline = time.monotonic() + self._predict_timeout_s
        try:
            predictions = [
                f.result(timeout=max(0.001, deadline - time.monotonic()))
                for f in futures
            ]
        except FuturesTimeout:
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
        ``("bad"|"shed"|"reloading", None, None)`` | ``("error", exc,
        None)``. ``any_submitted`` is True once any submit was accepted,
        which is when a whole-batch retry would dispatch twice."""
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
            except RuntimeError:
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
            elif state == "error":
                results.append({"status": 500, "message": str(data)})
            else:
                try:
                    prediction = self._serve_one(
                        serving, data, futures, deadline=deadline
                    )
                    results.append({"status": 200, "prediction": prediction})
                except HTTPError as exc:
                    results.append(
                        {"status": exc.status, "message": exc.message}
                    )
                except Exception as exc:  # noqa: BLE001 - per-slot status
                    results.append({"status": 500, "message": str(exc)})
        return results

    @staticmethod
    def _abandon(futures) -> None:
        """Cancel accepted submits whose query is being given up, so the
        batcher drops them before launch."""
        for f in futures:
            f.cancel()

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
        closes the batchers."""
        if port:
            undeploy_existing(host, port)
        last_exc: OSError | None = None
        for attempt in range(max(1, bind_retries)):
            try:
                self._http = HTTPServer(
                    self.router, host=host, port=port, service="engine"
                )
                self._http.add_shutdown_hook(self._close_batchers)
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

    def _close_batchers(self) -> None:
        with self._lock:
            batchers = self._batchers
            self._batchers = []
        for b in batchers:
            b.close()

    def close(self) -> None:
        """Stop the HTTP listener (when serving) and close the batchers:
        queued queries still complete."""
        if self._http is not None:
            self._http.shutdown()
            self._http = None
        self._close_batchers()


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
