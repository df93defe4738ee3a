"""Scale-out serving tier: a model-aware router over engine replicas.

Counterpart of ``predictionio_tpu/serving/router.py``, copied: the same
dispatch, breakers, failover, swaps, state file and federation, so both
packages' routers answer one script alike and adopt each other's state
files (``tests/test_torch_router.py``). It imports the standard library
and the port's torch-free modules only: a ``pio router`` process never
pays the torch import, and the replicas own the card.

One ``EngineServer`` process is one GIL; the router makes N replicas
look like one server — inference servers are cattle behind a thin
router, and model generations roll through them without a dropped
request. On one CUDA card every replica is a process with its own
context and its own copy of the tables, so N replicas share the card
through time-slicing.

The router consumes only the per-replica signals every server that
mounts the common telemetry surface
(:func:`~predictionio_tpu_torch.serving.http.install_metrics_routes`)
exports:

* ``GET /healthz`` — alive vs ``draining`` (the SIGTERM drain path);
* ``GET /metrics.json`` — ``pio_warmup_complete`` (a new generation is
  admitted only after every compile bucket warmed) and
  ``pio_server_draining``;
* per-replica :class:`~predictionio_tpu_torch.serving.resilience
  .CircuitBreaker` state from proxy outcomes (5xx / transport errors),
  so a sick replica is excluded and probed back in half-open;
* ``X-PIO-Deadline`` decrements across the router hop, and a
  transport-error/5xx failover retries ONCE against a different
  replica only while budget remains;
* ``X-Request-ID`` / ``X-Parent-Span`` forwarding, so one distributed
  trace spans client → router → replica.

Dispatch is least-inflight with consistent-hash affinity as the
tiebreaker: the replica with the least router-tracked in-flight work
wins; ties break on a stable hash ring keyed by ``X-PIO-Affinity``
(then the tenant, then the query body, then the client address), so
identical queries keep landing on the same replica's warm caches
without ever overriding load.

Rolling deploys (``POST /admin/swap``): register a new-generation
replica, admit it only once its warmup gauge reads 1, then drain the
old generation — excluded from selection immediately, in-flight
requests finish, and locally-supervised replicas (registered with a
``pid``) receive SIGTERM so their own graceful drain runs.

Fleet control plane: with a ``state_path`` the replica set and every
in-flight swap live in a checksummed, atomically-written state file,
re-adopted on restart — a router killed -9 mid-swap resumes the roll
(or safely aborts to the old generation) instead of forgetting its
fleet. Swaps are idempotent when keyed with a ``token``: re-driving the
same token (a respawned trainer) returns the existing record, so the
fleet-level shadow gate fires exactly once per generation. With a
``gate_config`` the swap mirrors a deterministic sample of live traffic
to the staged replica and applies the canary's divergence/NaN gate
(:mod:`~predictionio_tpu_torch.serving.canary`) fleet-wide before any
old replica drains; after promotion one old replica is parked as a
standby under a regression watch, and a regression rolls the whole
fleet back.

Metrics: ``pio_router_replica_healthy{replica}``,
``pio_router_inflight{replica}``, ``pio_router_failovers_total``,
``pio_router_requests_total{replica,status}``,
``pio_router_swaps_total{outcome}``, ``pio_router_shed_total``.
"""

from __future__ import annotations

import bisect
import datetime as _dt
import hashlib
import http.client
import json
import logging
import os
import signal
import threading
import time
import urllib.error
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable

from predictionio_tpu_torch.obs import MetricRegistry, get_registry
from predictionio_tpu_torch.obs import federation as federation_mod
from predictionio_tpu_torch.obs import timeline as timeline_mod
from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.obs.context import log_json
from predictionio_tpu_torch.obs.slo import SLOMonitor
from predictionio_tpu_torch.serving import admission, resilience
from predictionio_tpu_torch.serving.resilience import _env_float
from predictionio_tpu_torch.serving import canary as canary_mod
from predictionio_tpu_torch.serving import querycache as querycache_mod
from predictionio_tpu_torch.serving.http import (
    HTTPError,
    HTTPServer,
    Request,
    Response,
    Router,
    install_metrics_routes,
)

logger = logging.getLogger(__name__)

# -- replica lifecycle states ----------------------------------------------
#: registered, waiting for healthz ok + pio_warmup_complete=1
WARMING = "warming"
#: in the selection pool
HEALTHY = "healthy"
#: excluded from selection; in-flight work finishing (admin retire or
#: the replica's own /healthz says draining)
DRAINING = "draining"
#: probes failing — excluded until a probe succeeds again
UNHEALTHY = "unhealthy"
#: terminal: removed from the active pool by a retire/swap
RETIRED = "retired"

#: affinity header clients may set to pin related queries together
AFFINITY_HEADER = "X-PIO-Affinity"

#: prefix of a tenant's affinity key: such keys pin (see _candidates)
_TENANT_KEY_PREFIX = b"tenant:"

#: what a replica dying mid-exchange raises: a refused or reset
#: connection (``OSError``), or a response cut short after its headers
#: (``http.client.IncompleteRead`` and the other ``HTTPException``s,
#: which are not ``OSError``s). The JAX router catches only the first,
#: so a replica killed while it sends a body fails the request with a
#: 500 instead of failing over (ROADMAP.md §3).
_TRANSPORT_ERRORS = (OSError, http.client.HTTPException)

#: vnodes per replica on the consistent-hash ring — enough that
#: removing one replica only remaps ~1/N of the key space
_RING_VNODES = 32


def _hash64(data: bytes) -> int:
    return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")


#: completed (terminal-phase) swap records kept for GET /admin/swap/<id>
#: — a long-lived router behind a continuous trainer completes a swap
#: per generation, so the history must be bounded (in-flight swaps are
#: never garbage-collected)
_SWAP_HISTORY_KEEP = 20

#: swap phases. Ungated swaps keep the original warming → draining-old
#: → done | failed sequence; gated (fleet-promotion) swaps run the full
#: machine below.
SWAP_TERMINAL_PHASES = ("done", "failed", "rolled_back")


class RouterStateStore:
    """Checksummed, atomically-written router state. One JSON document: the schema tag, a UTC save
    stamp, the payload, and a SHA-256 over the payload's canonical
    encoding. A router restarting re-adopts the payload ONLY when the
    checksum verifies and the stamp is younger than ``max_age_s`` — a
    stale or torn file is discarded LOUDLY (warning log + a note the
    status route serves), never silently trusted: the world it
    describes may be long gone."""

    SCHEMA = "pio-router-state/v1"

    def __init__(self, path: str):
        self.path = path

    def save(self, payload: dict) -> None:
        from predictionio_tpu_torch.data.storage.localfs import (
            atomic_write_bytes,
        )

        # serialize ONCE and embed the parsed copy: checksumming one
        # encoding of the payload while writing a second would let any
        # concurrent mutation of a shared nested object produce a file
        # that fails its own checksum — and get discarded as torn on
        # the restart the file exists to protect
        body = json.dumps(payload, sort_keys=True)
        doc = {
            "schema": self.SCHEMA,
            "savedAtUtc": _dt.datetime.now(
                _dt.timezone.utc
            ).isoformat(timespec="seconds"),
            "checksum": hashlib.sha256(body.encode()).hexdigest(),
            "payload": json.loads(body),
        }
        atomic_write_bytes(
            self.path, json.dumps(doc, indent=1).encode()
        )

    def load(self, max_age_s: float) -> tuple[dict | None, str]:
        """(payload, discard_reason). A missing file is a quiet cold
        start (payload None, reason ""); anything unreadable, torn, or
        stale returns (None, <loud reason>)."""
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return None, ""
        except (OSError, ValueError) as e:
            return None, f"state file unreadable: {e}"
        if not isinstance(doc, dict) or doc.get("schema") != self.SCHEMA:
            return None, "state file has an unknown schema"
        payload = doc.get("payload")
        body = json.dumps(payload, sort_keys=True)
        if (
            hashlib.sha256(body.encode()).hexdigest()
            != doc.get("checksum")
        ):
            return None, "state file checksum mismatch (torn write?)"
        try:
            saved = _dt.datetime.fromisoformat(str(doc.get("savedAtUtc")))
            age_s = (
                _dt.datetime.now(_dt.timezone.utc) - saved
            ).total_seconds()
        except (TypeError, ValueError):
            return None, "state file save stamp unreadable"
        if age_s > max_age_s:
            return None, (
                f"state file is {age_s:.0f}s old (> {max_age_s:.0f}s "
                "adoption window); the fleet it describes may be gone"
            )
        if not isinstance(payload, dict):
            return None, "state payload is not an object"
        return payload, ""


class Replica:
    """One engine-server replica the router knows about."""

    def __init__(
        self,
        replica_id: str,
        url: str,
        generation: str = "",
        pid: int | None = None,
        registry: MetricRegistry | None = None,
        breaker_config: resilience.BreakerConfig | None = None,
    ):
        self.replica_id = replica_id
        self.url = url.rstrip("/")
        self.generation = generation
        #: local supervision: a pid lets the router SIGTERM the replica
        #: during a rolling swap so its own graceful drain runs
        self.pid = pid
        self.state = WARMING
        #: a fleet-gated swap registers its candidate STAGED: it warms
        #: and probes like any replica but is excluded from selection
        #: until the shadow gate promotes it — live traffic must not
        #: land on an unproven generation
        self.staged = False
        #: set by an admin retire/swap: the drain is STICKY — probes
        #: must not readmit this replica even while its process still
        #: answers ok (the router, not the replica, decided to drain)
        self.admin_draining = False
        #: monotonic instant until which this replica is SOFT-unhealthy:
        #: it answered 503 + Retry-After (its admission controller shed
        #: or it is draining), so it stays in the pool but is
        #: deprioritized — saturation is backpressure, not sickness
        self.saturated_until = 0.0
        self._lock = threading.Lock()
        self._inflight = 0
        self.probe_failures = 0
        self.last_probe: str = "never"
        #: last successful ``/metrics.json`` scrape, kept across probe
        #: failures: fleet federation serves a dead replica's final
        #: snapshot marked ``pio_federation_stale`` instead of letting
        #: one SIGKILLed process fail the whole fleet scrape
        self._metrics_snapshot: dict = {}
        self._metrics_stale = True
        #: last successful ``/debug/timeline.json`` scrape — same
        #: stale-not-absent semantics: a SIGKILLed replica's final
        #: events stay in the merged fleet timeline
        self._timeline_snapshot: dict = {}
        self._timeline_stale = True
        # NOT the process-global get_breaker map: two routers (or a
        # test building many) must not share breaker state for
        # same-named targets
        self.breaker = resilience.CircuitBreaker(
            f"replica:{replica_id}",
            config=breaker_config,
            registry=registry,
        )
        #: vnode points on the consistent-hash ring, precomputed once —
        #: selection must not pay 32 SHA1s per replica per request
        self.ring_points: tuple[int, ...] = tuple(
            sorted(
                _hash64(f"{replica_id}#{v}".encode())
                for v in range(_RING_VNODES)
            )
        )

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def begin(self) -> None:
        with self._lock:
            self._inflight += 1

    def end(self) -> None:
        with self._lock:
            self._inflight -= 1

    def mark_saturated(self, hint_s: float) -> None:
        """The replica shed with a Retry-After of ``hint_s``: treat it
        as saturated (soft-unhealthy) for that long, clamped to
        [0.05, 5] so a weird hint can't bench a replica for minutes."""
        self.saturated_until = time.monotonic() + min(
            5.0, max(0.05, hint_s)
        )

    @property
    def saturated(self) -> bool:
        return time.monotonic() < self.saturated_until

    def saturation_remaining_s(self) -> float:
        return max(0.0, self.saturated_until - time.monotonic())

    def store_metrics(self, payload: dict) -> None:
        """A fresh ``/metrics.json`` scrape landed (prober or
        federation fan-out)."""
        with self._lock:
            self._metrics_snapshot = payload
            self._metrics_stale = False

    def mark_metrics_stale(self) -> None:
        with self._lock:
            self._metrics_stale = True

    def metrics_state(self) -> tuple[dict, bool]:
        """``(last snapshot, stale?)`` — snapshot is ``{}`` until the
        first successful scrape."""
        with self._lock:
            return self._metrics_snapshot, self._metrics_stale

    def store_timeline(self, payload: dict) -> None:
        with self._lock:
            self._timeline_snapshot = payload
            self._timeline_stale = False

    def mark_timeline_stale(self) -> None:
        with self._lock:
            self._timeline_stale = True

    def timeline_state(self) -> tuple[dict, bool]:
        with self._lock:
            return self._timeline_snapshot, self._timeline_stale

    def to_dict(self) -> dict:
        return {
            "id": self.replica_id,
            "url": self.url,
            "generation": self.generation,
            "state": self.state,
            "staged": self.staged,
            "inflight": self.inflight,
            "breaker": self.breaker.state,
            "saturated": self.saturated,
            "lastProbe": self.last_probe,
            "pid": self.pid,
        }


def _metric_sample(data: dict, name: str, **labels) -> float | None:
    """Pull one sample value out of a ``/metrics.json`` payload."""
    try:
        for sample in data.get(name, {}).get("samples", ()):
            if all(
                sample.get("labels", {}).get(k) == v
                for k, v in labels.items()
            ):
                return float(sample.get("value", sample.get("count")))
    except (AttributeError, TypeError, ValueError):
        return None
    return None


def _sum_samples(data: dict, name: str) -> float | None:
    """Sum every sample of a family in a ``/metrics.json`` payload
    (e.g. HBM bytes across a replica's devices); None when absent."""
    try:
        samples = data.get(name, {}).get("samples", ())
    except AttributeError:
        return None
    total, seen = 0.0, False
    for sample in samples:
        try:
            total += float(sample.get("value", sample.get("count")))
            seen = True
        except (AttributeError, TypeError, ValueError):
            continue
    return total if seen else None


class _FleetFederation:
    """The scrape surface handed to ``install_metrics_routes``: each
    ``GET /metrics[.json]`` on the router fans out to the live fleet
    and re-renders it as one exposition."""

    def __init__(self, router: "ServingRouter"):
        self._router = router

    def render_text(self) -> str:
        return self._router.federated_text()

    def to_dict(self) -> dict:
        return self._router.federated_dict()


class _FleetTimeline:
    """Timeline surface handed to ``install_metrics_routes``: each
    ``GET /debug/timeline.json`` on the router fans out to the fleet
    and serves the time-merged incident narrative."""

    def __init__(self, router: "ServingRouter"):
        self._router = router

    def to_dict(self) -> dict:
        return self._router.federated_timeline()


class ServingRouter:
    """HTTP front tier dispatching queries across engine replicas.

    Mount with :meth:`serve` (or the ``pio-tpu router`` CLI verb).
    Thread-safety: the replica map is guarded by one lock; the probe
    loop, proxy handlers, and admin routes all go through it.
    """

    def __init__(
        self,
        replicas: Iterable[Replica] = (),
        *,
        probe_interval_s: float = 0.5,
        probe_timeout_s: float = 2.0,
        unhealthy_after: int = 2,
        failover_retries: int = 1,
        proxy_timeout_s: float = 30.0,
        drain_poll_s: float = 0.05,
        registry: MetricRegistry | None = None,
        tracer: tracing.Tracer | None = None,
        server_config=None,
        breaker_config: resilience.BreakerConfig | None = None,
        state_path: str = "",
        state_max_age_s: float = 300.0,
        gate_config: "canary_mod.CanaryConfig | None" = None,
        gate_timeout_s: float = 120.0,
        watch_timeout_s: float | None = None,
    ):
        self._registry = registry if registry is not None else get_registry()
        self._tracer = tracer if tracer is not None else tracing.get_tracer()
        if server_config is None:
            from predictionio_tpu_torch.serving.config import ServerConfig

            server_config = ServerConfig.from_env()
        self._server_config = server_config
        self._breaker_config = breaker_config
        self._probe_interval_s = probe_interval_s
        self._probe_timeout_s = probe_timeout_s
        self._unhealthy_after = max(1, unhealthy_after)
        self._failover_retries = max(0, failover_retries)
        self._proxy_timeout_s = proxy_timeout_s
        self._drain_poll_s = drain_poll_s
        self._gate_config = gate_config
        self._gate_timeout_s = gate_timeout_s
        self._watch_timeout_s = (
            watch_timeout_s
            if watch_timeout_s is not None
            else max(
                30.0,
                3.0 * (gate_config.watch_s if gate_config else 10.0),
            )
        )

        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {}
        self._retired: list[dict] = []
        #: tied-id tuple -> (sorted vnode points, matching replica ids)
        self._ring_cache: dict[tuple, tuple[list, list]] = {}
        self._swaps: dict[str, dict] = {}
        #: idempotency: token -> swap id; re-driving a token returns
        #: the existing record instead of starting a second swap
        self._swap_tokens: dict[str, str] = {}
        self._swaps_completed_total = 0
        self._serving_generation = ""
        #: the active fleet shadow gate (at most one swap holds it)
        self._fleet_gate: canary_mod.ShadowCanary | None = None
        #: replica factory registered by the autoscaler:
        #: ``spawn(generation, staged) -> Replica`` (already
        #: installed); lets a trainer-driven swap stage a candidate
        #: without providing a URL
        self._spawner: Callable[[str, bool], Replica] | None = None
        #: status callback registered by the autoscaler
        self._autoscaler_status: Callable[[], dict] | None = None
        #: plain-int mirror of pio_router_shed_total for the autoscaler
        #: (reading back one registry counter per tick is noise)
        self._shed_count = 0
        self._state_store = (
            RouterStateStore(state_path) if state_path else None
        )
        self._state_max_age_s = state_max_age_s
        self._state_note = ""
        self._state_saved_monotonic = time.monotonic()
        self._resume_swaps: list[dict] = []
        self._closed = threading.Event()
        # startTime is a display epoch; uptime must come from the
        # monotonic clock — an NTP step would otherwise make uptimeSec
        # jump or go negative
        self._start_time = time.time()  # pio-lint: disable=wall-clock -- display epoch only; uptime uses _start_monotonic
        self._start_monotonic = time.monotonic()

        self._healthy_gauge = self._registry.gauge(
            "pio_router_replica_healthy",
            "1 while the replica is admitted to the selection pool",
            ("replica",),
        )
        self._inflight_gauge = self._registry.gauge(
            "pio_router_inflight",
            "Router-tracked in-flight requests per replica",
            ("replica",),
        )
        self._failovers_total = self._registry.counter(
            "pio_router_failovers_total",
            "Requests retried against a different replica after a "
            "transport error or 5xx",
        )
        self._requests_total = self._registry.counter(
            "pio_router_requests_total",
            "Requests proxied, by replica and upstream status "
            "(status=error for transport failures)",
            ("replica", "status"),
        )
        self._swaps_total = self._registry.counter(
            "pio_router_swaps_total",
            "Rolling generation swaps, by outcome",
            ("outcome",),
        )
        self._shed_total = self._registry.counter(
            "pio_router_shed_total",
            "Requests shed at the router because every healthy "
            "replica advertised saturation (router-level backpressure "
            "— no replica budget burned)",
        )

        # -- fleet federation state --
        self._federation_timeout_s = max(
            0.05,
            _env_float("PIO_FEDERATION_TIMEOUT_MS", 1000.0) / 1000.0,
        )
        self._federation_concurrency = max(
            1, int(_env_float("PIO_FEDERATION_CONCURRENCY", 8))
        )
        #: guards goodput anchor + per-replica SLO counter watermarks
        self._fed_lock = threading.Lock()
        #: replica id -> {(class, outcome): last counter value} —
        #: watermarks so probe rounds and federation scrapes feed each
        #: request into the fleet SLO exactly once
        self._slo_seen: dict[str, dict[tuple, float]] = {}
        self._goodput_anchor: tuple[float, float] | None = None
        self._goodput_qps = 0.0
        #: fleet-level SLO from federated counter deltas; no local
        #: pio_slo_requests_total export — the fleet totals live in the
        #: merged view, a router-side copy would double-count
        self._fleet_slo = SLOMonitor(
            self._registry, export_counter=False
        )
        #: router-local incident timeline (swap phases, breaker
        #: transitions, burn alerts); installed process-global so the
        #: breaker/SLO emitters with no constructor seam land here too
        self._timeline = timeline_mod.Timeline(registry=self._registry)
        timeline_mod.set_timeline(self._timeline)
        self._stale_gauge = self._registry.gauge(
            "pio_federation_stale",
            "1 while the replica's federated series come from its "
            "last snapshot instead of a live scrape",
            ("replica",),
        )
        self._goodput_gauge = self._registry.gauge(
            "pio_fleet_goodput_qps",
            "Fleet-wide good (SLO-passing) requests per second, from "
            "federated pio_slo_requests_total deltas",
        )
        fleet_replicas = self._registry.gauge(
            "pio_fleet_replicas",
            "Replicas known to the router, by lifecycle state",
            ("state",),
        )
        for st in (WARMING, HEALTHY, DRAINING, UNHEALTHY):
            fleet_replicas.labels(st).set_function(
                lambda s=st: float(self._count_state(s))
            )

        for replica in replicas:
            self._install(replica)
        self._adopt_state()

        self.router = Router()
        self.router.route("GET", "/", self._status)
        self.router.route("POST", "/queries.json", self._proxy)
        self.router.route("POST", "/batch/queries.json", self._proxy)
        self.router.route("GET", "/admin/replicas", self._admin_list)
        self.router.route("POST", "/admin/replicas", self._admin_register)
        self.router.route(
            "DELETE", "/admin/replicas/<rid>", self._admin_retire
        )
        self.router.route("POST", "/admin/swap", self._admin_swap)
        self.router.route("GET", "/admin/swap/<sid>", self._admin_swap_get)
        install_metrics_routes(
            self.router, self._registry, self._tracer,
            server_config=self._server_config,
            federation=_FleetFederation(self),
            timeline=_FleetTimeline(self),
        )
        self._http: HTTPServer | None = None
        self._prober = threading.Thread(
            target=self._probe_loop, name="pio-router-probe", daemon=True
        )
        self._prober.start()
        for record in self._resume_swaps:
            threading.Thread(
                target=self._resume_swap,
                args=(record,),
                name=f"pio-router-resume-{record['id']}",
                daemon=True,
            ).start()
        self._resume_swaps = []

    # -- durable fleet state -----------------------------------------------
    def _persist_state(self) -> None:
        """Snapshot the replica set + swap state under the lock, write
        outside it (atomic + checksummed). Called after every
        membership or swap-phase transition; a no-op without a
        ``state_path``."""
        if self._state_store is None:
            return
        with self._lock:
            payload = {
                "servingGeneration": self._serving_generation,
                "replicas": [
                    {
                        "id": r.replica_id,
                        "url": r.url,
                        "generation": r.generation,
                        "pid": r.pid,
                        "staged": r.staged,
                        "parked": r.admin_draining,
                    }
                    for r in self._replicas.values()
                    if r.state != RETIRED
                ],
                # deep copies: a shallow dict(s) would share nested
                # objects (record["retired"], record["gate"]) with the
                # live swap threads, which mutate them after this lock
                # is released
                "swaps": [
                    json.loads(json.dumps(s))
                    for s in self._swaps.values()
                ],
                "swapsCompletedTotal": self._swaps_completed_total,
            }
        try:
            self._state_store.save(payload)
            self._state_saved_monotonic = time.monotonic()
        except OSError as e:
            # persistence must never take the serving path down; the
            # next transition retries
            logger.warning("cannot persist router state: %s", e)

    def _adopt_state(self) -> None:
        """Re-adopt the persisted fleet on restart. Replicas re-enter
        WARMING and must re-prove themselves through the normal
        healthz+warmup gate; non-terminal swaps are queued for
        :meth:`_resume_swap` (which resumes the roll — or safely aborts
        to the old generation — once the prober is running)."""
        if self._state_store is None:
            return
        payload, reason = self._state_store.load(self._state_max_age_s)
        if payload is None:
            if reason:
                self._state_note = f"discarded: {reason}"
                log_json(
                    logger, logging.WARNING, "router_state_discarded",
                    path=self._state_store.path, reason=reason,
                )
            return
        adopted = 0
        for entry in payload.get("replicas", ()):
            if not isinstance(entry, dict) or not entry.get("url"):
                continue
            rid = str(entry.get("id") or f"r-{uuid.uuid4().hex[:8]}")
            if rid in self._replicas:
                continue
            replica = Replica(
                rid,
                str(entry["url"]),
                generation=str(entry.get("generation", "")),
                pid=entry.get("pid"),
                registry=self._registry,
                breaker_config=self._breaker_config,
            )
            replica.staged = bool(entry.get("staged"))
            replica.admin_draining = bool(entry.get("parked"))
            if replica.admin_draining:
                replica.state = DRAINING
            self._install(replica)
            adopted += 1
        self._serving_generation = str(
            payload.get("servingGeneration", "")
        )
        for record in payload.get("swaps", ()):
            if not isinstance(record, dict) or not record.get("id"):
                continue
            self._swaps[record["id"]] = record
            if record.get("token"):
                self._swap_tokens[record["token"]] = record["id"]
            if record.get("phase") not in SWAP_TERMINAL_PHASES:
                self._resume_swaps.append(record)
        # the lifetime counter survives the restart with the records
        # (older state files without the field: the kept terminal
        # records are the best lower bound)
        self._swaps_completed_total = max(
            int(payload.get("swapsCompletedTotal", 0) or 0),
            sum(
                1
                for s in self._swaps.values()
                if s.get("phase") in SWAP_TERMINAL_PHASES
            ),
        )
        self._state_note = (
            f"adopted {adopted} replica(s)"
            + (
                f", resuming {len(self._resume_swaps)} swap(s)"
                if self._resume_swaps
                else ""
            )
        )
        log_json(
            logger, logging.INFO, "router_state_adopted",
            path=self._state_store.path, replicas=adopted,
            swaps=len(self._resume_swaps),
            generation=self._serving_generation,
        )

    def _serving_generation_locked(self) -> str:
        """Caller holds ``self._lock``."""
        if self._serving_generation:
            return self._serving_generation
        gens = {
            r.generation
            for r in self._replicas.values()
            if r.generation and not r.staged
        }
        return gens.pop() if len(gens) == 1 else ""

    @property
    def serving_generation(self) -> str:
        """The generation the fleet is serving: explicitly tracked by
        fleet swaps, else inferred from the active pool."""
        with self._lock:
            return self._serving_generation_locked()

    def attach_spawner(
        self, spawn: Callable[[str, bool], Replica]
    ) -> None:
        """Register the autoscaler's replica factory so swaps can stage
        a candidate generation without an operator-provided URL."""
        self._spawner = spawn

    def attach_autoscaler_status(self, fn: Callable[[], dict]) -> None:
        self._autoscaler_status = fn

    def autoscaler_signals(self) -> dict:
        """The signal bundle the replica autoscaler reconciles on —
        nothing the stack does not already export."""
        # fleet SLO burn (its own lock) resolves before taking the
        # replica lock: scale-up must trigger on burn, not just sheds
        burn_rate = self._fleet_slo.max_burn_rate()
        with self._lock:
            pool = [
                r for r in self._replicas.values() if r.state != RETIRED
            ]
            healthy = [
                r
                for r in pool
                if r.state == HEALTHY and not r.staged
            ]
            swap_active = any(
                s.get("phase") not in SWAP_TERMINAL_PHASES
                for s in self._swaps.values()
            )
            return {
                "healthy": len(healthy),
                "warming": sum(
                    1 for r in pool if r.state == WARMING and not r.staged
                ),
                "draining": sum(
                    1 for r in pool if r.state == DRAINING
                ),
                "unhealthy": sum(
                    1 for r in pool if r.state == UNHEALTHY
                ),
                "inflight": sum(r.inflight for r in healthy),
                "saturated": sum(1 for r in healthy if r.saturated),
                "shedTotal": self._shed_count,
                "swapActive": swap_active,
                # worst-class short-window burn from the fleet SLO
                # monitor — an SLO on fire wants replicas even while
                # nothing sheds yet
                "burnRate": round(burn_rate, 4),
                # the INFERRED generation: a fleet that never ran a
                # gated swap has no explicit one, and the autoscaler
                # substitutes this into the spawn template — "" would
                # launch replicas with the wrong/default model
                "servingGeneration": self._serving_generation_locked(),
                # mixed-generation pool with no explicit serving
                # generation (an ungated roll in flight): "" above is
                # "no single answer", not "no generation" — the
                # autoscaler must defer growth instead of spawning a
                # default-model replica into live selection
                "generationAmbiguous": (
                    not self._serving_generation
                    and len(
                        {
                            r.generation
                            for r in pool
                            if r.generation and not r.staged
                        }
                    )
                    > 1
                ),
            }

    # -- replica registry --------------------------------------------------
    def _install(self, replica: Replica) -> None:
        with self._lock:
            if replica.replica_id in self._replicas:
                raise ValueError(
                    f"replica id {replica.replica_id!r} already registered"
                )
            self._replicas[replica.replica_id] = replica
        rid = replica.replica_id
        self._healthy_gauge.labels(rid).set(0)
        self._inflight_gauge.labels(rid).set_function(
            lambda r=replica: float(r.inflight)
        )
        log_json(
            logger, logging.INFO, "router_replica_registered",
            replica=rid, url=replica.url, generation=replica.generation,
        )
        # membership changes are incident-narrative events (and they
        # guarantee the router's own ring is never empty in a merge)
        self._timeline.record(
            "replica_registered", f"replica {rid!r} registered",
            generation=replica.generation or None, replica_id=rid,
        )

    def add_replica(
        self,
        url: str,
        replica_id: str | None = None,
        generation: str = "",
        pid: int | None = None,
        staged: bool = False,
    ) -> Replica:
        """Register a replica; it enters the pool WARMING and is
        admitted by the probe loop once its ``/healthz`` answers ok and
        its ``pio_warmup_complete`` gauge (when exported) reads 1.
        ``staged=True`` keeps it OUT of selection even once healthy —
        a fleet-gated swap candidate takes mirrored traffic only."""
        replica = Replica(
            replica_id or f"r-{uuid.uuid4().hex[:8]}",
            url,
            generation=generation,
            pid=pid,
            registry=self._registry,
            breaker_config=self._breaker_config,
        )
        replica.staged = staged
        self._install(replica)
        self._persist_state()
        return replica

    def update_replica_pid(self, replica_id: str, pid: int | None) -> bool:
        """Point an existing entry at a respawned process (the
        autoscaler respawns a crashed replica on its original port; the
        registration survives, only the pid changes)."""
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None:
                return False
            replica.pid = pid
        self._persist_state()
        return True

    def park(self, replica_id: str) -> bool:
        """Drain a replica out of selection WITHOUT retiring it: the
        sticky admin drain applies (probes cannot readmit it) but its
        process is left running. The fleet swap parks one old-generation
        replica as the rollback standby until the regression watch
        clears."""
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None:
                return False
            replica.admin_draining = True
            if replica.state != RETIRED:
                replica.state = DRAINING
        self._healthy_gauge.labels(replica_id).set(0)
        log_json(
            logger, logging.INFO, "router_replica_parked",
            replica=replica_id,
        )
        self._persist_state()
        return True

    def unpark(self, replica_id: str) -> bool:
        """Lift a parked replica's sticky drain; the probe loop
        readmits it through the normal healthz+warmup gate."""
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None:
                return False
            replica.admin_draining = False
        log_json(
            logger, logging.INFO, "router_replica_unparked",
            replica=replica_id,
        )
        self._persist_state()
        return True

    def retire(
        self,
        replica_id: str,
        wait: bool = False,
        on_drained: Callable[[Replica], None] | None = None,
    ) -> bool:
        """Drain a replica out of the pool: selection stops NOW,
        in-flight requests finish, then ``on_drained`` runs (default:
        SIGTERM a locally-supervised replica's ``pid`` so its own
        graceful drain path completes) and the replica is dropped from
        the active map. Returns False when the id is unknown."""
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None:
                return False
            if replica.admin_draining and not wait:
                return True  # a drain is already in flight
            replica.admin_draining = True
            replica.state = DRAINING
        self._healthy_gauge.labels(replica_id).set(0)
        log_json(
            logger, logging.INFO, "router_replica_draining",
            replica=replica_id,
        )
        self._timeline.record(
            "replica_draining", f"replica {replica_id!r} draining out",
            replica_id=replica_id,
        )

        def _finish():
            while replica.inflight > 0 and not self._closed.is_set():
                time.sleep(self._drain_poll_s)
            try:
                if on_drained is not None:
                    on_drained(replica)
                elif replica.pid:
                    os.kill(replica.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass  # already gone — retiring a dead replica is fine
            except Exception:  # noqa: BLE001 - retire must complete
                logger.exception("retire hook failed for %s", replica_id)
            with self._lock:
                replica.state = RETIRED
                self._replicas.pop(replica_id, None)
                self._retired.append(replica.to_dict())
                del self._retired[:-20]
            # the registry has no series-removal API, so park the dead
            # replica's series at constant 0 — replacing the scrape
            # closure is what lets the Replica (and its breaker) be
            # garbage-collected instead of pinned for process life
            self._inflight_gauge.labels(replica_id).set_function(
                lambda: 0.0
            )
            self._healthy_gauge.labels(replica_id).set(0)
            log_json(
                logger, logging.INFO, "router_replica_retired",
                replica=replica_id,
            )
            self._persist_state()

        if wait:
            _finish()
        else:
            threading.Thread(
                target=_finish,
                name=f"pio-router-retire-{replica_id}",
                daemon=True,
            ).start()
        return True

    def replica_states(self) -> dict[str, str]:
        with self._lock:
            return {
                rid: r.state for rid, r in self._replicas.items()
            }

    # -- health probing ----------------------------------------------------
    def _probe_loop(self) -> None:
        while not self._closed.wait(self._probe_interval_s):
            with self._lock:
                targets = list(self._replicas.values())
            for replica in targets:
                try:
                    self._probe_one(replica)
                except Exception:  # noqa: BLE001 - prober must survive
                    logger.exception(
                        "probe crashed for %s", replica.replica_id
                    )
            # keep the state file's save stamp fresh on a QUIET fleet:
            # membership/swap transitions are the only other writers,
            # so hours of steady-state serving would otherwise age the
            # file past the adoption window and a restart would discard
            # a perfectly live fleet as stale
            if (
                self._state_store is not None
                and time.monotonic() - self._state_saved_monotonic
                > min(60.0, self._state_max_age_s / 3.0)
            ):
                # a swap/membership thread persisting concurrently makes
                # this refresh redundant, never wrong: saves are atomic
                # whole-file writes of freshly-snapshotted state, and
                # the stamp is a staleness hint — an extra save costs
                # one fsync, an interposed one satisfies the check
                # pio-lint: disable-next=check-then-act -- idempotent freshness refresh; concurrent persists write identical atomic snapshots
                self._persist_state()

    def _fetch_json(self, url: str):
        with urllib.request.urlopen(
            urllib.request.Request(url), timeout=self._probe_timeout_s
        ) as resp:
            return resp.status, json.loads(resp.read() or b"null")

    def _probe_one(self, replica: Replica) -> None:
        if replica.state == RETIRED:
            return
        try:
            try:
                status, body = self._fetch_json(replica.url + "/healthz")
            except urllib.error.HTTPError as e:
                status, body = e.code, json.loads(e.read() or b"{}")
            draining = (
                status == 503
                and isinstance(body, dict)
                and body.get("status") == "draining"
            )
            warm = True
            if not draining:
                # scrape warmup + drain gauges; a server that exports
                # neither (non-engine replica) counts as warm
                _, metrics = self._fetch_json(
                    replica.url + "/metrics.json"
                )
                warm_v = _metric_sample(metrics, "pio_warmup_complete")
                warm = warm_v is None or warm_v >= 1.0
                drain_v = _metric_sample(
                    metrics, "pio_server_draining"
                )
                draining = draining or (
                    drain_v is not None and drain_v >= 1.0
                )
                if isinstance(metrics, dict):
                    # every probe doubles as a federation refresh:
                    # snapshot for stale-tolerant scrapes, SLO counter
                    # deltas into the fleet burn monitor
                    replica.store_metrics(metrics)
                    self._ingest_replica_slo(
                        replica.replica_id, metrics
                    )
        except (*_TRANSPORT_ERRORS, ValueError):
            replica.probe_failures += 1
            replica.last_probe = "unreachable"
            replica.mark_metrics_stale()
            if (
                replica.probe_failures >= self._unhealthy_after
                and replica.state in (HEALTHY, DRAINING)
            ):
                self._set_state(replica, UNHEALTHY)
            return
        replica.probe_failures = 0
        if draining:
            replica.last_probe = "draining"
            # the replica itself says draining (SIGTERM landed on it):
            # stop routing, but an ADMIN-initiated drain stays sticky
            if replica.state in (HEALTHY, WARMING, UNHEALTHY):
                self._set_state(replica, DRAINING)
            return
        replica.last_probe = "ok" if warm else "cold"
        if (
            warm
            and not replica.admin_draining
            and replica.state in (WARMING, UNHEALTHY, DRAINING)
        ):
            # DRAINING→HEALTHY covers a replica that reported draining
            # because its OLD process was exiting and a fresh process
            # now answers ok on the same port (kill + respawn in
            # place). Admin-initiated drains are sticky: the ROUTER
            # decided to drain, so a still-answering process must not
            # probe its way back into the pool mid-retire.
            self._set_state(replica, HEALTHY)

    def _set_state(self, replica: Replica, state: str) -> None:
        with self._lock:
            if replica.state == RETIRED:
                return
            if state == HEALTHY and replica.admin_draining:
                # the probe read admin_draining BEFORE retire() set it
                # (its check runs outside this lock): rechecking here
                # keeps the sticky drain sticky — a readmission racing
                # a retire must lose
                return
            previous, replica.state = replica.state, state
        self._healthy_gauge.labels(replica.replica_id).set(
            1 if state == HEALTHY else 0
        )
        if previous != state:
            log_json(
                logger,
                logging.WARNING if state == UNHEALTHY else logging.INFO,
                "router_replica_state",
                replica=replica.replica_id,
                previous=previous, state=state,
            )

    # -- selection ---------------------------------------------------------
    def _candidates(self, affinity_key: bytes, exclude: set[str]):
        """Healthy replicas in selection order: unsaturated before
        saturated (a replica that just shed is soft-unhealthy — it
        stays available as a last resort but must not absorb traffic
        its own admission controller is refusing), and within each
        band recovering breakers first (their ``allow()`` is the
        half-open probe — skipping them would strand an open breaker
        forever behind healthier peers), then least-inflight with the
        consistent-hash ring breaking ties.

        A tenant's key (``accessKey`` / ``X-PIO-Tenant``) instead orders
        the closed breakers of each band by the ring alone, starting at
        the tenant's home replica: the tenant's model stays resident in
        one replica's pool, and a saturated home (its own admission
        shedding) or a failover moves the tenant to the next replica on
        the ring. The JAX router lets load override the tenant here too,
        so under concurrent traffic a tenant spreads over every replica
        and faults its model into each pool (ROADMAP.md §3)."""
        with self._lock:
            pool = [
                r
                for r in self._replicas.values()
                if r.state == HEALTHY
                and not r.staged
                and r.replica_id not in exclude
            ]
        if not pool:
            return []
        # snapshot the time-dependent saturation flag ONCE per replica:
        # evaluating it in two comprehensions would let a replica whose
        # window expires between them fall into neither band and
        # vanish from the candidate list
        saturated = {r.replica_id: r.saturated for r in pool}
        ordered: list[Replica] = []
        for band in (
            [r for r in pool if not saturated[r.replica_id]],
            [r for r in pool if saturated[r.replica_id]],
        ):
            recovering = [
                r for r in band if r.breaker.state != resilience.CLOSED
            ]
            closed = [
                r for r in band if r.breaker.state == resilience.CLOSED
            ]
            ordered.extend(sorted(recovering, key=lambda r: r.inflight))
            remaining = sorted(closed, key=lambda r: r.inflight)
            pinned = affinity_key.startswith(_TENANT_KEY_PREFIX)
            while remaining:
                least = remaining[0].inflight
                tied = (
                    remaining
                    if pinned
                    else [r for r in remaining if r.inflight == least]
                )
                if len(tied) == 1:
                    pick = tied[0]
                else:
                    pick = self._ring_pick(tied, affinity_key)
                ordered.append(pick)
                remaining.remove(pick)
        return ordered

    def _ring_pick(
        self, tied: list[Replica], affinity_key: bytes
    ) -> Replica:
        """Consistent-hash pick among tied replicas: the first vnode at
        or after the key's point on the ring. Stable as replicas come
        and go — only ~1/N of the key space remaps per change. The
        merged ring per tied-id set is cached (ids only, so a cached
        entry cannot pin a retired Replica): the steady state — every
        replica idle, all tied — costs one key hash + one bisect per
        request, not a ring rebuild."""
        key = tuple(sorted(r.replica_id for r in tied))
        # the .get is a single (GIL-atomic) load — the hot hit path
        # stays lock-free; two concurrent misses build the same
        # deterministic ring, and the store below is ordered under the
        # lock so a concurrent clear() cannot interleave mid-eviction
        ring = self._ring_cache.get(key)
        if ring is None:
            merged = sorted(
                (point, r.replica_id)
                for r in tied
                for point in r.ring_points
            )
            ring = ([p for p, _ in merged], [rid for _, rid in merged])
            with self._lock:
                if len(self._ring_cache) >= 64:
                    self._ring_cache.clear()  # membership churn: restart
                self._ring_cache[key] = ring
        points, ids = ring
        by_id = {r.replica_id: r for r in tied}
        idx = bisect.bisect_left(points, _hash64(affinity_key))
        return by_id[ids[idx % len(ids)]]

    def _acquire(
        self, affinity_key: bytes, exclude: set[str]
    ) -> Replica | None:
        """The selected replica with its breaker slot held (the caller
        MUST record success/failure/release on ``replica.breaker``)."""
        for replica in self._candidates(affinity_key, exclude):
            if replica.breaker.allow():
                return replica
        return None

    # -- proxying ----------------------------------------------------------
    def _affinity_key(self, request: Request) -> bytes:
        explicit = request.headers.get(AFFINITY_HEADER)
        if explicit:
            return explicit.encode("utf-8", "replace")
        # tenant-keyed routing for pooled multi-tenant replicas: one
        # tenant's traffic lands on one replica (plus ring neighbors on
        # failover), so each tenant's model stays HOT in ONE pool
        # instead of faulting into every replica's budget. Resolution
        # order matches the engine server's (_resolve_tenant).
        tenant = (
            request.query.get("accessKey")
            or request.headers.get(admission.TENANT_HEADER)
        )
        if tenant:
            return _TENANT_KEY_PREFIX + tenant.encode("utf-8", "replace")
        if request.body:
            return request.body
        return (getattr(request, "client_addr", "") or "").encode()

    def _saturation_hint(self) -> str:
        """Retry-After for a router-level shed: the SOONEST any
        saturated replica expects capacity back (it told us via its
        own Retry-After), floored at 50 ms."""
        with self._lock:
            remaining = [
                r.saturation_remaining_s()
                for r in self._replicas.values()
                if r.state == HEALTHY and r.saturated
            ]
        return admission.format_retry_after(
            min(remaining) if remaining else 0.5
        )

    def _proxy(self, request: Request) -> Response:
        t0 = time.perf_counter()
        deadline = resilience.get_deadline()
        affinity_key = self._affinity_key(request)
        tried: set[str] = set()
        attempts = 1 + self._failover_retries
        last_failure: str | None = None
        hard_failure = False
        parent = tracing.current_span()
        # router-level shed: when EVERY healthy replica is advertising
        # saturation, forwarding just burns a saturated replica's
        # budget to collect another 503 — answer the backpressure here
        # with the soonest capacity hint. Critical-class traffic still
        # goes through: the replicas' own admission keeps the full
        # limit open for it.
        if request.criticality != admission.CRITICAL:
            # a cheap pool scan, not the full selection ordering (which
            # the first _acquire below would only rebuild)
            with self._lock:
                healthy = [
                    r
                    for r in self._replicas.values()
                    if r.state == HEALTHY and not r.staged
                ]
            if healthy and all(r.saturated for r in healthy):
                self._shed_total.inc()
                with self._lock:
                    # += on a bare int loses counts when two handler
                    # threads shed at once; the autoscaler diffs this
                    # value per tick, so lost updates read as "no
                    # pressure" exactly when pressure is highest
                    self._shed_count += 1
                return Response(
                    503,
                    {
                        "message": "all replicas are saturated; "
                        "retry after the hinted delay"
                    },
                    headers={
                        "Retry-After": self._saturation_hint(),
                        # nothing was forwarded: replay-safe
                        admission.SHED_HEADER: "saturated",
                    },
                )
        for attempt in range(attempts):
            if deadline is not None and deadline.expired:
                raise resilience.DeadlineExceeded(
                    "budget exhausted routing to a replica"
                )
            replica = self._acquire(affinity_key, tried)
            if replica is None:
                break
            if last_failure is not None:
                # a sibling IS taking over the failed attempt's work —
                # this, not the failure itself, is the failover
                self._failovers_total.inc()
                log_json(
                    logger, logging.WARNING, "router_failover",
                    to=replica.replica_id, error=last_failure,
                )
            tried.add(replica.replica_id)
            span_cm = (
                self._tracer.child(
                    parent,
                    f"router/forward {replica.replica_id}",
                    attributes={
                        "replica": replica.replica_id,
                        "attempt": attempt,
                    },
                )
                if parent is not None and self._tracer.enabled
                else tracing.NOOP
            )
            replica.begin()
            try:
                with span_cm as span:
                    outcome = self._forward(
                        replica, request, deadline, span
                    )
            except BaseException:
                # _forward pairs the breaker verdict with every normal
                # outcome; anything escaping it produced none — release
                # so a half-open probe slot cannot wedge
                replica.breaker.release()
                raise
            finally:
                replica.end()
            if isinstance(outcome, Response):
                self._fleet_observe(
                    request, outcome, time.perf_counter() - t0
                )
                return outcome
            # failover-eligible: transport error, retryable 5xx, or a
            # saturation shed (kind distinguishes them — a request that
            # only ever hit saturated replicas becomes a backpressure
            # 503, not a 502)
            kind, last_failure = outcome
            hard_failure = hard_failure or kind == "error"
            if attempt + 1 >= attempts or (
                deadline is not None and deadline.expired
            ):
                break
        if last_failure is not None:
            if not hard_failure:
                # every attempt was answered with a saturation shed:
                # relay the backpressure with the soonest capacity
                # hint. Queries are reads — the replicas' sheds did no
                # work — so the relay is marked replay-safe too.
                self._shed_total.inc()
                with self._lock:
                    self._shed_count += 1
                return Response(
                    503,
                    {
                        "message": "all tried replicas are saturated; "
                        "retry after the hinted delay"
                    },
                    headers={
                        "Retry-After": self._saturation_hint(),
                        admission.SHED_HEADER: "saturated",
                    },
                )
            # a real failure somewhere — a gateway error the client
            # may retry (the replicas themselves stayed consistent).
            # This is fleet-level evidence: a 502 storm right after a
            # promotion is exactly what the regression watch exists for
            self._fleet_observe(request, None, time.perf_counter() - t0)
            raise HTTPError(502, f"all routed replicas failed: {last_failure}")
        states = set(self.replica_states().values())
        if states and states <= {DRAINING, RETIRED}:
            # drain keeps the small FIXED hint: the pool is rolling,
            # not overloaded, and fresh capacity readmits in about a
            # probe interval, independent of queue state
            return Response(
                503,
                {"message": "all replicas are draining; retry shortly"},
                headers={"Retry-After": "1"},
            )
        return Response(
            503,
            {
                "message": "no healthy replica available"
                + (" (all tried)" if tried else "")
            },
            headers={
                # computed from the router's own recovery cadence: a
                # probe cycle is how fast a replica can possibly be
                # readmitted
                "Retry-After": admission.format_retry_after(
                    2.0 * self._probe_interval_s
                )
            },
        )

    def _forward(
        self,
        replica: Replica,
        request: Request,
        deadline: resilience.Deadline | None,
        span,
    ) -> "Response | tuple[str, str]":
        """One proxied attempt. Returns the upstream Response (success
        — including 4xx/504, which are the replica ANSWERING), or a
        ``(kind, message)`` tuple when the attempt is failover-eligible:
        ``("error", ...)`` for transport errors / retryable 5xx,
        ``("saturated", ...)`` for a 503 carrying Retry-After — the
        replica's admission controller shedding, which is an ANSWER
        for breaker purposes but a reason to try a sibling."""
        url = replica.url + request.path
        req = urllib.request.Request(
            url, data=request.body, method=request.method
        )
        ctype = request.headers.get("Content-Type")
        req.add_header("Content-Type", ctype or "application/json")
        if request.request_id:
            req.add_header("X-Request-ID", request.request_id)
        if request.criticality != admission.DEFAULT:
            # criticality propagates like the deadline, so the
            # replica's admission controller sheds by the CLIENT's
            # class, not the router hop's
            req.add_header(
                admission.CRITICALITY_HEADER, request.criticality
            )
        # the tenant identity propagates too (resolved the same way
        # the HTTP admission gate resolves it: accessKey first, then
        # the explicit header) — without this hop the replica's
        # per-tenant fair share only ever saw anonymous traffic from
        # the router, so one tenant could starve the rest THROUGH the
        # router while direct traffic was correctly clamped
        tenant = request.query.get("accessKey") or request.headers.get(
            admission.TENANT_HEADER
        )
        if tenant:
            req.add_header(admission.TENANT_HEADER, tenant)
        cache_control = request.headers.get(
            querycache_mod.CACHE_CONTROL_HEADER
        )
        if cache_control:
            # the read-your-writes cache bypass (Cache-Control:
            # no-cache) must survive the hop or the replica would
            # happily answer from its serving cache
            req.add_header(
                querycache_mod.CACHE_CONTROL_HEADER, cache_control
            )
        # nest the replica's root span under the forward span (or the
        # router's root when tracing the forward itself is disabled)
        parent = span if span is not None else tracing.current_span()
        if parent is not None:
            req.add_header(tracing.PARENT_SPAN_HEADER, parent.span_id)
        timeout = self._proxy_timeout_s
        if deadline is not None:
            # reserve a slice of budget for one failover hop, and
            # re-mint the header from what is left NOW so the budget
            # decrements across the router hop
            hop = deadline.reserved(
                min(1.0, self._proxy_timeout_s / 4.0)
            )
            req.add_header(resilience.DEADLINE_HEADER, hop.to_header())
            timeout = hop.cap(timeout)
        try:
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    body = resp.read()
                    status = resp.status
                    upstream_headers = resp.headers
                    resp_ctype = resp.headers.get(
                        "Content-Type", "application/json"
                    )
            except urllib.error.HTTPError as e:
                body = e.read()
                status = e.code
                upstream_headers = e.headers
                resp_ctype = e.headers.get(
                    "Content-Type", "application/json"
                )
        except _TRANSPORT_ERRORS as e:
            replica.breaker.record_failure()
            self._requests_total.labels(replica.replica_id, "error").inc()
            if span is not None:
                span.set("error", str(e))
            return ("error", f"{replica.replica_id}: {e}")
        self._requests_total.labels(
            replica.replica_id, str(status)
        ).inc()
        if span is not None:
            span.set("status", status)
        if status == 503:
            hint = admission.parse_retry_after(
                upstream_headers.get("Retry-After")
                if upstream_headers is not None
                else None
            )
            if hint is not None:
                # cooperative backpressure: the replica ANSWERED —
                # overload (or drain) is not a breaker failure, but it
                # IS a reason to deprioritize it and try a sibling
                replica.mark_saturated(hint)
                replica.breaker.record_success()
                if span is not None:
                    span.set("saturated", True)
                return (
                    "saturated",
                    f"{replica.replica_id}: HTTP 503 (saturated)",
                )
        if status >= 500 and status != 504:
            replica.breaker.record_failure()
            return ("error", f"{replica.replica_id}: HTTP {status}")
        # 2xx/4xx — and 504, the replica answering about an expired
        # budget — are verdicts of health, not failure (a 429
        # fair-share refusal is tenant-specific and forwarded as-is)
        replica.breaker.record_success()
        fwd_headers: dict[str, str] = {}
        cache_state = (
            upstream_headers.get(querycache_mod.CACHE_HEADER)
            if upstream_headers is not None
            else None
        )
        if cache_state:
            # cache provenance (hit|miss|coalesced) survives the hop,
            # so clients see exactly what the replica answered
            fwd_headers[querycache_mod.CACHE_HEADER] = cache_state
        return Response(
            status, body, content_type=resp_ctype,
            headers=fwd_headers or None,
        )

    # -- rolling swap / fleet promotion ------------------------------------
    def rolling_swap(
        self,
        url: str | None = None,
        generation: str = "",
        replica_id: str | None = None,
        pid: int | None = None,
        retire: str | list[str] = "others",
        warm_timeout_s: float = 120.0,
        wait: bool = False,
        token: str = "",
    ) -> dict:
        """Roll the pool to a new model generation without dropping a
        request. Register ``url`` WARMING (or, with ``url=None``, spawn
        a candidate through the attached autoscaler spawner), admit it
        once healthy AND warm (``pio_warmup_complete=1``), then — with
        a ``gate_config`` — shadow-score a deterministic sample of live
        traffic on it and only on a clean fleet gate drain the old
        replicas one at a time, parking one as the rollback standby for
        the post-promotion regression watch. Without a gate the
        original warming → draining-old → done sequence runs.

        ``token`` makes the operation idempotent: a token already seen
        (a respawned trainer re-driving the same generation) returns
        the existing record — the gate fires exactly once per
        generation. Runs in the background unless ``wait=True``;
        progress lands in the returned record (also served at
        ``GET /admin/swap/<id>``)."""
        swap_id = f"swap-{uuid.uuid4().hex[:8]}"
        if token:
            # check-and-reserve atomically: two concurrent drives of
            # the same token (trainer respawn racing its old request)
            # must resolve to ONE swap
            with self._lock:
                existing_id = self._swap_tokens.get(token)
                existing = (
                    self._swaps.get(existing_id) if existing_id else None
                )
                if existing is None and existing_id is not None:
                    # reserved but the record is still being opened
                    # (replica spawn in flight on another thread): the
                    # replay must neither steal the reservation nor
                    # open a second gate
                    raise ValueError(
                        f"a swap for token {token!r} is already being "
                        "opened; retry shortly"
                    )
                if existing is None:
                    self._swap_tokens[token] = swap_id
            if existing is not None:
                log_json(
                    logger, logging.INFO, "router_swap_token_replay",
                    token=token, swap=existing["id"],
                    phase=existing["phase"],
                )
                return existing
        from_generation = self.serving_generation
        gated = self._gate_config is not None
        try:
            if gated:
                # ONE fleet gate at a time: the gate mirrors live
                # traffic through the shared self._fleet_gate slot and
                # the watch phase owns the fleet-wide rollback standby
                # — a second concurrent gated swap would cross-consume
                # the first one's verdict. (Same-token replays returned
                # above; a DIFFERENT generation must wait its turn.)
                with self._lock:
                    self._assert_no_gated_swap_locked()
            if url is None:
                spawner = self._spawner
                if spawner is None:
                    raise ValueError(
                        "swap without a url needs a replica spawner "
                        "(run the router with --spawn-replica)"
                    )
                new_replica = spawner(generation, gated)
            else:
                new_replica = self.add_replica(
                    url,
                    replica_id=replica_id,
                    generation=generation,
                    pid=pid,
                    staged=gated,
                )
        except BaseException:
            if token:
                with self._lock:
                    if self._swap_tokens.get(token) == swap_id:
                        self._swap_tokens.pop(token, None)
            raise
        record = {
            "id": swap_id,
            "token": token or None,
            "phase": "warming",
            "generation": generation,
            "fromGeneration": from_generation,
            "url": new_replica.url,
            "replica": new_replica.replica_id,
            "standby": None,
            "gated": self._gate_config is not None,
            "retired": [],
            "retire": retire,
            "warmTimeoutS": warm_timeout_s,
            "gate": None,
            "error": None,
        }
        try:
            with self._lock:
                if gated:
                    # re-checked atomically with registration: a rival
                    # gated swap may have registered while our replica
                    # was spawning
                    self._assert_no_gated_swap_locked()
                self._swaps[swap_id] = record
                if token:
                    self._swap_tokens[token] = swap_id
        except ValueError:
            if token:
                with self._lock:
                    if self._swap_tokens.get(token) == swap_id:
                        self._swap_tokens.pop(token, None)
            self.retire(new_replica.replica_id)
            raise
        self._persist_state()

        if wait:
            self._run_swap(record)
        else:
            threading.Thread(
                target=self._run_swap,
                args=(record,),
                name=f"pio-router-{swap_id}",
                daemon=True,
            ).start()
        return record

    def _assert_no_gated_swap_locked(self) -> None:
        """Raise if a gated swap is already in flight (caller holds the
        pool lock). The fleet gate is a fleet-wide singleton."""
        for sid, s in self._swaps.items():
            if (
                s.get("gated")
                and s.get("phase") not in SWAP_TERMINAL_PHASES
            ):
                raise ValueError(
                    f"gated swap {sid} (generation "
                    f"{s.get('generation')!r}, phase {s.get('phase')!r})"
                    " is still in flight; one fleet gate at a time"
                )

    def _set_swap_phase(self, record: dict, phase: str, **fields) -> None:
        terminal = phase in SWAP_TERMINAL_PHASES
        with self._lock:
            record["phase"] = phase
            record.update(fields)
            if terminal:
                self._swaps_completed_total += 1
                self._gc_swaps_locked()
        self._timeline.record(
            "swap_phase",
            f"swap {record['id']} -> {phase}",
            severity=(
                timeline_mod.ERROR
                if phase == "failed"
                else timeline_mod.INFO
            ),
            generation=record.get("generation"),
            swap=record["id"],
            phase=phase,
        )
        self._persist_state()

    def _gc_swaps_locked(self) -> None:
        """Bound the completed-swap history: keep the newest
        ``_SWAP_HISTORY_KEEP`` terminal records (plus every in-flight
        one — an active swap is NEVER evicted, the bug the old
        fixed-size eviction had). Tokens of evicted records go with
        them; the total-completed count survives in
        ``swapsCompletedTotal`` on the status route."""
        terminal = [
            sid
            for sid, s in self._swaps.items()
            if s.get("phase") in SWAP_TERMINAL_PHASES
        ]
        for sid in terminal[: max(0, len(terminal) - _SWAP_HISTORY_KEEP)]:
            evicted = self._swaps.pop(sid)
            if evicted.get("token"):
                self._swap_tokens.pop(evicted["token"], None)

    def _swap_replica(self, record: dict) -> Replica | None:
        with self._lock:
            return self._replicas.get(record.get("replica") or "")

    def _fail_swap(self, record: dict, error: str) -> None:
        self._swaps_total.labels("failed").inc()
        log_json(
            logger, logging.WARNING, "router_swap_failed",
            swap=record["id"], generation=record["generation"],
            error=error,
        )
        self._set_swap_phase(record, "failed", error=error)
        # the old generation keeps serving; pull the dud out
        self.retire(record["replica"], wait=True)

    def _run_swap(self, record: dict) -> None:
        """Drive one swap from its CURRENT phase to a terminal one —
        the same entry point fresh swaps and restart-resumed swaps go
        through, so a router killed -9 mid-swap continues exactly where
        the state file says it stopped."""
        try:
            self._advance_swap(record)
        except Exception as e:  # noqa: BLE001 - a swap must terminate
            logger.exception("swap %s crashed", record["id"])
            if record.get("phase") not in SWAP_TERMINAL_PHASES:
                self._fail_swap(record, f"swap crashed: {e}")

    def _advance_swap(self, record: dict) -> None:
        gated = bool(record.get("gated")) and self._gate_config is not None
        warm_timeout_s = float(record.get("warmTimeoutS") or 120.0)
        generation = record["generation"]

        if record["phase"] == "warming":
            new_replica = self._swap_replica(record)
            if new_replica is None:
                self._fail_swap(
                    record,
                    "staged replica disappeared before warmup",
                )
                return
            deadline = time.monotonic() + warm_timeout_s
            while time.monotonic() < deadline and not self._closed.is_set():
                if new_replica.state == HEALTHY:
                    break
                time.sleep(self._drain_poll_s)
            if new_replica.state != HEALTHY:
                self._fail_swap(
                    record,
                    f"new replica never became healthy+warm within "
                    f"{warm_timeout_s}s (state={new_replica.state}, "
                    f"lastProbe={new_replica.last_probe})",
                )
                return
            self._set_swap_phase(
                record, "shadowing" if gated else "draining-old"
            )

        if record["phase"] == "shadowing":
            if not self._shadow_phase(record):
                return

        if record["phase"] in ("rolling", "draining-old"):
            self._roll_phase(record)

        if record["phase"] == "watching":
            self._watch_phase(record)

        if record["phase"] == "rolling-back":
            self._rollback_phase(record)

        if record["phase"] == "done":
            self._swaps_total.labels("ok").inc()
            log_json(
                logger, logging.INFO, "router_swap_done",
                swap=record["id"], generation=generation,
                retired=record["retired"],
            )

    def _swap_victims(self, record: dict) -> list[str]:
        """Old-generation replicas this swap still has to drain."""
        retire = record.get("retire", "others")
        if retire != "others":
            # the standby was POPPED from the victims and parked, never
            # appended to record["retired"] — without this filter a
            # roll resumed after a restart would retire its own
            # rollback standby (the "others" path below has the same
            # exclusion)
            return [
                rid
                for rid in retire
                if rid not in record["retired"]
                and rid != record.get("standby")
            ]
        with self._lock:
            return [
                rid
                for rid, r in self._replicas.items()
                if rid != record["replica"]
                and r.generation != record["generation"]
                and r.state != RETIRED
                and rid != record.get("standby")
            ]

    def _shadow_phase(self, record: dict) -> bool:
        """Mirror sampled live traffic to the staged replica and wait
        for the fleet gate's verdict. True = promoted (the caller rolls
        the fleet); False = the swap terminated here."""
        staged = self._swap_replica(record)
        if staged is None:
            self._fail_swap(record, "staged replica disappeared")
            return False
        gate = canary_mod.ShadowCanary(
            staged,
            config=self._gate_config,
            registry=self._registry,
            shadow_fn=lambda body: self._fleet_shadow_score(staged, body),
        )
        with self._lock:
            self._fleet_gate = gate
        log_json(
            logger, logging.INFO, "router_fleet_gate_open",
            swap=record["id"], generation=record["generation"],
            staged=staged.replica_id,
        )
        decision = None
        deadline = time.monotonic() + self._gate_timeout_s
        while not self._closed.is_set():
            decision = gate.take_decision()
            if decision is not None:
                break
            if time.monotonic() >= deadline:
                if gate.cancel(
                    "fleet gate timed out before enough shadow samples"
                ):
                    decision = "cancelled"
                    break
                # a verdict is mid-claim; take it next iteration
            time.sleep(self._drain_poll_s)
        with self._lock:
            self._fleet_gate = None
            record["gate"] = gate.to_dict()
        if decision != "promote":
            gate.finished(canary_mod.REJECTED)
            reason = gate.reason or f"gate decision: {decision}"
            self._fail_swap(record, f"fleet gate refused: {reason}")
            return False
        # promotion: the staged replica starts taking live traffic and
        # the fleet's serving generation flips BEFORE any old replica
        # drains — persisted as one transition, so a crash right here
        # resumes into the roll, never a half-promoted limbo
        staged.staged = False
        with self._lock:
            self._serving_generation = record["generation"]
            self._fleet_gate = gate
        # the regression window opens NOW: the roll itself is part of
        # the post-promotion period the watch must cover
        gate.promoted(retained=None)
        gate_dict = gate.to_dict()
        log_json(
            logger, logging.INFO, "router_fleet_gate_promoted",
            swap=record["id"], generation=record["generation"],
            samples=gate_dict.get("shadowSamples"),
            meanDivergence=gate_dict.get("meanDivergence"),
        )
        self._set_swap_phase(record, "rolling", gate=gate_dict)
        return True

    def _roll_phase(self, record: dict) -> None:
        """Drain the old generation one replica at a time (capacity
        never drops by more than one). Gated swaps park the first
        victim as the rollback standby instead of retiring it."""
        gated = record["phase"] == "rolling"
        victims = self._swap_victims(record)
        if gated and not record.get("standby") and victims:
            standby = victims.pop(0)
            self.park(standby)
            with self._lock:
                record["standby"] = standby
            self._persist_state()
        for rid in victims:
            if self.retire(rid, wait=True):
                with self._lock:
                    record["retired"].append(rid)
        if gated:
            self._set_swap_phase(record, "watching")
        else:
            self._set_swap_phase(record, "done")

    def _watch_phase(self, record: dict) -> None:
        """Post-promotion fleet regression watch: served error rate or
        latency regressing against the pre-promotion baseline rolls the
        WHOLE fleet back; a clean window releases the standby."""
        with self._lock:
            gate = self._fleet_gate
        if gate is None:
            # restart mid-watch: the baseline died with the old
            # process, so open a fresh watch window (error-rate
            # regression still rolls back; the latency comparison
            # needs a baseline and stays disarmed)
            staged = self._swap_replica(record)
            fresh = canary_mod.ShadowCanary(
                staged if staged is not None else record["replica"],
                config=self._gate_config or canary_mod.CanaryConfig(),
                registry=self._registry,
                shadow_fn=lambda body: None,
            )
            fresh.promoted(retained=record.get("standby"))
            with self._lock:
                # re-check under the lock: close() may have run (the
                # slot stays None forever after shutdown — installing
                # would revive a live gate close() can never see) or a
                # racing installer may have won
                if self._fleet_gate is None and not self._closed.is_set():
                    self._fleet_gate = fresh
                installed = self._fleet_gate
            if installed is not fresh:
                # not installed (lost the race, or shutting down):
                # release the abandoned gate's shadow worker; it is
                # still a safe local fallback for the loop below,
                # which exits immediately on _closed
                fresh.close()
            gate = installed if installed is not None else fresh
        decision = None
        deadline = time.monotonic() + self._watch_timeout_s
        while not self._closed.is_set():
            decision = gate.take_decision()
            if decision is not None:
                break
            if time.monotonic() >= deadline:
                if gate.cancel(
                    "watch window expired without enough traffic for "
                    "a verdict; treating the promotion as stable"
                ):
                    decision = "stable"
                    break
            time.sleep(self._drain_poll_s)
        with self._lock:
            self._fleet_gate = None
        if decision is None and self._closed.is_set():
            # graceful shutdown mid-watch: leave the record in
            # "watching" with the standby parked — the restart resumes
            # the regression watch exactly like a kill -9 does.
            # Finalizing "done" here would SIGTERM the rollback
            # standby and destroy the safety net on a routine restart.
            return
        with self._lock:
            record["gate"] = gate.to_dict()
        if decision == "rollback":
            gate.finished(canary_mod.ROLLED_BACK)
            log_json(
                logger, logging.WARNING, "router_fleet_rollback",
                swap=record["id"], generation=record["generation"],
                reason=gate.reason,
            )
            self._set_swap_phase(
                record, "rolling-back", error=gate.reason
            )
            return
        # stable (verdict, or cancelled-at-timeout): the promotion
        # held through the watch window — release the standby
        gate.finished(canary_mod.STABLE)
        standby = record.get("standby")
        if standby and self.retire(standby, wait=True):
            with self._lock:
                record["retired"].append(standby)
        self._set_swap_phase(record, "done")

    def _rollback_phase(self, record: dict) -> None:
        """Converge the fleet back onto the pre-promotion generation:
        revert the serving generation, readmit the parked standby, then
        drain every replica of the rejected generation."""
        with self._lock:
            self._serving_generation = record.get("fromGeneration", "")
        standby = record.get("standby")
        if standby:
            self.unpark(standby)
            deadline = time.monotonic() + float(
                record.get("warmTimeoutS") or 120.0
            )
            while (
                time.monotonic() < deadline
                and not self._closed.is_set()
            ):
                with self._lock:
                    replica = self._replicas.get(standby)
                if replica is None or replica.state == HEALTHY:
                    break
                time.sleep(self._drain_poll_s)
        with self._lock:
            rejected = [
                rid
                for rid, r in self._replicas.items()
                if r.generation == record["generation"]
                and r.state != RETIRED
            ]
        for rid in rejected:
            if self.retire(rid, wait=True):
                with self._lock:
                    record["retired"].append(rid)
        self._swaps_total.labels("rolled_back").inc()
        log_json(
            logger, logging.WARNING, "router_swap_rolled_back",
            swap=record["id"], generation=record["generation"],
            to=record.get("fromGeneration", ""),
        )
        self._set_swap_phase(record, "rolled_back")

    def _resume_swap(self, record: dict) -> None:
        """Continue (or safely abort) a swap the previous router
        process left mid-flight. Pre-promotion phases abort to the old
        generation — the gate's evidence died with the process, and an
        unproven generation must not be promoted on faith; from
        ``rolling`` on, the gate already passed, so the roll (or the
        rollback) completes."""
        phase = record.get("phase")
        if phase in ("warming", "shadowing"):
            self._fail_swap(
                record,
                f"router restarted during {phase}; aborted to "
                "generation "
                f"{record.get('fromGeneration') or '(previous)'} — the "
                "fleet gate's evidence did not survive the crash",
            )
            return
        staged = self._swap_replica(record)
        if staged is not None:
            staged.staged = False
        if phase in ("rolling", "draining-old", "watching"):
            # every re-adopted replica restarts WARMING — including the
            # promoted generation's. If the crash also took the new
            # replica down (same-host reboot), finishing the roll would
            # drain the only replicas still able to serve and converge
            # the fleet to ZERO capacity. The new generation must
            # re-prove itself through the probe gate before any more
            # old capacity is touched.
            warm_timeout_s = float(record.get("warmTimeoutS") or 120.0)
            deadline = time.monotonic() + warm_timeout_s
            healthy = False
            while not self._closed.is_set():
                with self._lock:
                    healthy = any(
                        r.generation == record["generation"]
                        and r.state == HEALTHY
                        for r in self._replicas.values()
                    )
                if healthy or time.monotonic() >= deadline:
                    break
                time.sleep(self._drain_poll_s)
            if not healthy:
                reason = (
                    f"resumed {phase} but no {record['generation']!r} "
                    f"replica became healthy within {warm_timeout_s}s"
                )
                if record.get("gated"):
                    # the gate already promoted: converge back through
                    # the rollback machinery (standby + undrained old
                    # replicas still exist)
                    log_json(
                        logger, logging.WARNING, "router_fleet_rollback",
                        swap=record["id"],
                        generation=record["generation"], reason=reason,
                    )
                    self._set_swap_phase(
                        record, "rolling-back", error=reason
                    )
                else:
                    self._fail_swap(record, reason)
                    return
        self._run_swap(record)

    def _fleet_shadow_score(self, staged: Replica, body):
        """Score one mirrored query on the staged replica (fleet-gate
        shadow worker only). 503/504 are infrastructure sheds
        (ShadowDropped — never a gate veto); a transport error or any
        other non-200 is evidence against the candidate and vetoes the
        swap, exactly like a model exception in the per-replica
        canary."""
        config = self._gate_config or canary_mod.CanaryConfig()
        req = urllib.request.Request(
            staged.url + "/queries.json",
            data=body if isinstance(body, bytes) else bytes(body or b""),
            method="POST",
        )
        req.add_header("Content-Type", "application/json")
        # the gate must never score a CACHED answer against a fresh
        # one: a stale-but-cached staged replica would look perfectly
        # convergent (or a warm cache would hide a real divergence)
        req.add_header(querycache_mod.CACHE_CONTROL_HEADER, "no-cache")
        try:
            with urllib.request.urlopen(
                req, timeout=config.shadow_timeout_s
            ) as resp:
                payload = resp.read()
                status = resp.status
        except urllib.error.HTTPError as e:
            if e.code in (429, 503, 504):
                raise canary_mod.ShadowDropped() from e
            raise RuntimeError(
                f"staged replica answered HTTP {e.code}"
            ) from e
        if status != 200:
            raise RuntimeError(f"staged replica answered HTTP {status}")
        return canary_mod.strip_volatile(json.loads(payload))

    # -- fleet federation --------------------------------------------------
    def _count_state(self, state: str) -> int:
        with self._lock:
            return sum(
                1 for r in self._replicas.values() if r.state == state
            )

    def _ingest_replica_slo(self, rid: str, payload: dict) -> None:
        """Feed one replica's ``pio_slo_requests_total`` deltas into
        the fleet SLO monitor — watermarked per replica so overlapping
        probe rounds and federation scrapes count each request exactly
        once, and a counter reset (replica restart) re-baselines
        instead of going negative."""
        family = payload.get("pio_slo_requests_total")
        samples = (
            family.get("samples") if isinstance(family, dict) else None
        )
        if not samples:
            return
        deltas: dict[tuple, float] = {}
        with self._fed_lock:
            seen = self._slo_seen.setdefault(rid, {})
            for sample in samples:
                labels = sample.get("labels") or {}
                key = (labels.get("class"), labels.get("outcome"))
                if key[0] is None or key[1] not in ("good", "bad"):
                    continue
                try:
                    value = float(sample.get("value") or 0.0)
                except (TypeError, ValueError):
                    continue
                prev = seen.get(key, 0.0)
                delta = value - prev if value >= prev else value
                seen[key] = value
                if delta > 0.0:
                    deltas[key] = deltas.get(key, 0.0) + delta
        for (cls, outcome), delta in deltas.items():
            self._fleet_slo.ingest(
                cls,
                good=delta if outcome == "good" else 0.0,
                bad=delta if outcome == "bad" else 0.0,
            )

    def _federation_scrape(self) -> tuple[dict, dict]:
        """Fan out to every live replica's ``/metrics.json`` with
        bounded concurrency and a per-replica deadline. A replica that
        fails the scrape contributes its LAST snapshot, marked
        ``pio_federation_stale{replica}`` — one SIGKILLed process must
        never fail the fleet scrape."""
        with self._lock:
            targets = [
                r for r in self._replicas.values() if r.state != RETIRED
            ]

        def scrape(replica: Replica) -> None:
            try:
                with urllib.request.urlopen(
                    urllib.request.Request(
                        replica.url + "/metrics.json"
                    ),
                    timeout=self._federation_timeout_s,
                ) as resp:
                    payload = json.loads(resp.read() or b"null")
            except (*_TRANSPORT_ERRORS, ValueError):
                replica.mark_metrics_stale()
                return
            if isinstance(payload, dict):
                replica.store_metrics(payload)
                self._ingest_replica_slo(replica.replica_id, payload)
            else:
                replica.mark_metrics_stale()

        if targets:
            with ThreadPoolExecutor(
                max_workers=min(
                    self._federation_concurrency, len(targets)
                ),
                thread_name_prefix="pio-federation",
            ) as pool:
                list(pool.map(scrape, targets))
        payloads: dict[str, dict] = {}
        stale: dict[str, bool] = {}
        for replica in targets:
            snapshot, is_stale = replica.metrics_state()
            if snapshot:
                payloads[replica.replica_id] = snapshot
                stale[replica.replica_id] = is_stale
            self._stale_gauge.labels(replica.replica_id).set(
                1.0 if is_stale else 0.0
            )
        self._update_goodput(payloads)
        return payloads, stale

    def _update_goodput(self, payloads: dict) -> None:
        """Fleet goodput = rate of SLO-good requests across federated
        counters, differentiated between scrapes on the monotonic
        clock (≥ 1 s apart — sub-second windows only amplify noise)."""
        merged = federation_mod.merge_payloads(payloads)
        good = federation_mod.counter_total(
            merged, "pio_slo_requests_total", outcome="good"
        )
        now = time.monotonic()
        with self._fed_lock:
            if self._goodput_anchor is None:
                self._goodput_anchor = (now, good)
            else:
                prev_t, prev_good = self._goodput_anchor
                if good < prev_good:
                    # a replica restarted (counter reset): re-anchor
                    self._goodput_anchor = (now, good)
                elif now - prev_t >= 1.0:
                    self._goodput_qps = (good - prev_good) / (
                        now - prev_t
                    )
                    self._goodput_anchor = (now, good)
            qps = self._goodput_qps
        self._goodput_gauge.set(qps)

    def federated_dict(self) -> dict:
        """The router's ``/metrics.json`` body: merged fleet counters
        and histograms, the router's own registry, raw per-replica
        payloads, and the scrape's staleness verdicts."""
        payloads, stale = self._federation_scrape()
        return {
            "federation": {
                "replicas": sorted(payloads),
                "stale": sorted(r for r, s in stale.items() if s),
            },
            "fleet": federation_mod.merge_payloads(payloads),
            "local": self._registry.to_dict(),
            "perReplica": payloads,
        }

    def federated_text(self) -> str:
        """The router's ``/metrics`` body: one Prometheus exposition
        with every replica's series labeled ``replica=...`` beside the
        router's own (which carry the fleet rollup gauges)."""
        payloads, _ = self._federation_scrape()
        combined = federation_mod.combine_families(
            self._registry.to_dict(), payloads
        )
        return federation_mod.render_prometheus_families(combined)

    def _timeline_scrape(self) -> tuple[dict, dict]:
        """Fan ``GET /debug/timeline.json`` out to the non-retired
        fleet (same timeout/concurrency knobs as the metrics scrape).
        An unreachable replica keeps its last snapshot and is reported
        stale — a SIGKILLed replica's final events stay in the merged
        narrative rather than vanishing with the process."""
        with self._lock:
            targets = [
                r for r in self._replicas.values() if r.state != RETIRED
            ]

        def scrape(replica: Replica) -> None:
            try:
                with urllib.request.urlopen(
                    urllib.request.Request(
                        replica.url + "/debug/timeline.json"
                    ),
                    timeout=self._federation_timeout_s,
                ) as resp:
                    payload = json.loads(resp.read() or b"null")
            except (*_TRANSPORT_ERRORS, ValueError):
                replica.mark_timeline_stale()
                return
            if isinstance(payload, dict):
                replica.store_timeline(payload)
            else:
                replica.mark_timeline_stale()

        if targets:
            with ThreadPoolExecutor(
                max_workers=min(
                    self._federation_concurrency, len(targets)
                ),
                thread_name_prefix="pio-timeline",
            ) as pool:
                list(pool.map(scrape, targets))
        payloads: dict[str, dict] = {}
        stale: dict[str, bool] = {}
        for replica in targets:
            snapshot, is_stale = replica.timeline_state()
            if snapshot:
                payloads[replica.replica_id] = snapshot
                stale[replica.replica_id] = is_stale
        return payloads, stale

    def federated_timeline(self) -> dict:
        """The router's ``/debug/timeline.json`` body: every replica's
        ring plus the router's own, merged into one wall-clock-ordered
        event stream with per-event ``replica`` provenance."""
        payloads, stale = self._timeline_scrape()
        merged = timeline_mod.merge_timelines(
            [("router", self._timeline.to_dict())]
            + sorted(payloads.items())
        )
        merged["stale"] = sorted(r for r, s in stale.items() if s)
        return merged

    def fleet_health(self) -> dict:
        """The status/CLI fleet-health block: goodput, worst-class
        burn, per-class SLO detail, and per-replica HBM headroom from
        the federated device gauges."""
        with self._lock:
            targets = [
                r for r in self._replicas.values() if r.state != RETIRED
            ]
        replicas: dict[str, dict] = {}
        for replica in targets:
            snapshot, is_stale = replica.metrics_state()
            if not snapshot:
                continue
            entry: dict = {"stale": is_stale}
            used = _sum_samples(snapshot, "pio_device_hbm_used_bytes")
            limit = _sum_samples(
                snapshot, "pio_device_hbm_limit_bytes"
            )
            if used is not None:
                entry["hbmUsedBytes"] = used
            if limit:
                entry["hbmLimitBytes"] = limit
                entry["hbmHeadroomBytes"] = max(
                    0.0, limit - (used or 0.0)
                )
            rss = _metric_sample(
                snapshot, "pio_process_resident_bytes"
            )
            if rss is not None:
                entry["residentBytes"] = rss
            replicas[replica.replica_id] = entry
        with self._fed_lock:
            qps = self._goodput_qps
        return {
            "goodputQps": round(qps, 3),
            "burnRate": round(self._fleet_slo.max_burn_rate(), 4),
            "slo": self._fleet_slo.snapshot(),
            "replicas": replicas,
        }

    def _fleet_observe(
        self, request: Request, response: Response | None,
        elapsed_s: float,
    ) -> None:
        """Request-path fleet-gate hook: feed the latency baseline /
        regression watch, and let the gate mirror a deterministic
        sample of served queries to the staged replica. Sheds and
        budget expiries (429/504) indict load, not the model — they
        never feed the gate."""
        gate = self._fleet_gate
        if gate is None:
            return
        ok = response is not None and response.status < 500
        if response is not None and response.status in (429, 504):
            return
        prediction = None
        if (
            ok
            and response.status == 200
            and gate.state == canary_mod.SHADOWING
            # only single queries are shadow-comparable: a batch body
            # mirrored onto the staged replica's /queries.json would
            # 400 (scoring as a bogus model exception), and a batch
            # result list never matches a single prediction. Batch
            # traffic still feeds the latency baseline / watch below —
            # prediction=None is never sampled.
            and request.path == "/queries.json"
        ):
            try:
                prediction = canary_mod.strip_volatile(
                    json.loads(response.body)
                )
            except (TypeError, ValueError):
                return  # not shadow-comparable
        gate.observe(request.body, prediction, elapsed_s, ok=ok)

    # -- routes ------------------------------------------------------------
    def _status(self, request: Request) -> Response:
        with self._lock:
            replicas = [r.to_dict() for r in self._replicas.values()]
            active_swaps = [
                {
                    "id": s["id"],
                    "phase": s["phase"],
                    "generation": s.get("generation"),
                }
                for s in self._swaps.values()
                if s.get("phase") not in SWAP_TERMINAL_PHASES
            ]
            swaps_kept = len(self._swaps) - len(active_swaps)
            completed_total = self._swaps_completed_total
            gate = self._fleet_gate
        body = {
            "status": "alive",
            "service": "router",
            "pid": os.getpid(),
            "startTime": self._start_time,
            "uptimeSec": round(
                time.monotonic() - self._start_monotonic, 3
            ),
            "replicas": replicas,
            "generations": sorted(
                {r["generation"] for r in replicas if r["generation"]}
            ),
            "servingGeneration": self.serving_generation,
            "swaps": {
                "active": active_swaps,
                "completedKept": swaps_kept,
                "completedTotal": completed_total,
            },
            # goodput + burn + per-replica HBM headroom, from probe-
            # refreshed snapshots (status must not fan out a scrape)
            "fleetHealth": self.fleet_health(),
        }
        if gate is not None:
            body["fleetGate"] = gate.to_dict()
        if self._state_note:
            body["stateFile"] = self._state_note
        autoscaler = self._autoscaler_status
        if autoscaler is not None:
            try:
                body["autoscaler"] = autoscaler()
            except Exception:  # noqa: BLE001 - status must not 500
                logger.exception("autoscaler status callback failed")
        return Response(200, body)

    def _admin_list(self, request: Request) -> Response:
        self._server_config.check_key(request)
        with self._lock:
            active = [r.to_dict() for r in self._replicas.values()]
            retired = list(self._retired)
        return Response(200, {"replicas": active, "retired": retired})

    def _admin_register(self, request: Request) -> Response:
        self._server_config.check_key(request)
        body = request.json()
        if not isinstance(body, dict) or not body.get("url"):
            raise HTTPError(400, "body must be {'url': ..., ...}")
        pid = body.get("pid")
        if pid is not None and not isinstance(pid, int):
            raise HTTPError(400, "pid must be an integer")
        try:
            replica = self.add_replica(
                str(body["url"]),
                replica_id=body.get("id"),
                generation=str(body.get("generation", "")),
                pid=pid,
            )
        except ValueError as e:
            raise HTTPError(409, str(e)) from None
        return Response(201, replica.to_dict())

    def _admin_retire(self, request: Request) -> Response:
        self._server_config.check_key(request)
        rid = request.path_params["rid"]
        if not self.retire(rid):
            raise HTTPError(404, f"no replica {rid!r}")
        return Response(200, {"id": rid, "state": DRAINING})

    def _admin_swap(self, request: Request) -> Response:
        self._server_config.check_key(request)
        body = request.json()
        if not isinstance(body, dict) or not (
            body.get("url") or body.get("generation")
        ):
            raise HTTPError(
                400,
                "body must be {'url': ..., 'generation': ...} — url "
                "may be omitted only when the router has a replica "
                "spawner (it then stages the generation itself)",
            )
        pid = body.get("pid")
        if pid is not None and not isinstance(pid, int):
            raise HTTPError(400, "pid must be an integer")
        retire = body.get("retire", "others")
        if retire != "others" and not (
            isinstance(retire, list)
            and all(isinstance(x, str) for x in retire)
        ):
            raise HTTPError(400, "retire must be 'others' or a list of ids")
        if not body.get("url") and self._spawner is None:
            # a misconfiguration, not a transient: 409 would send the
            # trainer into its retry-shortly loop for the full promote
            # budget on every generation
            raise HTTPError(
                400,
                "swap without a url needs a replica spawner (run the "
                "router with --spawn-replica)",
            )
        token = str(body.get("token", "") or "")
        replayed = False
        if token:
            with self._lock:
                replayed = self._swap_tokens.get(token) in self._swaps
        try:
            record = self.rolling_swap(
                str(body["url"]) if body.get("url") else None,
                generation=str(body.get("generation", "")),
                replica_id=body.get("id"),
                pid=pid,
                retire=retire,
                warm_timeout_s=float(body.get("warmTimeoutS", 120.0)),
                token=token,
            )
        except ValueError as e:
            raise HTTPError(409, str(e)) from None
        # an idempotent replay of a known token answers 200 with the
        # existing record; a fresh swap answers 202
        return Response(200 if replayed else 202, record)

    def _admin_swap_get(self, request: Request) -> Response:
        self._server_config.check_key(request)
        record = self._swaps.get(request.path_params["sid"])
        if record is None:
            raise HTTPError(404, "unknown swap id")
        return Response(200, record)

    # -- lifecycle ---------------------------------------------------------
    def serve(self, host: str = "0.0.0.0", port: int = 8100) -> HTTPServer:
        self._http = HTTPServer(
            self.router,
            host=host,
            port=port,
            server_config=self._server_config,
            enforce_key=False,  # queries stay open; /admin/* check_key
            service="router",
            registry=self._registry,
            tracer=self._tracer,
            # the fleet SLO monitor scores real served traffic from
            # federated counters; scoring the router's proxy hops too
            # would count every request twice
            slo=False,
        )
        self._http.add_drain_hook(self.close)
        return self._http

    def close(self) -> None:
        self._closed.set()
        with self._lock:
            gate = self._fleet_gate
            self._fleet_gate = None
        if gate is not None:
            gate.close()
        self._prober.join(timeout=5)


def create_router(
    replica_urls: Iterable[str] = (),
    host: str = "0.0.0.0",
    port: int = 8100,
    **kwargs,
) -> tuple[ServingRouter, HTTPServer]:
    """Convenience: a router over ``url`` or ``url#generation``
    strings, bound and ready to ``start()``/``serve_forever()``."""
    router = ServingRouter(**kwargs)
    for i, spec in enumerate(replica_urls):
        url, _, generation = spec.partition("#")
        with router._lock:
            adopted = f"r{i}" in router._replicas or any(
                r.url == url for r in router._replicas.values()
            )
        if adopted:
            # --state-file already re-adopted this replica: a restart
            # with the same --replica flags must re-join the fleet,
            # not crash on the duplicate registration
            continue
        router.add_replica(url, replica_id=f"r{i}", generation=generation)
    return router, router.serve(host=host, port=port)
