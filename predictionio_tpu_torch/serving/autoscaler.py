"""Goodput-driven replica autoscaler for the scale-out serving tier.

Counterpart of ``predictionio_tpu/serving/autoscaler.py``, copied: the
same signals, policy and actuation, so both packages' loops make the
same decisions from the same signals (``tests/test_torch_autoscaler.py``).
Like the router it imports no ``torch``: the replicas it spawns own the
card, each a process that pays its own torch import, CUDA context and
model load before its warmup gauge reads 1 (``spawn_timeout_s`` and
the router's warm gate cover that).

The router made N replicas look like one server; this module makes N
*elastic*. A reconciliation loop grows and shrinks the replica
set from signals the stack already exports — no new instrumentation:

* **router shed rate** (``pio_router_shed_total``): the router only
  sheds when EVERY healthy replica advertised saturation, so any shed
  is unambiguous "offered load exceeds fleet capacity" evidence;
* **saturation markers**: replicas answering 503 + ``Retry-After``
  (their own admission controller refusing work) are soft-unhealthy in
  the router's book — a majority-saturated pool is pressure *before*
  the router has to shed;
* **admission limit vs offered load**: mean router-tracked in-flight
  per healthy replica; a pool idling far below its per-replica limit
  for a sustained window is over-provisioned.

Actuation goes through machinery that already has the right
guarantees, so the loop itself stays trivial:

* **scale-up** spawns a replica process through the shared
  :func:`~predictionio_tpu_torch.serving.workers.supervise_children`
  supervisor (crash → respawn with backoff, on the SAME port so the
  router registration survives) and registers it with the router,
  where the probe loop admits it only after ``/healthz`` ok **and**
  ``pio_warmup_complete`` — scale-up gates on warmup by construction,
  and at most one replica warms at a time;
* **scale-down** retires through the router's sticky admin-drain path:
  selection stops instantly, in-flight requests finish, then SIGTERM
  runs the replica's own lossless drain — scale-down cannot drop a
  request by construction. The supervised slot is retired FIRST so the
  supervisor cannot respawn the drained process.

During an in-flight fleet swap the loop only tops the pool up at the
*serving* generation — it never shrinks mid-roll and never fights the
swap's own drains.

Env knobs (``AutoscalerConfig.from_env``): ``PIO_AUTOSCALE_MIN`` (1),
``PIO_AUTOSCALE_MAX`` (4), ``PIO_AUTOSCALE_INTERVAL_S`` (1.0),
``PIO_AUTOSCALE_SATURATION_FRACTION`` (0.5),
``PIO_AUTOSCALE_LOW_INFLIGHT`` (0.5), ``PIO_AUTOSCALE_SHRINK_TICKS``
(10), ``PIO_AUTOSCALE_BURN_THRESHOLD`` (2.0).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import subprocess
import threading
import time
from typing import Callable

from predictionio_tpu_torch.obs import MetricRegistry, get_registry
from predictionio_tpu_torch.obs import timeline as timeline_mod
from predictionio_tpu_torch.obs.context import log_json
from predictionio_tpu_torch.serving.resilience import _env_float
from predictionio_tpu_torch.serving.workers import (
    WorkerSlot,
    supervise_children,
    terminate_children,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Reconciliation policy. Scale-up is eager (one shed is enough —
    a shed is a refused user), scale-down is lazy (a sustained
    underutilized window), so the loop is stable under bursty load."""

    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 1.0
    #: fraction of the healthy pool advertising saturation that counts
    #: as pressure even before the router sheds
    saturation_fraction: float = 0.5
    #: mean in-flight per healthy replica at or below which the pool is
    #: underutilized (one tick toward scale-down)
    low_inflight_per_replica: float = 0.5
    #: consecutive underutilized ticks before one replica retires
    shrink_after_ticks: int = 10
    #: fleet SLO burn rate (worst class, short window) at or above
    #: which the pool is under pressure — an SLO on fire wants
    #: replicas even before anything sheds (1.0 = burning exactly at
    #: budget; 2.0 = the budget halves early)
    burn_threshold: float = 2.0

    @staticmethod
    def from_env() -> "AutoscalerConfig":
        d = AutoscalerConfig()
        return AutoscalerConfig(
            min_replicas=max(
                1, int(_env_float("PIO_AUTOSCALE_MIN", d.min_replicas))
            ),
            max_replicas=max(
                1, int(_env_float("PIO_AUTOSCALE_MAX", d.max_replicas))
            ),
            interval_s=max(
                0.05, _env_float("PIO_AUTOSCALE_INTERVAL_S", d.interval_s)
            ),
            saturation_fraction=min(
                1.0,
                max(
                    0.1,
                    _env_float(
                        "PIO_AUTOSCALE_SATURATION_FRACTION",
                        d.saturation_fraction,
                    ),
                ),
            ),
            low_inflight_per_replica=max(
                0.0,
                _env_float(
                    "PIO_AUTOSCALE_LOW_INFLIGHT",
                    d.low_inflight_per_replica,
                ),
            ),
            shrink_after_ticks=max(
                1,
                int(
                    _env_float(
                        "PIO_AUTOSCALE_SHRINK_TICKS", d.shrink_after_ticks
                    )
                ),
            ),
            burn_threshold=max(
                0.1,
                _env_float(
                    "PIO_AUTOSCALE_BURN_THRESHOLD", d.burn_threshold
                ),
            ),
        )


class SpawnError(RuntimeError):
    """A replica process died or never printed its port banner."""


class ReplicaSpawner:
    """Launches replica processes from an argv template.

    ``{port}`` and ``{generation}`` placeholders are substituted per
    launch. With ``port=0`` the child picks a free port and the spawner
    parses it from the ``... listening on <host>:<port>`` banner every
    server in this stack prints; respawns reuse the resolved port so
    the router's registration (and affinity ring position) survives the
    process."""

    def __init__(
        self,
        argv_template: list[str],
        *,
        env: dict | None = None,
        banner: str = "listening on",
        spawn_timeout_s: float = 120.0,
    ):
        if not argv_template:
            raise ValueError("spawner needs a non-empty argv template")
        self.argv_template = list(argv_template)
        self.env = dict(env) if env is not None else None
        self.banner = banner
        self.spawn_timeout_s = spawn_timeout_s

    def argv(self, generation: str, port: int) -> list[str]:
        return [
            a.replace("{port}", str(port)).replace(
                "{generation}", generation
            )
            for a in self.argv_template
        ]

    def launch(
        self, generation: str, port: int = 0
    ) -> tuple[subprocess.Popen, int]:
        """(process, bound port). ``port=0`` waits for the banner;
        an explicit port returns immediately (the router probe loop is
        the readiness gate on respawn)."""
        env = self.env if self.env is not None else dict(os.environ)
        env = dict(env)
        env.setdefault("PYTHONUNBUFFERED", "1")
        argv = self.argv(generation, port)
        if port != 0:
            proc = subprocess.Popen(
                argv,
                env=env,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
            return proc, port
        proc = subprocess.Popen(
            argv,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        bound: list[int] = []

        def _scan():
            for line in proc.stdout:
                if self.banner in line and not bound:
                    try:
                        bound.append(
                            int(
                                line.split(self.banner, 1)[1]
                                .split()[0]
                                .rsplit(":", 1)[1]
                            )
                        )
                    except (IndexError, ValueError):
                        pass
            # keep draining so request logs cannot block the child

        threading.Thread(
            target=_scan, name="pio-spawner-banner", daemon=True
        ).start()
        deadline = time.monotonic() + self.spawn_timeout_s
        while not bound and time.monotonic() < deadline:
            if proc.poll() is not None:
                raise SpawnError(
                    f"replica process exited rc={proc.returncode} "
                    "before binding"
                )
            time.sleep(0.05)
        if not bound:
            proc.kill()
            raise SpawnError(
                f"replica never printed its port within "
                f"{self.spawn_timeout_s}s"
            )
        return proc, bound[0]


class ReplicaAutoscaler:
    """Reconciliation loop owning a dynamic set of supervised replicas.

    Single reconcile thread; the shared ``supervise_children`` loop
    runs beside it over the same (dynamic) slot list. The router calls
    back into :meth:`spawn_for_swap` from a swap thread, so ownership
    bookkeeping (``_owned``, ``_slots``) is guarded by ``_lock`` —
    the reconcile thread iterates ``_owned`` while a swap spawn may be
    inserting into it, which GIL-atomic single operations do not make
    safe. The supervisor thread itself stays lock-free: it iterates a
    ``list(slots)`` snapshot by contract (see ``supervise_children``),
    and the lock here only orders the autoscaler's own append/pop/scan
    against each other. Never held across spawning, HTTP, or the
    router's own locked registry."""

    def __init__(
        self,
        router,
        spawner: ReplicaSpawner,
        config: AutoscalerConfig | None = None,
        registry: MetricRegistry | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._router = router
        self._spawner = spawner
        self.config = config or AutoscalerConfig()
        self._registry = (
            registry if registry is not None else get_registry()
        )
        self._clock = clock
        #: guards _owned and _slots (reconcile thread vs swap-thread
        #: spawn callbacks vs status/scrape readers)
        self._lock = threading.Lock()
        self._slots: list[WorkerSlot] = []
        #: replica id -> its supervised slot (autoscaler-owned only;
        #: operator-registered replicas are never shrink victims)
        self._owned: dict[str, WorkerSlot] = {}
        self._seq = itertools.count(1)
        self.target = self.config.min_replicas
        self._low_ticks = 0
        self._last_shed_total = 0
        self._stopping = threading.Event()
        self._threads: list[threading.Thread] = []
        self._registry.gauge(
            "pio_autoscaler_target",
            "Replica count the autoscaler is reconciling toward",
        ).set_function(lambda: float(self.target))
        self._registry.gauge(
            "pio_autoscaler_owned",
            "Replica processes currently owned (supervised) by the "
            "autoscaler",
        ).set_function(lambda: float(len(self._owned)))
        self._actions = self._registry.counter(
            "pio_autoscaler_actions_total",
            "Autoscaler actuations, by kind",
            ("action",),
        )
        router.attach_spawner(self.spawn_for_swap)
        router.attach_autoscaler_status(self.status)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ReplicaAutoscaler":
        supervisor = threading.Thread(
            target=supervise_children,
            args=(self._slots, self._stopping),
            kwargs={"poll_interval_s": 0.2},
            name="pio-autoscaler-supervise",
            daemon=True,
        )
        loop = threading.Thread(
            target=self._run,
            name="pio-autoscaler-reconcile",
            daemon=True,
        )
        self._threads = [supervisor, loop]
        supervisor.start()
        loop.start()
        return self

    def close(self, terminate: bool = True, grace_s: float = 10.0) -> None:
        self._stopping.set()
        for t in self._threads:
            t.join(timeout=5)
        if terminate:
            terminate_children(self._slots, grace_s)

    def _run(self) -> None:
        while not self._stopping.wait(self.config.interval_s):
            try:
                self.reconcile_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                logger.exception("autoscaler reconcile failed; retrying")

    # -- spawning ----------------------------------------------------------
    def spawn_for_swap(self, generation: str, staged: bool):
        """Router callback: stage a swap candidate of ``generation``
        (counted toward ownership, supervised like any other)."""
        return self._spawn_replica(generation, staged=staged)

    def _next_replica_id(self) -> str:
        """First free ``as-N`` id. A restarted router re-adopts its
        ``as-N`` replicas from the state file while THIS (fresh)
        autoscaler's counter restarts at 1 — skip ids the router
        already registers so adoption can never collide with a spawn.
        Concurrent spawners (reconcile thread vs a swap thread) each
        draw distinct counter values, so the membership check only
        needs to exclude pre-existing ids."""
        states = self._router.replica_states()
        while True:
            rid = f"as-{next(self._seq)}"
            if rid not in states:
                return rid

    def _spawn_replica(self, generation: str, staged: bool = False):
        rid = self._next_replica_id()
        proc, port = self._spawner.launch(generation, port=0)
        url = f"http://127.0.0.1:{port}"

        def respawn() -> subprocess.Popen:
            # same port: the router registration (and its place on the
            # affinity ring) survives the process; the probe loop
            # readmits it through the warmup gate
            new_proc, _ = self._spawner.launch(generation, port=port)
            self._router.update_replica_pid(rid, new_proc.pid)
            return new_proc

        slot = WorkerSlot(respawn, clock=self._clock, proc=proc)
        with self._lock:
            self._slots.append(slot)
        try:
            replica = self._router.add_replica(
                url,
                replica_id=rid,
                generation=generation,
                pid=proc.pid,
                staged=staged,
            )
        except BaseException:
            slot.retire()
            proc.terminate()
            raise
        with self._lock:
            self._owned[rid] = slot
        log_json(
            logger, logging.INFO, "autoscaler_spawned",
            replica=rid, url=url, generation=generation, staged=staged,
        )
        return replica

    # -- reconciliation ----------------------------------------------------
    def reconcile_once(self) -> str:
        """One tick: read signals, adjust the target, actuate at most
        one replica of change. Returns the action taken
        ("grow" | "shrink" | "idle")."""
        cfg = self.config
        signals = self._router.autoscaler_signals()
        self._prune_retired()
        healthy = signals["healthy"]
        actual = healthy + signals["warming"]
        shed_delta = signals["shedTotal"] - self._last_shed_total
        self._last_shed_total = signals["shedTotal"]

        if signals["swapActive"]:
            # a fleet promotion is rolling replicas: only top the pool
            # up at the serving generation so the roll never runs the
            # pool dry; pressure/shrink decisions resume after it
            self._low_ticks = 0
            if actual < max(self.target, cfg.min_replicas) and (
                signals["warming"] == 0
            ):
                return self._grow(signals)
            return "idle"

        burn_rate = float(signals.get("burnRate", 0.0) or 0.0)
        pressure = (
            shed_delta > 0
            or (
                healthy > 0
                and signals["saturated"] / healthy
                >= cfg.saturation_fraction
            )
            # SLO burn is the leading indicator: the fleet can be
            # failing its latency objective before any replica sheds
            or burn_rate >= cfg.burn_threshold
        )
        if pressure:
            self._low_ticks = 0
            if self.target < cfg.max_replicas:
                self.target = min(
                    cfg.max_replicas, max(self.target, actual) + 1
                )
                log_json(
                    logger, logging.INFO, "autoscaler_target_up",
                    target=self.target, shedDelta=shed_delta,
                    saturated=signals["saturated"], healthy=healthy,
                    burnRate=burn_rate,
                )
        elif (
            healthy > 0
            and actual >= self.target
            and signals["inflight"] / healthy
            <= cfg.low_inflight_per_replica
        ):
            self._low_ticks += 1
            if (
                self._low_ticks >= cfg.shrink_after_ticks
                and self.target > cfg.min_replicas
            ):
                self.target -= 1
                self._low_ticks = 0
                log_json(
                    logger, logging.INFO, "autoscaler_target_down",
                    target=self.target,
                )
        else:
            self._low_ticks = 0
        self.target = min(
            cfg.max_replicas, max(cfg.min_replicas, self.target)
        )

        if actual < self.target:
            if signals["warming"] > 0:
                return "idle"  # scale-up gates on the current warmup
            return self._grow(signals)
        if actual > self.target:
            return self._shrink()
        return "idle"

    def _grow(self, signals: dict) -> str:
        generation = signals.get("servingGeneration") or ""
        if not generation and signals.get("generationAmbiguous"):
            # mid-roll mixed pool (ungated swap): an empty generation
            # in the spawn template would launch a wrong/default-model
            # replica into live selection — defer until the roll
            # converges on one generation
            logger.warning(
                "autoscaler grow deferred: serving generation is "
                "ambiguous (mixed-generation pool)"
            )
            return "idle"
        try:
            self._spawn_replica(generation)
        except SpawnError as e:
            logger.warning("autoscaler grow failed: %s", e)
            return "idle"
        self._actions.labels("grow").inc()
        timeline_mod.get_timeline().record(
            "autoscaler_action",
            f"autoscaler grew the fleet toward target {self.target}",
            action="grow", target=self.target,
        )
        return "grow"

    def _shrink(self) -> str:
        states = self._router.replica_states()
        with self._lock:
            # a swap thread may be inserting into _owned right now —
            # the scan and the pop agree on the lock
            victims = [
                rid
                for rid in self._owned
                if states.get(rid) == "healthy"
            ]
            if not victims:
                return "idle"
            # newest first: the longest-lived replicas keep the warmest
            # caches and the densest affinity assignments
            victim = sorted(
                victims, key=lambda rid: int(rid.split("-")[-1])
            )[-1]
            slot = self._owned.pop(victim)
        # retire the SLOT first: the drain below SIGTERMs the process,
        # and a still-supervised slot would respawn it mid-retire
        slot.retire()
        self._router.retire(victim)
        self._actions.labels("shrink").inc()
        timeline_mod.get_timeline().record(
            "autoscaler_action",
            f"autoscaler retired replica {victim} toward target "
            f"{self.target}",
            action="shrink", target=self.target, replica_id=victim,
        )
        log_json(
            logger, logging.INFO, "autoscaler_shrink", replica=victim,
        )
        return "shrink"

    def _prune_retired(self) -> None:
        """Drop ownership of replicas something else retired (a fleet
        swap rolling the old generation): their slots must stop
        respawning the drained processes."""
        states = self._router.replica_states()
        with self._lock:
            released = [
                (rid, self._owned.pop(rid))
                for rid in list(self._owned)
                if rid not in states
            ]
        for rid, slot in released:
            slot.retire()
            # the router already drained+SIGTERM'd the process it
            # knew; a pid still alive here is either that one
            # finishing its drain (a second SIGTERM is idempotent)
            # or a respawn that beat this prune — which nobody
            # else will ever drain, so terminate it here rather
            # than leak an unregistered replica process
            proc = slot.proc
            if proc is not None and proc.poll() is None:
                proc.terminate()
            log_json(
                logger, logging.INFO, "autoscaler_released",
                replica=rid,
            )

    def status(self) -> dict:
        return {
            "target": self.target,
            "owned": len(self._owned),
            "lowTicks": self._low_ticks,
            "min": self.config.min_replicas,
            "max": self.config.max_replicas,
        }
