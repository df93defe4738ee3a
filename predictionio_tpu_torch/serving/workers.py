"""SO_REUSEPORT multi-worker front end, and the supervised respawn of
child processes.

Counterpart of ``predictionio_tpu/serving/workers.py``: one Python
process saturates one core parsing HTTP while the card underneath
answers batches in well under a millisecond, so ``--workers N`` runs N
processes, each binding the same host:port with ``SO_REUSEPORT``; the
kernel load-balances accepted connections across them, no proxy in
front.

Mechanics: the parent binds first (resolving port 0 to a real port),
then re-execs N-1 children (``python -m predictionio_tpu_torch.cli.main``
with ``--port <resolved> --workers 1 --reuse-port`` appended: a new
interpreter, never a fork of a process whose CUDA context is up) and
serves alongside them. Children that die are respawned — consecutive
startup failures back off exponentially (1 s doubling to 30 s; a
worker that served >=10 s resets the clock) — until the parent shuts
down; SIGTERM drains the parent, and its children are then reaped.

The respawn machinery (:class:`WorkerSlot` + :func:`supervise_children`)
is shared with the ``trainer`` verb's training child and the replica
autoscaler (:mod:`~predictionio_tpu_torch.serving.autoscaler`).

Caveats:

* every worker opens storage independently — the backends must be
  multi-process-shared (sqlite/eventlog/localfs; the ``memory`` backend
  is per-process and will serve inconsistent data);
* for ``deploy``, every worker stages its own copy of the model on the
  same card: N workers hold N copies of the tables and N CUDA contexts,
  and their kernels are time-sliced by the driver.
"""

from __future__ import annotations

import logging
import subprocess
import sys
import threading
import time
from typing import Callable

logger = logging.getLogger(__name__)

#: respawn backoff: a crash-looping worker must not spin the host
_RESPAWN_DELAY_S = 1.0
#: exponential backoff ceiling for consecutive startup failures
_RESPAWN_MAX_DELAY_S = 30.0
#: a worker that served at least this long is considered to have been
#: healthy — its next crash starts the backoff over
_HEALTHY_UPTIME_S = 10.0
#: how often the supervisor polls child liveness. Also the accuracy
#: bound on the measured uptime: exits are NOTICED within one poll of
#: happening, so a crash-loop cannot masquerade as healthy uptime.
_POLL_INTERVAL_S = 0.5


def rebuild_argv(argv: list[str], port: int) -> list[str]:
    """The child's CLI args: the parent's argv with ``--port`` pinned to
    the resolved port, ``--workers``/``--reuse-port`` removed, then
    ``--workers 1 --reuse-port`` appended."""
    value_opts = {"--workers", "--port"}
    flag_opts = {"--reuse-port"}
    out: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        name = a.split("=", 1)[0]
        if name in flag_opts:
            i += 1
        elif name in value_opts:
            i += 1 if "=" in a else 2
        else:
            out.append(a)
            i += 1
    return out + ["--port", str(port), "--workers", "1", "--reuse-port"]


def backoff_delay_s(fails: int) -> float:
    """Respawn delay after ``fails`` consecutive early exits (0 = the
    worker had been healthy: respawn after the base delay)."""
    return min(
        _RESPAWN_DELAY_S * (2 ** max(fails - 1, 0)),
        _RESPAWN_MAX_DELAY_S,
    )


class WorkerSlot:
    """One supervised child process and its respawn-backoff state.

    ``proc`` is None while the slot waits out a backoff delay
    (respawn due at ``respawn_at`` on the supervision clock)."""

    __slots__ = (
        "proc", "spawn", "spawned_at", "fails", "respawn_at", "retired",
        "retired_pid",
    )

    def __init__(self, spawn: Callable[[], subprocess.Popen],
                 clock: Callable[[], float] = time.monotonic,
                 proc: subprocess.Popen | None = None):
        self.spawn = spawn
        #: pass ``proc`` to adopt an already-running child (the
        #: autoscaler spawns a replica, reads its port, then supervises
        #: it) instead of spawning a fresh one
        self.proc: subprocess.Popen | None = (
            proc if proc is not None else spawn()
        )
        self.spawned_at = clock()
        self.fails = 0
        self.respawn_at = 0.0
        #: set by :meth:`retire`: the supervisor drops this slot at its
        #: next poll and never respawns it again
        self.retired = False
        #: pid of the process alive at :meth:`retire` time (None if the
        #: slot was mid-backoff) — that one is the retirer's to drain;
        #: any OTHER live pid at removal is a respawn that raced the
        #: retirement and must be terminated by the supervisor
        self.retired_pid: int | None = None

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def retire(self) -> None:
        """Take this slot out of supervision: a pending respawn (the
        slot mid-backoff) is cancelled, a future exit of its live
        process is NOT respawned, and the supervisor removes the slot
        from its list at the next poll. The process alive NOW is left
        to the retirer — the autoscaler drains it through the router's
        sticky admin-drain path, which SIGTERMs it losslessly — but a
        process the supervisor respawns AFTER this call (a respawn
        racing the retirement decision) is terminated at removal, never
        leaked. The pid snapshot happens before the flag is set so the
        supervisor can tell the two apart."""
        proc = self.proc
        self.retired_pid = proc.pid if proc is not None else None
        self.retired = True


def supervise_children(
    slots: list[WorkerSlot],
    stopping: threading.Event,
    *,
    clock: Callable[[], float] = time.monotonic,
    poll_interval_s: float = _POLL_INTERVAL_S,
) -> None:
    """Respawn loop shared by the multi-worker front end, the ``trainer``
    verb and the replica autoscaler. Polls every slot each
    ``poll_interval_s``;
    backoff waits are per-slot DEADLINES, never inline sleeps, so:

    * one slot's 30 s backoff cannot blind the supervisor to a sibling
      that crashed meanwhile — every exit is noticed within one poll;
    * uptime is measured when the exit is NOTICED (≤ one poll after it
      happened), so a child whose port bind succeeded but whose serve
      loop died before ``_HEALTHY_UPTIME_S`` keeps escalating the
      backoff instead of resetting it. The old inline-sleep shape
      credited such a child with the supervisor's own sleep time and
      reset the clock, turning a crash loop into a hot spin.

    The slot list is DYNAMIC: another thread (the replica autoscaler)
    may append new :class:`WorkerSlot` instances — picked up at the
    next poll — or :meth:`WorkerSlot.retire` an existing one, which
    cancels any pending respawn and removes the slot from the list.
    Each poll iterates a snapshot, so concurrent append/retire never
    invalidates the iteration, and backoff deadlines stay strictly
    per-slot — membership churn cannot leak one slot's respawn timing
    into another's.

    Returns when ``stopping`` is set.
    """
    while not stopping.is_set():
        now = clock()
        for slot in list(slots):
            if slot.retired:
                # cancel a pending respawn and drop the slot; the
                # process alive at retire() time is the retirer's to
                # drain, but one respawned AFTER (respawn raced the
                # retirement) would leak — nothing drains a pid the
                # retirer never saw, so terminate it here
                proc = slot.proc
                if (
                    proc is not None
                    and proc.pid != slot.retired_pid
                    and proc.poll() is None
                ):
                    logger.warning(
                        "terminating pid %s respawned after slot "
                        "retirement", proc.pid,
                    )
                    proc.terminate()
                try:
                    slots.remove(slot)
                except ValueError:
                    pass  # already removed by a concurrent retire
                continue
            if slot.proc is None:
                if now >= slot.respawn_at and not stopping.is_set():
                    slot.proc = slot.spawn()
                    slot.spawned_at = clock()
                continue
            rc = slot.proc.poll()
            if rc is None or stopping.is_set():
                continue
            uptime = now - slot.spawned_at
            slot.fails = 0 if uptime >= _HEALTHY_UPTIME_S else slot.fails + 1
            delay = backoff_delay_s(slot.fails)
            logger.warning(
                "worker pid %d exited rc=%s after %.1fs; "
                "respawning in %.1fs",
                slot.proc.pid, rc, uptime, delay,
            )
            slot.proc = None
            slot.respawn_at = now + delay
        stopping.wait(poll_interval_s)


def terminate_children(
    slots: list[WorkerSlot], grace_s: float
) -> None:
    """SIGTERM every live child, give the group ``grace_s`` to drain,
    then SIGKILL stragglers (the lossless-drain contract: a SIGTERM'd
    worker finishes its in-flight requests and the current device batch
    before exiting)."""
    live = [s for s in slots if s.proc is not None]
    for slot in live:
        slot.proc.terminate()
    deadline = time.monotonic() + grace_s
    for slot in live:
        try:
            slot.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            slot.proc.kill()


def serve_with_workers(
    http_server,
    n_workers: int,
    child_argv: list[str],
    out=print,
) -> int:
    """Serve ``http_server`` (already bound with ``reuse_port=True``) in
    this process while supervising ``n_workers - 1`` re-exec'd children
    on the same port. Blocks until interrupted; returns an exit code."""
    stopping = threading.Event()

    def spawn() -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main"]
            + child_argv,
        )

    slots = [WorkerSlot(spawn) for _ in range(max(0, n_workers - 1))]
    if slots:
        out(
            f"{len(slots) + 1} workers sharing port {http_server.port} "
            f"(pids {[s.pid for s in slots]} + self)"
        )
    watchdog = threading.Thread(
        target=supervise_children, args=(slots, stopping), daemon=True
    )
    watchdog.start()

    # the parent serves traffic too: SIGTERM drains it like any other
    # server — serve_forever returns when the drain completes. Ctrl-C
    # stays an immediate group teardown.
    from predictionio_tpu_torch.serving import resilience

    restore = resilience.install_signal_drain(http_server)
    try:
        http_server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        restore()
        # waits for a drain still running its hooks (an engine server's
        # batchers close there), or stops an interrupted server now
        http_server.shutdown()
        stopping.set()
        # the watchdog must be parked before children are reaped — a
        # respawn mid-teardown would orphan the new process (the loop
        # no longer sleeps out backoffs inline, so one poll suffices)
        watchdog.join(timeout=_POLL_INTERVAL_S * 4 + 1.0)
        # children drain on SIGTERM too — give them the drain grace
        # (plus slack) before escalating to SIGKILL, or a slow device
        # batch gets cut mid-drain and the lossless contract breaks
        terminate_children(slots, resilience.drain_grace_s() + 5.0)
    return 0
