"""Supervised respawn of child processes, with exponential backoff.

Counterpart of ``backoff_delay_s``, ``WorkerSlot``,
``supervise_children`` and ``terminate_children`` in
``predictionio_tpu/serving/workers.py``: the loop the ``trainer`` verb
runs over its training child. A child that dies is respawned;
consecutive early exits back off exponentially (1 s doubling to 30 s; a
child that ran at least 10 s resets the clock) until the parent stops.

The JAX module's SO_REUSEPORT multi-worker front end (``rebuild_argv``,
``serve_with_workers``: ``--workers N`` on ``deploy`` and
``eventserver``) is ROADMAP.md, queue 1, item 5b.
"""

from __future__ import annotations

import logging
import subprocess
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

    __slots__ = ("proc", "spawn", "spawned_at", "fails", "respawn_at")

    def __init__(self, spawn: Callable[[], subprocess.Popen],
                 clock: Callable[[], float] = time.monotonic):
        self.spawn = spawn
        self.proc: subprocess.Popen | None = spawn()
        self.spawned_at = clock()
        self.fails = 0
        self.respawn_at = 0.0

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None


def supervise_children(
    slots: list[WorkerSlot],
    stopping: threading.Event,
    *,
    clock: Callable[[], float] = time.monotonic,
    poll_interval_s: float = _POLL_INTERVAL_S,
) -> None:
    """Respawn loop of the ``trainer`` verb (in the JAX package also of
    the multi-worker front end and the router's replica supervisor,
    whose autoscaler appends and retires slots: ROADMAP.md, queue 1,
    item 5b).
    Polls every slot each ``poll_interval_s``; backoff waits are
    per-slot DEADLINES, never inline sleeps, so:

    * one slot's 30 s backoff cannot blind the supervisor to a sibling
      that crashed meanwhile — every exit is noticed within one poll;
    * uptime is measured when the exit is NOTICED (≤ one poll after it
      happened), so a child whose port bind succeeded but whose serve
      loop died before ``_HEALTHY_UPTIME_S`` keeps escalating the
      backoff instead of resetting it. The old inline-sleep shape
      credited such a child with the supervisor's own sleep time and
      reset the clock, turning a crash loop into a hot spin.

    Returns when ``stopping`` is set.
    """
    while not stopping.is_set():
        now = clock()
        for slot in slots:
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
    then SIGKILL stragglers (the lossless-drain contract of
    docs/robustness.md: a SIGTERM'd worker finishes its in-flight
    requests and the current device batch before exiting)."""
    live = [s for s in slots if s.proc is not None]
    for slot in live:
        slot.proc.terminate()
    deadline = time.monotonic() + grace_s
    for slot in live:
        try:
            slot.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            slot.proc.kill()
