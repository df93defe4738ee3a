"""The respawn loop of the port's ``trainer`` verb (serving/workers.py).

Counterparts of ``tests/test_workers.py::TestRespawnBackoff`` on the
port's copy, with the same fake processes and fake clock, plus the
backoff schedule and constants held equal to the JAX module's, and
``terminate_children`` on real processes.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time

import pytest

from predictionio_tpu.serving import workers as jax_workers
from predictionio_tpu_torch.serving.workers import (
    _HEALTHY_UPTIME_S,
    _RESPAWN_DELAY_S,
    _RESPAWN_MAX_DELAY_S,
    WorkerSlot,
    backoff_delay_s,
    supervise_children,
    terminate_children,
)


class _FakeProc:
    """Popen stand-in: scripted exit at a clock time."""

    _next_pid = 1000

    def __init__(self, clock, dies_at=None, rc=1):
        _FakeProc._next_pid += 1
        self.pid = _FakeProc._next_pid
        self._clock = clock
        self.dies_at = dies_at
        self.rc = rc
        self.terminated = False

    def poll(self):
        if self.dies_at is not None and self._clock() >= self.dies_at:
            return self.rc
        return None

    def terminate(self):
        self.terminated = True
        self.dies_at = self._clock()
        self.rc = -15


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _run_supervisor_step(slots, clock, steps=1):
    """Run supervise_children for `steps` poll iterations at the fake
    clock's current time, then stop it."""
    stopping = threading.Event()
    count = {"n": 0}
    real_wait = stopping.wait

    def counting_wait(timeout=None):
        count["n"] += 1
        if count["n"] >= steps:
            stopping.set()
        return real_wait(0)

    stopping.wait = counting_wait
    supervise_children(
        slots, stopping, clock=clock, poll_interval_s=0.0
    )


class TestRespawnBackoff:
    def test_backoff_delay_escalates_and_caps(self):
        delays = [backoff_delay_s(f) for f in range(0, 8)]
        assert delays[0] == delays[1] == _RESPAWN_DELAY_S
        assert delays[2] == 2 * _RESPAWN_DELAY_S
        assert delays[3] == 4 * _RESPAWN_DELAY_S
        assert delays[-1] == _RESPAWN_MAX_DELAY_S

    def test_crash_loop_escalates_backoff(self):
        """A child that binds then dies young keeps DOUBLING the delay;
        a long-lived child resets it."""
        clock = _Clock()
        spawned = []

        def spawn():
            # each respawn dies 1s after it starts (young: < healthy)
            proc = _FakeProc(clock, dies_at=clock.t + 1.0)
            spawned.append(proc)
            return proc

        slot = WorkerSlot(spawn, clock=clock)
        delays = []
        for _ in range(5):
            # advance to the child's death and let the supervisor see it
            clock.t = slot.spawned_at + 1.0
            _run_supervisor_step([slot], clock)
            assert slot.proc is None
            delays.append(slot.respawn_at - clock.t)
            # advance past the respawn deadline so it respawns
            clock.t = slot.respawn_at
            _run_supervisor_step([slot], clock)
            assert slot.proc is not None
        assert delays == [1.0, 2.0, 4.0, 8.0, 16.0]
        # now the child serves past the healthy-uptime bar: clock resets
        slot.proc.dies_at = clock.t + _HEALTHY_UPTIME_S + 1.0
        clock.t = slot.proc.dies_at
        _run_supervisor_step([slot], clock)
        assert slot.fails == 0
        assert slot.respawn_at - clock.t == _RESPAWN_DELAY_S

    def test_sibling_backoff_does_not_reset_fast_cracher(self):
        """THE bug the old inline-sleep supervisor had: while slot A
        waits out a 30s backoff, slot B's child binds, serves 2s, and
        dies — B's uptime must read ~2s (escalating ITS backoff), not
        2s + A's sleep (which reset it and turned B's crash loop into
        a hot spin)."""
        clock = _Clock()

        def spawn_b():
            return _FakeProc(clock, dies_at=clock.t + 2.0)

        slot_a = WorkerSlot(lambda: _FakeProc(clock), clock=clock)
        slot_b = WorkerSlot(spawn_b, clock=clock)
        # A is already deep in backoff: respawn 30s out
        slot_a.proc = None
        slot_a.fails = 6
        slot_a.respawn_at = clock.t + 30.0
        # B dies young, repeatedly, while A waits
        delays = []
        for _ in range(3):
            clock.t = slot_b.spawned_at + 2.0
            _run_supervisor_step([slot_a, slot_b], clock)
            assert slot_b.proc is None, "B's exit went unnoticed"
            delays.append(slot_b.respawn_at - clock.t)
            clock.t = slot_b.respawn_at
            _run_supervisor_step([slot_a, slot_b], clock)
        # escalating, never reset by A's pending backoff
        assert delays == [1.0, 2.0, 4.0]
        assert slot_b.fails == 3

    def test_no_respawn_after_stopping(self):
        clock = _Clock()
        spawned = []

        def spawn():
            proc = _FakeProc(clock, dies_at=clock.t + 1.0)
            spawned.append(proc)
            return proc

        slot = WorkerSlot(spawn, clock=clock)
        clock.t = 2.0
        stopping = threading.Event()
        stopping.set()
        supervise_children(
            [slot], stopping, clock=clock, poll_interval_s=0.0
        )
        assert spawned == [slot.proc]  # nothing new spawned


@pytest.mark.parametrize("fails", range(0, 12))
def test_backoff_schedule_equals_the_jax_module(fails):
    assert backoff_delay_s(fails) == jax_workers.backoff_delay_s(fails)
    assert (_RESPAWN_DELAY_S, _RESPAWN_MAX_DELAY_S, _HEALTHY_UPTIME_S) == (
        jax_workers._RESPAWN_DELAY_S, jax_workers._RESPAWN_MAX_DELAY_S,
        jax_workers._HEALTHY_UPTIME_S)


def test_terminate_children_stops_live_processes():
    """SIGTERM to every live child; a child that ignores it is killed
    once the grace runs out; a slot mid-backoff is skipped."""
    polite = WorkerSlot(lambda: subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"]))
    stubborn = WorkerSlot(lambda: subprocess.Popen(
        [sys.executable, "-c",
         "import signal, sys, time\n"
         "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
         "print('ready', flush=True)\n"
         "time.sleep(60)"],
        stdout=subprocess.PIPE, text=True))
    assert stubborn.proc.stdout.readline().strip() == "ready"
    idle = WorkerSlot(lambda: None)
    t0 = time.monotonic()
    terminate_children([polite, stubborn, idle], grace_s=1.0)
    assert time.monotonic() - t0 < 30
    assert polite.proc.wait(timeout=10) == -15
    assert stubborn.proc.wait(timeout=10) == -9
    stubborn.proc.stdout.close()


def test_supervisor_respawns_a_real_child_until_stopped():
    """A real child that exits at once is respawned after the base
    delay; setting ``stopping`` ends the loop without another spawn."""
    spawned = []

    def spawn():
        spawned.append(subprocess.Popen([sys.executable, "-c", "pass"]))
        return spawned[-1]

    stopping = threading.Event()
    slot = WorkerSlot(spawn)
    runner = threading.Thread(
        target=supervise_children, args=([slot], stopping),
        kwargs={"poll_interval_s": 0.05})
    runner.start()
    try:
        deadline = time.monotonic() + 30
        while len(spawned) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        stopping.set()
        runner.join(timeout=10)
    assert not runner.is_alive()
    assert len(spawned) >= 2
    for proc in spawned:
        proc.wait(timeout=10)
