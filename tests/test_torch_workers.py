"""The SO_REUSEPORT front end and the respawn loop (serving/workers.py).

* Counterparts of ``tests/test_workers.py::TestRespawnBackoff`` on the
  port's copy, with the same fake processes and fake clock, plus the
  backoff schedule and constants held equal to the JAX module's, and
  ``terminate_children`` on real processes;
* ``rebuild_argv`` equal to the JAX module's on its cases and on
  hypothesis-drawn argvs;
* ``WorkerSlot.retire`` and ``proc=`` adoption: the cases of the JAX
  package's ``TestDynamicSlots``, run on both modules;
* ``HTTPServer(reuse_port=True)`` lets two servers of either package
  bind one port, and a platform without ``SO_REUSEPORT`` gets the same
  clean error from both consoles;
* real children: ``deploy --workers 2`` and ``eventserver --workers 2``
  of both consoles on one sqlite store (the JAX-trained generation
  served by both), their stdout lines and exit codes alike, answers
  from two pids each, every worker gone after SIGTERM; ``--reuse-port``
  alone binds beside a listener that also set it.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from predictionio_tpu.serving import http as jax_http
from predictionio_tpu.serving import workers as jax_workers
from predictionio_tpu_torch.serving import http, workers
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


# -- rebuild_argv ------------------------------------------------------------

_ARGV_CASES = {
    "pins_port_and_resets_workers": (
        ["eventserver", "--ip", "127.0.0.1", "--port", "0", "--workers",
         "4", "--stats"], 7070),
    "equals_style_options": (["eventserver", "--port=0", "--workers=3"],
                             8123),
    "port_equals_form_only": (["deploy", "--port=8000"], 8001),
    "repeated_workers_flags": (["eventserver", "--workers", "4",
                                "--workers=8", "--workers", "2"], 7070),
    "value_that_looks_like_flag": (["deploy", "--workers", "4", "--port",
                                    "0", "--variant", "e.json"], 9000),
    "existing_reuse_port": (["eventserver", "--reuse-port"], 9),
}


@pytest.mark.parametrize("case", sorted(_ARGV_CASES))
def test_rebuild_argv_cases_alike(case):
    argv, port = _ARGV_CASES[case]
    got = workers.rebuild_argv(list(argv), port)
    assert got == jax_workers.rebuild_argv(list(argv), port)
    assert got[-5:] == ["--port", str(port), "--workers", "1",
                        "--reuse-port"]
    assert got.count("--reuse-port") == 1


_TOKENS = st.sampled_from(["deploy", "eventserver", "--port", "--port=0",
                           "--workers", "--workers=3", "--reuse-port",
                           "--variant", "e.json", "--ip", "127.0.0.1",
                           "0", "8", "--stats", "--device", "cpu"])


@settings(max_examples=200, deadline=None)
@given(argv=st.lists(_TOKENS, max_size=12), port=st.integers(0, 65535))
def test_rebuild_argv_drawn_alike(argv, port):
    assert workers.rebuild_argv(list(argv), port) == (
        jax_workers.rebuild_argv(list(argv), port))


# -- retire and adoption -----------------------------------------------------

def _dyn_retire_mid_backoff(m):
    clock, spawned = _Clock(), []

    def spawn():
        spawned.append(_FakeProc(clock, dies_at=clock.t + 1.0))
        return spawned[-1]

    slot = m.WorkerSlot(spawn, clock=clock)
    slots = [slot]
    clock.t = slot.spawned_at + 1.0
    _step(m, slots, clock)
    pending = slot.proc is None and slot.respawn_at > clock.t
    slot.retire()
    clock.t = slot.respawn_at + 5.0
    _step(m, slots, clock)
    return pending, slots == [], slot.proc is None, len(spawned)


def _dyn_live_proc_released(m):
    clock, spawned = _Clock(), []

    def spawn():
        spawned.append(_FakeProc(clock, dies_at=clock.t + 100.0))
        return spawned[-1]

    slot = m.WorkerSlot(spawn, clock=clock)
    live = slot.proc
    slots = [slot]
    slot.retire()
    _step(m, slots, clock)
    first = (slots == [], slot.proc is live, live.terminated,
             slot.retired_pid == live.pid)
    clock.t = 200.0
    _step(m, slots, clock)
    return first, len(spawned)


def _dyn_respawn_racing_retire(m):
    clock = _Clock()
    slot = m.WorkerSlot(lambda: _FakeProc(clock, dies_at=clock.t + 100.0),
                        clock=clock)
    slot.proc = None
    slot.respawn_at = 5.0
    slots = [slot]
    slot.retire()
    raced = _FakeProc(clock, dies_at=clock.t + 100.0)
    slot.proc = raced
    _step(m, slots, clock)
    return slot.retired_pid, slots == [], raced.terminated


def _dyn_appended_slot(m):
    clock = _Clock()
    slot_a = m.WorkerSlot(lambda: _FakeProc(clock, dies_at=clock.t + 100.0),
                          clock=clock)
    slots = [slot_a]
    _step(m, slots, clock)
    slot_b = m.WorkerSlot(lambda: _FakeProc(clock, dies_at=clock.t + 1.0),
                          clock=clock)
    slots.append(slot_b)
    clock.t = slot_b.spawned_at + 1.0
    _step(m, slots, clock)
    return (slot_b.proc is None, slot_b.respawn_at - clock.t,
            slot_a.proc is not None)


def _dyn_sibling_backoff(m):
    clock = _Clock()
    slot_a = m.WorkerSlot(lambda: _FakeProc(clock), clock=clock)
    slot_b = m.WorkerSlot(lambda: _FakeProc(clock), clock=clock)
    slot_a.proc, slot_a.fails, slot_a.respawn_at = None, 3, 4.0
    slot_b.proc, slot_b.fails, slot_b.respawn_at = None, 1, 10.0
    slots = [slot_a, slot_b]
    slot_a.retire()
    clock.t = 5.0
    _step(m, slots, clock)
    mid = (slots == [slot_b], slot_a.proc is None, slot_b.proc is None,
           slot_b.respawn_at)
    clock.t = 10.0
    _step(m, slots, clock)
    return mid, slot_b.proc is not None


def _dyn_retired_twice(m):
    clock = _Clock()
    slot = m.WorkerSlot(lambda: _FakeProc(clock), clock=clock)
    slot.retire()
    slots = [slot, slot]
    _step(m, slots, clock)
    return slots


def _dyn_adopts(m):
    clock = _Clock()
    existing = _FakeProc(clock)
    spawned = []
    slot = m.WorkerSlot(lambda: spawned.append(1), clock=clock,
                        proc=existing)
    return slot.proc is existing, slot.pid == existing.pid, spawned


_DYNAMIC = {
    "retire_mid_backoff_cancels_pending_respawn": _dyn_retire_mid_backoff,
    "retired_slot_with_live_proc_is_released": _dyn_live_proc_released,
    "respawn_racing_retirement_is_terminated": _dyn_respawn_racing_retire,
    "appended_slot_supervised_next_poll": _dyn_appended_slot,
    "retire_does_not_disturb_sibling_backoff": _dyn_sibling_backoff,
    "concurrent_retire_of_same_slot_is_safe": _dyn_retired_twice,
    "adopts_existing_process": _dyn_adopts,
}


def _step(m, slots, clock):
    stopping = threading.Event()
    real_wait = stopping.wait

    def once(timeout=None):
        stopping.set()
        return real_wait(0)

    stopping.wait = once
    m.supervise_children(slots, stopping, clock=clock, poll_interval_s=0.0)


@pytest.mark.parametrize("case", sorted(_DYNAMIC))
def test_dynamic_slots_alike(case):
    got = _DYNAMIC[case](workers)
    assert got == _DYNAMIC[case](jax_workers)
    want = {
        "retire_mid_backoff_cancels_pending_respawn": (True, True, True, 1),
        "retired_slot_with_live_proc_is_released": (
            (True, True, False, True), 1),
        "respawn_racing_retirement_is_terminated": (None, True, True),
        "appended_slot_supervised_next_poll": (True, 1.0, True),
        "retire_does_not_disturb_sibling_backoff": (
            (True, True, True, 10.0), True),
        "concurrent_retire_of_same_slot_is_safe": [],
        "adopts_existing_process": (True, True, []),
    }[case]
    assert got == want


# -- SO_REUSEPORT --------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_reuse_port_binds_one_port_twice(pkg):
    mod = {"port": http, "jax": jax_http}[pkg]

    def server(port, reuse):
        r = mod.Router()
        r.route("GET", "/x", lambda req: mod.Response(200, {"pid": 1}))
        return mod.HTTPServer(r, host="127.0.0.1", port=port,
                              reuse_port=reuse)

    # started before they are shut down: the JAX server's shutdown waits
    # for a serve loop
    first = server(0, True)
    first.start()
    second = None
    try:
        second = server(first.port, True)
        second.start()
        assert second.port == first.port
        with pytest.raises(OSError):
            server(first.port, False)
    finally:
        for s in (first, second):
            if s is not None:
                s.shutdown()


def test_no_reuseport_platform_refused_alike(monkeypatch):
    from predictionio_tpu.cli import main as jax_main
    from predictionio_tpu_torch.cli import main as port_main

    assert port_main._reuseport_unsupported() is None
    monkeypatch.delattr(socket, "SO_REUSEPORT")
    msg = port_main._reuseport_unsupported()
    assert msg == jax_main._reuseport_unsupported()
    assert "SO_REUSEPORT" in msg
    r = http.Router()
    with pytest.raises(OSError, match="SO_REUSEPORT is not supported"):
        http.HTTPServer(r, host="127.0.0.1", port=0, reuse_port=True)
    assert port_main.main(["eventserver", "--workers", "2"]) == 1


# -- real worker groups of both consoles --------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent.parent
_CONSOLES = {"port": "predictionio_tpu_torch.cli.main",
             "jax": "predictionio_tpu.cli.main"}


def _store_env(base) -> dict:
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(base / "pio.sqlite"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(base / "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }


@pytest.fixture(scope="module")
def shared_store(tmp_path_factory):
    """One sqlite + localfs store holding a generation the JAX package
    trained on the CPU (both packages serve it), and an app for events;
    (env, engine.json path)."""
    from predictionio_tpu.core.workflow import run_train
    from predictionio_tpu.data.event import Event
    from predictionio_tpu.data.storage import App, Storage, set_storage
    from predictionio_tpu.models.recommendation import recommendation_engine

    base = tmp_path_factory.mktemp("fleet-store")
    env = _store_env(base)
    storage = Storage(env=env)
    rng = np.random.default_rng(4)
    app_id = storage.get_meta_data_apps().insert(App(0, "shop"))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{i}",
              properties={"rating": int(v)})
        for u, i, v in zip(rng.integers(0, 30, 300), rng.integers(0, 20, 300),
                           rng.integers(1, 6, 300))], app_id)
    variant = {"id": "fleet-rec", "engineFactory": "recommendation",
               "datasource": {"params": {"app_name": "shop"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 4, "num_iterations": 2}}]}
    path = base / "engine.json"
    path.write_text(json.dumps(variant))
    engine = recommendation_engine()
    set_storage(storage)
    try:
        run_train(engine, engine.params_from_variant(variant), "fleet-rec",
                  storage=storage)
    finally:
        set_storage(None)
    full = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1",
                PIO_FS_BASEDIR=str(base), JAX_PLATFORMS="cpu", **env)
    return full, str(path)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pids_behind(port: int, want: int, path: str = "/") -> set:
    """Pids that answer ``GET /`` on fresh connections to ``port``
    (every worker, within a bounded number of tries)."""
    pids = set()
    for _ in range(400):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=10) as resp:
                pids.add(json.loads(resp.read())["pid"])
        except OSError:
            time.sleep(0.05)
        if len(pids) >= want:
            break
    return pids


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _group(pkg: str, argv: list, env: dict, port: int, n: int,
           answer) -> tuple:
    """Run one console's server verb as a process group on ``port``;
    ``answer(port)`` is what its pids answered. (rc, stdout, the pids,
    what ``answer`` saw)."""
    cmd = [sys.executable, "-m", _CONSOLES[pkg]] + argv
    if pkg == "port" and argv[0] == "deploy":
        cmd += ["--device", "cpu"]
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    pids: set = set()
    try:
        banner = proc.stdout.readline()
        assert "listening on" in banner, banner
        deadline = time.monotonic() + 120
        while len(pids) < n and time.monotonic() < deadline:
            pids |= _pids_behind(port, n)
        seen = answer(port)
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    for pid in pids - {proc.pid}:
        deadline = time.monotonic() + 30
        while _alive(pid) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not _alive(pid), f"{pkg} worker {pid} outlived its parent"
    # the children write to the same stdout: lines in a stable order
    out = sorted(re.sub(r"\d{2,}", "<n>", banner + rest).splitlines())
    return proc.returncode, out, pids, seen


def _query_answers(port: int) -> list:
    got = []
    for u in range(8):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/queries.json", method="POST",
            data=json.dumps({"user": f"u{u}", "num": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            got.append([e["item"] for e in json.loads(
                resp.read())["itemScores"]])
    return got


def test_deploy_workers_answer_from_two_pids_alike(shared_store):
    env, variant = shared_store
    results = {}
    for pkg in ("port", "jax"):
        port = _free_port()
        results[pkg] = _group(
            pkg, ["deploy", "--variant", variant, "--ip", "127.0.0.1",
                  "--port", str(port), "--workers", "2"],
            env, port, 2, _query_answers)
    (p_rc, p_out, p_pids, p_ans), (j_rc, j_out, j_pids, j_ans) = (
        results["port"], results["jax"])
    assert (p_rc, p_out) == (j_rc, j_out)
    assert p_rc == 0
    assert p_out == [  # the parent's two lines, the child's banner
        "2 workers sharing port <n> (pids [<n>] + self)",
        "Engine server is listening on <n>.0.0.1:<n>",
        "Engine server is listening on <n>.0.0.1:<n>"]
    assert len(p_pids) == len(j_pids) == 2
    # one JAX-trained generation: the same items from either console
    assert p_ans == j_ans


def test_eventserver_workers_alike(shared_store):
    env, _variant = shared_store
    results = {}
    for pkg in ("port", "jax"):
        port = _free_port()
        results[pkg] = _group(
            pkg, ["eventserver", "--ip", "127.0.0.1", "--port", str(port),
                  "--workers", "2"], env, port, 2, lambda p: None)
    assert results["port"][:2] == results["jax"][:2]
    assert results["port"][0] == 0
    assert results["port"][1] == [
        "2 workers sharing port <n> (pids [<n>] + self)",
        "Event server is listening on <n>.0.0.1:<n>",
        "Event server is listening on <n>.0.0.1:<n>"]
    assert len(results["port"][2]) == len(results["jax"][2]) == 2


@pytest.mark.parametrize("verb", ["deploy", "eventserver"])
def test_reuse_port_serves_beside_a_listener_alike(shared_store, verb):
    """``--reuse-port`` alone (a re-exec'd worker's flag): the verb binds
    a port another SO_REUSEPORT listener holds, and a deploy skips the
    undeploy handshake that would stop its parent."""
    env, variant = shared_store
    results = {}
    for pkg in ("port", "jax"):
        holder = http.HTTPServer(http.Router(), host="127.0.0.1", port=0,
                                 reuse_port=True)
        holder.start()
        port = holder.port
        argv = [verb, "--ip", "127.0.0.1", "--port", str(port),
                "--reuse-port"]
        if verb == "deploy":
            argv[1:1] = ["--variant", variant]
        try:
            results[pkg] = _group(pkg, argv, env, port, 1, lambda p: None)
        finally:
            holder.shutdown()
    assert results["port"][:2] == results["jax"][:2]
    assert results["port"][0] == 0
    name = {"deploy": "Engine", "eventserver": "Event"}[verb]
    assert results["port"][1] == [
        f"{name} server is listening on <n>.0.0.1:<n>"]
