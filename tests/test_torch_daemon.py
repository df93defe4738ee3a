"""Daemon management of the port's console (start-all / stop-all /
daemons / daemon): pidfiles, stale and garbage pidfiles, and real
background servers through ``python -m predictionio_tpu_torch.cli.main``.

Counterparts of ``tests/test_daemon.py``, plus ``start-all`` bringing up
the event server, the dashboard and the admin server together, and with
each of its store flags minipg or the store server beside them.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import urllib.error
import urllib.request

import pytest

from predictionio_tpu_torch.cli import daemon
from predictionio_tpu_torch.cli.main import main

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture()
def piodir(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "SQL")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_SQL_TYPE", "sqlite")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_SQL_PATH",
                       str(tmp_path / "pio.sqlite"))
    return tmp_path


def _dead_pid() -> int:
    p = subprocess.Popen(["sleep", "0"])
    p.wait()
    return p.pid


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port: int, path: str = "/"):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=10
    ) as resp:
        return resp.read().decode()


class TestPidfiles:
    def test_stopped_when_no_pidfile(self, piodir):
        assert daemon.service_status("eventserver") == ("stopped", None)

    def test_stale_pidfile_detected(self, piodir):
        os.makedirs(os.path.dirname(daemon.pidfile("eventserver")),
                    exist_ok=True)
        dead = _dead_pid()
        with open(daemon.pidfile("eventserver"), "w") as f:
            f.write(str(dead))
        state, pid = daemon.service_status("eventserver")
        assert state == "stale-pidfile" and pid == dead

    def test_stop_removes_stale_pidfile(self, piodir):
        os.makedirs(os.path.dirname(daemon.pidfile("dashboard")),
                    exist_ok=True)
        with open(daemon.pidfile("dashboard"), "w") as f:
            f.write(str(_dead_pid()))
        assert daemon.stop_daemon("dashboard") == "stale pidfile removed"
        assert daemon.service_status("dashboard") == ("stopped", None)

    def test_stop_not_running(self, piodir):
        assert daemon.stop_daemon("adminserver") == "not running"

    def test_garbage_pidfile_is_stopped(self, piodir):
        os.makedirs(os.path.dirname(daemon.pidfile("x")), exist_ok=True)
        with open(daemon.pidfile("x"), "w") as f:
            f.write("not-a-pid")
        assert daemon.service_status("x") == ("stopped", None)

    def test_layout_is_the_jax_modules(self, piodir):
        assert daemon.pidfile("eventserver") == str(
            piodir / "run" / "eventserver.pid")
        assert daemon.logfile("dashboard") == str(
            piodir / "log" / "dashboard.log")
        assert list(daemon.SERVICES) == [
            "eventserver", "dashboard", "adminserver"]


class TestLifecycle:
    """Real daemonized servers through the full lifecycle."""

    def test_eventserver_daemon_roundtrip(self, piodir):
        port = _free_port()
        pid = daemon.spawn_daemon(
            "eventserver",
            ["eventserver", "--ip", "127.0.0.1", "--port", str(port)],
        )
        try:
            assert daemon.wait_port(
                "127.0.0.1", port, timeout=60.0, pid=pid
            ), open(daemon.logfile("eventserver")).read()[-2000:]
            state, got_pid = daemon.service_status("eventserver")
            assert state == "running" and got_pid == pid
            assert json.loads(_get(port))["status"] == "alive"
            # the boot line of the port's console is in the log
            log = open(daemon.logfile("eventserver")).read()
            assert f"Event server is listening on 127.0.0.1:{port}" in log
        finally:
            outcome = daemon.stop_daemon("eventserver")
        assert outcome.startswith("stopped")
        assert daemon.service_status("eventserver") == ("stopped", None)
        assert not daemon.pid_alive(pid)

    def test_double_start_refused(self, piodir, monkeypatch):
        # only manage the event server here
        monkeypatch.setattr(daemon, "SERVICES", {
            "eventserver": daemon.SERVICES["eventserver"]})
        port = _free_port()
        pid = daemon.spawn_daemon(
            "eventserver",
            ["eventserver", "--ip", "127.0.0.1", "--port", str(port)],
        )
        try:
            assert daemon.wait_port(
                "127.0.0.1", port, timeout=60.0, pid=pid
            ), open(daemon.logfile("eventserver")).read()[-2000:]
            lines = []
            assert daemon.start_all(
                ip="127.0.0.1", ports={"eventserver": port},
                out=lines.append,
            ) == 0
            assert "eventserver: already running" in "\n".join(lines)
            assert daemon.read_pid("eventserver") == pid
        finally:
            daemon.stop_daemon("eventserver")

    def test_start_all_daemons_stop_all(self, piodir, capsys):
        """``start-all`` brings up the event server, the dashboard and
        the admin server; ``daemons`` reports all three running; each
        serves; ``stop-all`` removes every pidfile."""
        ports = {name: _free_port() for name in daemon.SERVICES}
        try:
            assert main([
                "start-all", "--ip", "127.0.0.1",
                "--eventserver-port", str(ports["eventserver"]),
                "--dashboard-port", str(ports["dashboard"]),
                "--adminserver-port", str(ports["adminserver"]),
            ]) == 0, capsys.readouterr()
            assert main(["daemons"]) == 0
            out = capsys.readouterr().out
            for name in daemon.SERVICES:
                assert f"{name}: running (pid" in out
            assert json.loads(_get(ports["eventserver"]))["status"] == "alive"
            assert "Completed Evaluations" in _get(ports["dashboard"])
            assert json.loads(_get(ports["adminserver"])) == {
                "status": "alive"}
        finally:
            assert main(["stop-all"]) == 0
        out = capsys.readouterr().out
        for name in daemon.SERVICES:
            assert f"{name}: stopped (pid" in out
        assert not os.listdir(piodir / "run")
        assert main(["daemons"]) == 1

    def test_daemon_verb_runs_any_verb(self, piodir, capsys):
        port = _free_port()
        try:
            assert main(["daemon", "--name", "dash", "--", "dashboard",
                         "--ip", "127.0.0.1", "--port", str(port)]) == 0
            pid = daemon.read_pid("dash")
            assert daemon.wait_port("127.0.0.1", port, timeout=60.0,
                                    pid=pid)
            assert main(["daemon", "--name", "dash", "--", "dashboard"]) == 1
            assert "dash: already running" in capsys.readouterr().err
        finally:
            daemon.stop_daemon("dash")


class TestStatusAll:
    def test_status_reports_stopped(self, piodir):
        lines = []
        assert daemon.status_all(out=lines.append) == 1
        assert lines == [f"{name}: stopped" for name in daemon.SERVICES]


def _pg_select_one(port: int) -> list:
    from predictionio_tpu_torch.data.storage import pgwire

    conn = pgwire.connect(host="127.0.0.1", port=port, user="pio",
                          database="pio", password=None)
    try:
        cur = conn.cursor()
        cur.execute("SELECT 1")
        return cur.fetchall()
    finally:
        conn.close()


@pytest.mark.parametrize("flag", [
    ["--with-minipg"], ["--minipg-port"], ["--with-storeserver"],
    ["--storeserver-port"], ["--storeserver-access-key", "k"],
])
def test_start_all_brings_up_the_networked_stores(piodir, capsys,
                                                  monkeypatch, flag):
    """Each of ``start-all``'s store flags brings up its daemon (minipg
    answering a query over the postgres wire, the store server its
    status, behind the key when one is given) beside the three
    services; ``stop-all`` ends every one and removes every pidfile."""
    ports = {name: _free_port() for name in (
        *daemon.SERVICES, *daemon.OPTIONAL_SERVICES)}
    # the stores' default ports, where the flag names none
    monkeypatch.setattr(daemon, "OPTIONAL_SERVICES", {
        name: ports[name] for name in daemon.OPTIONAL_SERVICES})
    store = "minipg" if "minipg" in flag[0] else "storeserver"
    argv = ["start-all", "--ip", "127.0.0.1", *flag]
    if flag[0].endswith("-port"):
        argv.append(str(ports[store]))
    for name in daemon.SERVICES:
        argv += [f"--{name}-port", str(ports[name])]
    pids = {}
    try:
        assert main(argv) == 0, capsys.readouterr()
        assert main(["daemons"]) == 0
        out = capsys.readouterr().out
        for name in (*daemon.SERVICES, store):
            assert f"{name}: running (pid" in out, out
            pids[name] = daemon.read_pid(name)
        other = ({"minipg", "storeserver"} - {store}).pop()
        assert other not in out and daemon.read_pid(other) is None
        if store == "minipg":
            assert _pg_select_one(ports["minipg"]) == [(1,)]
        elif "--storeserver-access-key" in flag:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(ports["storeserver"], "/meta/apps")
            assert e.value.code == 401
            req = urllib.request.Request(
                f"http://127.0.0.1:{ports['storeserver']}/meta/apps",
                headers={"Authorization": "Bearer k"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert json.loads(resp.read()) == []
        else:
            assert json.loads(_get(ports["storeserver"])) == {
                "status": "alive", "service": "storeserver"}
    finally:
        assert main(["stop-all"]) == 0
    out = capsys.readouterr().out
    for name in (*daemon.SERVICES, store):
        assert f"{name}: stopped (pid {pids[name]})" in out, out
    assert not os.listdir(piodir / "run")
    assert not any(daemon.pid_alive(pid) for pid in pids.values())
