"""Daemonized server management — ``start-all`` / ``stop-all`` / ``daemon``.

Counterpart of ``predictionio_tpu/cli/daemon.py`` (the reference's
``bin/pio-start-all``, ``bin/pio-stop-all``, ``bin/pio-daemon``): bring
the serving processes up as managed background daemons with pidfiles
and log files, and tear them down cleanly. ``start-all`` manages three
long-running HTTP services:

* event server  (default :7070)
* dashboard     (default :9000)
* admin server  (default :7071)

plus, optionally, minipg when ``--with-minipg`` is given (the
postgres-wire dev store for multi-host topologies) and the store server
when ``--with-storeserver`` is given (metadata, model blobs and events
over HTTP).

Layout (under ``PIO_FS_BASEDIR``, default ``~/.piotpu``)::

    run/<name>.pid      pidfile (reference: $PIO_HOME/eventserver.pid)
    log/<name>.log      combined stdout+stderr of the daemon

Each daemon is a fresh ``python -m predictionio_tpu_torch.cli.main <verb>``
in its own session (the reference's nohup+exec), so ``stop-all`` can
signal the whole process group. Stale pidfiles (machine rebooted, process
gone) are detected and cleaned on both start and stop.
"""

from __future__ import annotations

import errno
import os
import signal
import socket
import subprocess
import sys
import time

#: optional daemons (verb == service name, --ip/--port only): default port
OPTIONAL_SERVICES: dict[str, int] = {
    "minipg": 5432,
    "storeserver": 7072,
}

#: name -> (CLI verb, default port, extra args)
SERVICES: dict[str, tuple[str, int, tuple[str, ...]]] = {
    "eventserver": ("eventserver", 7070, ("--stats",)),
    "dashboard": ("dashboard", 9000, ()),
    "adminserver": ("adminserver", 7071, ()),
}


def base_dir() -> str:
    return os.environ.get(
        "PIO_FS_BASEDIR",
        os.path.join(os.path.expanduser("~"), ".piotpu"),
    )


def _run_dir() -> str:
    return os.path.join(base_dir(), "run")


def _log_dir() -> str:
    return os.path.join(base_dir(), "log")


def pidfile(name: str) -> str:
    return os.path.join(_run_dir(), f"{name}.pid")


def logfile(name: str) -> str:
    return os.path.join(_log_dir(), f"{name}.log")


def read_pid(name: str) -> int | None:
    try:
        with open(pidfile(name)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError as exc:
        if exc.errno == errno.ESRCH:
            return False
        return True  # EPERM: alive but not ours
    # a zombie (exited, unreaped — e.g. the spawner is still alive and
    # hasn't waited) answers kill(0) but is dead for our purposes
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return True


def service_status(name: str) -> tuple[str, int | None]:
    """Returns (state, pid): running | stale-pidfile | stopped."""
    pid = read_pid(name)
    if pid is None:
        return "stopped", None
    if pid_alive(pid):
        return "running", pid
    return "stale-pidfile", pid


def spawn_daemon(
    name: str, argv: list[str], env: dict | None = None
) -> int:
    """Start ``python -m predictionio_tpu_torch.cli.main <argv>`` detached in
    its own session, stdout+stderr to the log file; returns the pid
    (reference bin/pio-daemon: nohup + pidfile)."""
    os.makedirs(_run_dir(), exist_ok=True)
    os.makedirs(_log_dir(), exist_ok=True)
    log = open(logfile(name), "ab", buffering=0)
    try:
        # deliberately detached: the daemon outlives this process;
        # ownership is the pidfile, teardown is stop_daemon's
        # process-group SIGTERM
        # pio-lint: disable-next=resource-leak -- detached daemon by design
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", *argv],
            stdin=subprocess.DEVNULL,
            stdout=log,
            stderr=subprocess.STDOUT,
            start_new_session=True,  # own process group → clean signaling
            env={**os.environ, **(env or {})},
        )
    finally:
        log.close()
    with open(pidfile(name), "w") as f:
        f.write(str(proc.pid))
    return proc.pid


def wait_port(
    host: str, port: int, timeout: float = 20.0, pid: int | None = None
) -> bool:
    """True once the port accepts connections; False on timeout or if
    the process died first."""
    deadline = time.monotonic() + timeout
    probe_host = "127.0.0.1" if host in ("0.0.0.0", "") else host
    while time.monotonic() < deadline:
        if pid is not None and not pid_alive(pid):
            return False
        try:
            with socket.create_connection((probe_host, port), timeout=1.0):
                return True
        except OSError:
            time.sleep(0.2)
    return False


def stop_daemon(name: str, grace_s: float = 10.0) -> str:
    """SIGTERM the daemon's process group, escalate to SIGKILL after
    ``grace_s``; removes the pidfile. Returns a human-readable outcome."""
    pid = read_pid(name)
    if pid is None:
        return "not running"
    if not pid_alive(pid):
        os.unlink(pidfile(name))
        return "stale pidfile removed"
    target = -pid  # process group (start_new_session=True at spawn)
    try:
        os.killpg(pid, signal.SIGTERM)
    except OSError:
        target = pid
        try:
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if not pid_alive(pid):
            break
        time.sleep(0.2)
    else:
        try:
            if target == -pid:
                os.killpg(pid, signal.SIGKILL)
            else:
                os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    try:
        os.unlink(pidfile(name))
    except OSError:
        pass
    return f"stopped (pid {pid})"


def start_all(
    ip: str = "0.0.0.0",
    ports: dict[str, int] | None = None,
    with_minipg: bool = False,
    with_storeserver: bool = False,
    storeserver_access_key: str = "",
    out=print,
) -> int:
    """Bring up every service; refuses to double-start (the reference
    aborts when jps shows Elasticsearch already up). Returns exit code."""
    ports = ports or {}
    failures = 0
    names = list(SERVICES)
    if with_storeserver:
        names.insert(0, "storeserver")
    if with_minipg:
        names.insert(0, "minipg")
    # optional services share their verb name and take only --ip/--port
    for name in names:
        state, pid = service_status(name)
        if state == "running":
            out(
                f"{name}: already running (pid {pid}). Use stop-all "
                "first if you want a restart."
            )
            continue
        if state == "stale-pidfile":
            out(f"{name}: removing stale pidfile (pid {pid} is gone)")
            os.unlink(pidfile(name))
        env = None
        if name in OPTIONAL_SERVICES:
            port = ports.get(name, OPTIONAL_SERVICES[name])
            argv = [name, "--ip", ip, "--port", str(port)]
            if name == "storeserver" and storeserver_access_key:
                # via the environment, not argv — a secret on the
                # command line is readable by every local user in ps
                env = {
                    "PIO_SERVER_ACCESS_KEY": storeserver_access_key,
                    "PIO_SERVER_KEY_AUTH_ENFORCED": "true",
                }
        else:
            verb, default_port, extra = SERVICES[name]
            port = ports.get(name, default_port)
            argv = [verb, "--ip", ip, "--port", str(port), *extra]
        pid = spawn_daemon(name, argv, env=env)
        if wait_port(ip, port, pid=pid):
            out(f"{name}: started (pid {pid}, port {port}, "
                f"log {logfile(name)})")
        else:
            failures += 1
            out(
                f"{name}: FAILED to come up on port {port} — see "
                f"{logfile(name)}"
            )
            stop_daemon(name)
    return 1 if failures else 0


def stop_all(out=print) -> int:
    names = list(SERVICES) + list(OPTIONAL_SERVICES)
    for name in names:
        out(f"{name}: {stop_daemon(name)}")
    return 0


def status_all(out=print) -> int:
    """One line per service; exit 0 iff everything is running."""
    all_up = True
    names = list(SERVICES) + list(OPTIONAL_SERVICES)
    for name in names:
        state, pid = service_status(name)
        if state == "stopped" and name in OPTIONAL_SERVICES:
            continue  # optional service: shown only when up or crashed
        suffix = f" (pid {pid})" if pid else ""
        out(f"{name}: {state}{suffix}")
        all_up = all_up and state == "running"
    return 0 if all_up else 1
