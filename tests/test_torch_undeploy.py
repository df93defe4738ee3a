"""Undeploy: ``POST /stop``, the undeploy-before-deploy handshake, and a
deploy process that exits after it; ``ServerConfig`` read and refused.

* ``POST /stop`` answers ``{"message": "stopping"}``, shuts the
  listener from a thread of its own and closes the batchers;
* ``serve`` on a taken port stops the engine server there first (the
  port's or the JAX package's: ``undeploy_existing`` is one handshake)
  and binds; with nothing there it binds straight away;
* ``python -m predictionio_tpu_torch.cli.main deploy --device cpu`` in
  a child process answers queries, and exits 0 after ``undeploy`` and
  after SIGTERM; a second ``deploy`` on the same port ends the first;
* ``deploy --canary`` (and ``--no-admission --no-adaptive-wait``) runs,
  and SIGTERM drains it: the requests in flight (``PIO_CHAOS`` holds
  each one 400 ms) all end 200, a new one gets 503 with
  ``Retry-After``, and the child exits 0; ``eventserver --no-admission``
  serves without the admission families and drains on SIGTERM too;
* ``ServerConfig.from_env`` reads what the JAX package reads (env over
  ``$PIO_CONF_DIR/server.json``) and builds its SSL context alike, and
  every verb that binds an HTTP server takes the environment's key auth
  and TLS as the JAX console's does: ``deploy`` serves HTTPS and asks
  the key of ``/reload`` and ``/debug``, ``eventserver`` of ``/debug``,
  ``dashboard`` of every route, ``trainer --metrics-port`` of its
  ``/debug`` routes, ``adminserver`` (like the reference AdminAPI)
  reads neither, and ``undeploy`` stops a TLS server with the key.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.serving.config import ServerConfig as JaxServerConfig
from predictionio_tpu.serving.engine_server import (
    undeploy_existing as jax_undeploy_existing,
)
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage, set_storage
from predictionio_tpu_torch.models.recommendation import recommendation_engine
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving.config import ServerConfig
from predictionio_tpu_torch.serving.engine_server import (
    EngineServer,
    undeploy_existing,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
VARIANT = {
    "id": "undeploy-rec",
    "engineFactory": "recommendation",
    "datasource": {"params": {"app_name": "shop"}},
    "algorithms": [{"name": "als",
                    "params": {"rank": 4, "num_iterations": 2}}],
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, path: str, body) -> tuple[int, object]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _refused(port: int) -> bool:
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=2):
            return False
    except OSError:
        return True


def _wait(cond, timeout=30.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _train(storage: Storage) -> str:
    rng = np.random.default_rng(3)
    app_id = storage.get_meta_data_apps().insert(App(0, "shop"))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{i}",
              properties={"rating": int(r)})
        for u, i, r in zip(rng.integers(0, 30, 300),
                           rng.integers(0, 20, 300),
                           rng.integers(1, 6, 300))
    ], app_id)
    engine = recommendation_engine()
    set_storage(storage)
    try:
        return run_train(engine, engine.params_from_variant(VARIANT),
                         VARIANT["id"], storage=storage,
                         ctx=ComputeContext.create(device="cpu"))
    finally:
        set_storage(None)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A trained generation under the zero-config wiring (sqlite +
    localfs under ``PIO_FS_BASEDIR``), readable by child processes."""
    base = tmp_path_factory.mktemp("undeploy")
    storage = Storage(env={"PIO_FS_BASEDIR": str(base)})
    _train(storage)
    (base / "engine.json").write_text(json.dumps(VARIANT))
    return base, storage


def _server(storage) -> EngineServer:
    engine = recommendation_engine()
    return EngineServer(
        engine, engine.params_from_variant(VARIANT), VARIANT["id"],
        storage=storage, ctx=ComputeContext.create(device="cpu"),
        max_batch=4, max_wait_ms=1.0)


def test_stop_shuts_the_listener_and_closes_the_batchers(store):
    es = _server(store[1])
    http = es.serve(host="127.0.0.1", port=0)
    http.start()
    port = http.port
    assert _post(port, "/queries.json", {"user": "u1", "num": 3})[0] == 200
    batchers = list(es._batchers)
    assert _post(port, "/stop", {}) == (200, {"message": "stopping"})
    assert _wait(lambda: _refused(port)), "the listener kept serving"
    assert _wait(lambda: all(b._closed for b in batchers))
    es.close()  # after /stop: returns at once


def test_serve_undeploys_the_server_on_its_port(store):
    first = _server(store[1])
    port = _free_port()
    first.serve(host="127.0.0.1", port=port).start()
    old_batchers = list(first._batchers)
    second = _server(store[1])
    try:
        http = second.serve(host="127.0.0.1", port=port)
        http.start()
        assert all(b._closed for b in old_batchers)
        code, body = _post(port, "/queries.json", {"user": "u2", "num": 2})
        assert code == 200 and len(body["itemScores"]) == 2
        assert second._http is http
    finally:
        second.close()
        first.close()


def test_undeploy_existing_across_packages(store):
    """One handshake: the JAX package's ``undeploy_existing`` stops the
    port's server, and the port's reports nothing there afterwards."""
    es = _server(store[1])
    port = _free_port()
    es.serve(host="127.0.0.1", port=port).start()
    try:
        assert jax_undeploy_existing("127.0.0.1", port) is True
        assert _wait(lambda: _refused(port))
        assert undeploy_existing("127.0.0.1", port) is False
    finally:
        es.close()


def _deploy_child(base: pathlib.Path, port: int, name: str,
                  flags=(), extra_env=None):
    env = dict(os.environ, PIO_FS_BASEDIR=str(base), PYTHONPATH=str(ROOT),
               **(extra_env or {}))
    for k in list(env):
        if k.startswith("PIO_STORAGE_"):
            del env[k]
    out = open(base / f"{name}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "deploy",
         "--variant", str(base / "engine.json"), "--device", "cpu",
         "--ip", "127.0.0.1", "--port", str(port), "--max-batch", "4",
         *flags],
        stdout=out, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    out.close()
    return proc, base / f"{name}.log"


def _listening(proc, log: pathlib.Path, port: int) -> None:
    line = f"Engine server is listening on 127.0.0.1:{port}"
    assert _wait(lambda: line in log.read_text() or proc.poll() is not None,
                 timeout=120), log.read_text()[-3000:]
    assert proc.poll() is None, log.read_text()[-3000:]


def test_deploy_child_exits_after_undeploy_and_redeploy(store, capsys):
    base, _ = store
    port = _free_port()
    first, first_log = _deploy_child(base, port, "first")
    second = None
    try:
        _listening(first, first_log, port)
        code, body = _post(port, "/queries.json", {"user": "u3", "num": 4})
        assert code == 200 and len(body["itemScores"]) == 4
        # a second deploy on the port ends the first through /stop
        second, second_log = _deploy_child(base, port, "second")
        assert first.wait(timeout=120) == 0, first_log.read_text()[-3000:]
        _listening(second, second_log, port)
        assert _post(port, "/queries.json", {"user": "u3", "num": 4}) == (
            code, body)
        assert main(["undeploy", "--ip", "127.0.0.1",
                     "--port", str(port)]) == 0
        assert capsys.readouterr().out == (
            f"Undeployed engine server at 127.0.0.1:{port}\n")
        assert second.wait(timeout=60) == 0, second_log.read_text()[-3000:]
        assert main(["undeploy", "--ip", "127.0.0.1",
                     "--port", str(port)]) == 1
        assert "Undeploy failed" in capsys.readouterr().err
    finally:
        for proc in (first, second):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def test_deploy_child_exits_on_sigterm(store):
    base, _ = store
    port = _free_port()
    proc, log = _deploy_child(base, port, "sigterm")
    try:
        _listening(proc, log, port)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
        assert _refused(port)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _request(port, body, path="/queries.json"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers)


@pytest.mark.parametrize("flags", [
    ["--canary"], ["--no-admission", "--no-adaptive-wait"]])
def test_deploy_child_drains_on_sigterm(store, flags):
    import concurrent.futures

    base, _ = store
    port = _free_port()
    proc, log = _deploy_child(
        base, port, "drain-" + flags[0].strip("-"), flags,
        {"PIO_CHAOS": "latency:p=1,ms=400", "PIO_DRAIN_GRACE_S": "20"})
    try:
        _listening(proc, log, port)
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            inflight = [pool.submit(_request, port, {"user": f"u{i}",
                                                     "num": 2})
                        for i in range(4)]
            time.sleep(0.2)
            proc.send_signal(signal.SIGTERM)
            time.sleep(0.05)
            refused = _request(port, {"user": "u1", "num": 2})
            assert [f.result(30)[0] for f in inflight] == [200] * 4
        assert refused[0] == 503 and refused[1]["Retry-After"] == "1"
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
        assert _refused(port)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_eventserver_without_admission_drains_on_sigterm(tmp_path):
    port = _free_port()
    env = dict(os.environ, PIO_FS_BASEDIR=str(tmp_path),
               PYTHONPATH=str(ROOT))
    for k in list(env):
        if k.startswith("PIO_STORAGE_"):
            del env[k]
    out = open(tmp_path / "es.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
         "eventserver", "--ip", "127.0.0.1", "--port", str(port),
         "--no-admission"],
        stdout=out, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    out.close()
    log = tmp_path / "es.log"
    try:
        line = f"Event server is listening on 127.0.0.1:{port}"
        assert _wait(lambda: line in log.read_text()
                     or proc.poll() is not None, 60), log.read_text()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            text = resp.read().decode()
        assert "pio_http_requests_total" in text
        assert "pio_admission_limit" not in text
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


_ENVS = [
    {},
    {"PIO_SERVER_KEY_AUTH_ENFORCED": "true", "PIO_SERVER_ACCESS_KEY": "k"},
    {"PIO_SERVER_SSL_ENABLED": "yes", "PIO_SERVER_SSL_CERTFILE": "c.pem",
     "PIO_SERVER_SSL_KEYFILE": "k.pem", "PIO_SERVER_SSL_KEY_PASSWORD": "p"},
    {"PIO_SERVER_KEY_AUTH_ENFORCED": "0", "PIO_SERVER_SSL_ENABLED": "off"},
]


@pytest.mark.parametrize("env", _ENVS)
@pytest.mark.parametrize("via_file", [False, True])
def test_server_config_reads_what_the_jax_package_reads(tmp_path, env,
                                                        via_file):
    if via_file:
        keys = {"PIO_SERVER_KEY_AUTH_ENFORCED": "key_auth_enforced",
                "PIO_SERVER_ACCESS_KEY": "access_key",
                "PIO_SERVER_SSL_ENABLED": "ssl_enabled",
                "PIO_SERVER_SSL_CERTFILE": "ssl_certfile",
                "PIO_SERVER_SSL_KEYFILE": "ssl_keyfile",
                "PIO_SERVER_SSL_KEY_PASSWORD": "ssl_key_password"}
        (tmp_path / "server.json").write_text(
            json.dumps({keys[k]: v for k, v in env.items()}))
        env = {"PIO_CONF_DIR": str(tmp_path)}
    got = ServerConfig.from_env(env)
    want = JaxServerConfig.from_env(env)
    assert [getattr(got, f) for f in got.__dataclass_fields__] == [
        getattr(want, f) for f in got.__dataclass_fields__]
    outcomes = []
    for config in (want, got):
        try:
            outcomes.append(config.ssl_context())
        except (OSError, ValueError) as e:
            outcomes.append(type(e))
    assert outcomes[1] == outcomes[0]  # None, or the same refusal


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    from test_torch_server_config import _self_signed_cert

    return _self_signed_cert(tmp_path_factory.mktemp("certs"))


def _guard(certs, tls: bool) -> dict:
    env = {"PIO_SERVER_KEY_AUTH_ENFORCED": "true",
           "PIO_SERVER_ACCESS_KEY": "k"}
    if tls:
        env.update(PIO_SERVER_SSL_ENABLED="true",
                   PIO_SERVER_SSL_CERTFILE=certs[0],
                   PIO_SERVER_SSL_KEYFILE=certs[1])
    return env


def _probe(port: int, tls: bool, method: str, path: str, key: bool):
    import ssl

    ctx = None
    if tls:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    req = urllib.request.Request(
        f"{'https' if tls else 'http'}://127.0.0.1:{port}{path}",
        data=b"{}" if method == "POST" else None, method=method,
        headers={"X-PIO-Server-Key": "k"} if key else {})
    try:
        with urllib.request.urlopen(req, timeout=30, context=ctx) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


#: verb → (argv, [(method, path, with the key)], the statuses, TLS applies)
_BINDING = {
    "deploy": (["deploy", "--variant", "{base}/engine.json", "--device",
                "cpu", "--ip", "127.0.0.1", "--port", "0"],
               [("GET", "/", False), ("POST", "/reload", False),
                ("POST", "/reload", True), ("GET", "/debug/traces", False),
                ("GET", "/debug/traces", True)],
               [200, 401, 200, 401, 200], True),
    "eventserver": (["eventserver", "--ip", "127.0.0.1", "--port", "0"],
                    [("GET", "/", False), ("GET", "/debug/traces.json",
                                           False),
                     ("GET", "/debug/traces.json", True)],
                    [200, 401, 200], True),
    "dashboard": (["dashboard", "--ip", "127.0.0.1", "--port", "0"],
                  [("GET", "/", False), ("GET", "/", True)],
                  [401, 200], True),
    "adminserver": (["adminserver", "--ip", "127.0.0.1", "--port", "0"],
                    [("GET", "/", False)], [200], False),
}


@pytest.mark.parametrize("tls", [False, True], ids=["key", "tls+key"])
@pytest.mark.parametrize("verb", sorted(_BINDING))
def test_binding_verbs_take_key_auth_and_tls(monkeypatch, capsys, store,
                                             certs, verb, tls):
    import predictionio_tpu_torch.cli.main as cli

    base, storage = store
    for k, v in _guard(certs, tls).items():
        monkeypatch.setenv(k, v)
    argv, probes, want, tls_applies = _BINDING[verb]
    seen = []

    def probe(http):
        http.start()
        try:
            seen.extend(_probe(http.port, tls and tls_applies, *p)
                        for p in probes)
        finally:
            http.shutdown()
        return 0

    monkeypatch.setattr(cli, "_serve_foreground", probe)
    set_storage(storage)
    try:
        assert main([a.format(base=base) for a in argv]) == 0
    finally:
        set_storage(None)
    assert seen == want
    assert "is listening on 127.0.0.1:" in capsys.readouterr().out


@pytest.mark.parametrize("tls", [False, True], ids=["key", "tls+key"])
def test_trainer_metrics_port_takes_the_key(monkeypatch, store, certs, tls):
    """``trainer --metrics-port``: the key guards its ``/debug`` routes
    (its listener, as in the JAX console, stays plain HTTP)."""
    import predictionio_tpu_torch.training as training

    base, storage = store
    for k, v in _guard(certs, tls).items():
        monkeypatch.setenv(k, v)
    port = _free_port()
    seen = []

    class _Trainer:
        def __init__(self, *a, **kw):
            pass

        def poll_once(self):
            seen.extend(_probe(port, False, "GET", path, key)
                        for path, key in (("/metrics.json", False),
                                          ("/debug/traces.json", False),
                                          ("/debug/traces.json", True)))
            return "noop"

    monkeypatch.setattr(training, "ContinuousTrainer", _Trainer)
    set_storage(storage)
    try:
        assert main(["trainer", "--app", "shop", "--variant",
                     str(base / "engine.json"), "--metrics-port", str(port),
                     "--once", "--device", "cpu", "--checkpoint-dir",
                     str(base / f"trainer-{tls}")]) == 0
    finally:
        set_storage(None)
    assert seen == [200, 401, 200]


def test_undeploy_stops_a_tls_server_with_the_key(monkeypatch, capsys,
                                                  store, certs):
    for k, v in _guard(certs, True).items():
        monkeypatch.setenv(k, v)
    es = _server(store[1])  # the environment's ServerConfig
    port = _free_port()
    es.serve(host="127.0.0.1", port=port).start()
    try:
        assert _probe(port, True, "POST", "/stop", False) == 401
        assert main(["undeploy", "--ip", "127.0.0.1",
                     "--port", str(port)]) == 0
        assert capsys.readouterr().out == (
            f"Undeployed engine server at 127.0.0.1:{port}\n")
        assert _wait(lambda: _refused(port))
    finally:
        es.close()
