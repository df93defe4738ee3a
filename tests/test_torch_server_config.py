"""Key auth and TLS: the port's ``ServerConfig`` and servers against the
JAX package's, on the CPU.

* ``check_key`` reads the server key from ``X-PIO-Server-Key``, then
  ``Authorization: Bearer``, then the ``accessKey`` query param, and
  compares with ``hmac.compare_digest``: every case answers as the JAX
  package's does (401 or through); ``ssl_context`` gives TLS 1.2 or
  later and refuses missing certificate paths alike;
* the engine, event, dashboard and admin servers serve HTTPS under a
  ``ServerConfig`` with TLS (a self-signed certificate made here with
  ``cryptography``, as JAX ``tests/test_server_config.py:100-135``
  makes it; nothing is downloaded), with the same statuses as the JAX
  package's servers for the same requests: the dashboard and admin
  server ask the key of every route, the engine server of its admin and
  ``/debug`` routes only, the event server of its ``/debug`` routes
  only; a client that stalls its handshake holds no other connection;
* ``undeploy_existing`` over TLS with the key stops an engine server of
  either package, and so does the JAX package's against the port's.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import json
import socket
import ssl
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.core.persistence import (
    publish_generation as jax_publish,
    serialize_models as jax_serialize,
)
from predictionio_tpu.data.storage import (
    EngineInstance as JaxInstance,
    Storage as JaxStorage,
)
from predictionio_tpu.models.recommendation import (
    ALSAlgorithm as JaxALS,
    ALSRecModel as JaxModel,
    recommendation_engine as jax_engine,
)
from predictionio_tpu.serving import admin as jax_admin
from predictionio_tpu.serving import dashboard as jax_dashboard
from predictionio_tpu.serving import event_server as jax_event_server
from predictionio_tpu.serving.config import ServerConfig as JaxConfig
from predictionio_tpu.serving.engine_server import (
    EngineServer as JaxServer,
    undeploy_existing as jax_undeploy,
)
from predictionio_tpu.serving.http import HTTPError as JaxHTTPError
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.models.recommendation import recommendation_engine
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving import admin, dashboard, event_server
from predictionio_tpu_torch.serving.config import ServerConfig
from predictionio_tpu_torch.serving.engine_server import (
    EngineServer,
    undeploy_existing,
)
from predictionio_tpu_torch.serving.http import HTTPError

KEY = "sekrit"
VARIANT = {"algorithms": [{"name": "als", "params": {"rank": 4}}]}


class _Req:
    def __init__(self, headers=None, query=None):
        self.headers = headers or {}
        self.query = query or {}


_KEY_CASES = [
    ({}, {}),
    ({"X-PIO-Server-Key": KEY}, {}),
    ({"X-PIO-Server-Key": "wrong"}, {"accessKey": KEY}),
    ({"Authorization": f"Bearer {KEY}"}, {}),
    ({"Authorization": f"Bearer  {KEY} "}, {}),
    ({"Authorization": f"Basic {KEY}"}, {}),
    ({"Authorization": "Bearer nope"}, {"accessKey": KEY}),
    ({}, {"accessKey": KEY}),
    ({}, {"accessKey": "alice"}),
    ({"X-PIO-Server-Key": "sékrit"}, {}),
]


@pytest.mark.parametrize("enforced, key", [
    (True, KEY), (False, KEY), (True, ""), (True, "sékrit")])
@pytest.mark.parametrize("headers, query", _KEY_CASES)
def test_check_key_answers_like_jax(enforced, key, headers, query):
    outcomes = []
    for config, error in ((JaxConfig(enforced, key), JaxHTTPError),
                          (ServerConfig(enforced, key), HTTPError)):
        try:
            config.check_key(_Req(dict(headers), dict(query)))
            outcomes.append(None)
        except error as e:
            outcomes.append((e.status, e.message))
    assert outcomes[1] == outcomes[0]


def _self_signed_cert(tmp_path):
    """PEM certificate and key for localhost, made with cryptography."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + dt.timedelta(days=36500))
        .add_extension(
            x509.SubjectAlternativeName([x509.DNSName("localhost")]),
            critical=False,
        )
        .sign(key, hashes.SHA256())
    )
    certfile = tmp_path / "cert.pem"
    keyfile = tmp_path / "key.pem"
    certfile.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    keyfile.write_bytes(key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    ))
    return str(certfile), str(keyfile)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return _self_signed_cert(tmp_path_factory.mktemp("tls"))


def _configs(certs, enforced=True):
    certfile, keyfile = certs
    kw = dict(key_auth_enforced=enforced, access_key=KEY, ssl_enabled=True,
              ssl_certfile=certfile, ssl_keyfile=keyfile)
    return JaxConfig(**kw), ServerConfig(**kw)


def test_ssl_context_like_jax(certs, tmp_path):
    for cls in (JaxConfig, ServerConfig):
        assert cls().ssl_context() is None
        with pytest.raises(ValueError, match="ssl_certfile"):
            cls(ssl_enabled=True).ssl_context()
    jax_cfg, cfg = _configs(certs)
    got, want = cfg.ssl_context(), jax_cfg.ssl_context()
    assert got.minimum_version == want.minimum_version == (
        ssl.TLSVersion.TLSv1_2)
    assert isinstance(got, ssl.SSLContext)


def _client_ctx():
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def _call(url, method="GET", body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    ctx = _client_ctx() if url.startswith("https") else None
    try:
        with urllib.request.urlopen(req, timeout=30, context=ctx) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _env(root):
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(root / "pio.sqlite"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(root / "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """One JAX-published random ALS generation (20 users, 30 items,
    rank 4) in a sqlite + localfs store both packages read."""
    root = tmp_path_factory.mktemp("tls-store")
    env = _env(root)
    storage = JaxStorage(env=env)
    rng = np.random.default_rng(3)
    model = JaxModel(
        user_factors=rng.standard_normal((20, 4)).astype(np.float32),
        item_factors=rng.standard_normal((30, 4)).astype(np.float32),
        user_map=JaxBiMap([f"u{i}" for i in range(20)]),
        item_map=JaxBiMap([f"i{i}" for i in range(30)]),
    )
    now = dt.datetime.now(dt.timezone.utc)
    instances = storage.get_meta_data_engine_instances()
    iid = instances.insert(JaxInstance(
        id="", status="INIT", start_time=now, end_time=now,
        engine_id="rec", engine_version="1", engine_variant="default",
        engine_factory="recommendation"))
    jax_publish(storage.get_model_data_models(), iid,
                jax_serialize(iid, [JaxALS()], [model]))
    instances.update(dataclasses.replace(instances.get(iid),
                                         status="COMPLETED"))
    return env, storage


def _engine_server(pkg, store, config):
    env, jax_storage = store
    if pkg == "jax":
        engine = jax_engine()
        return JaxServer(engine, engine.params_from_variant(VARIANT), "rec",
                         storage=jax_storage, server_config=config,
                         max_batch=4, warmup=False)
    engine = recommendation_engine()
    return EngineServer(engine, engine.params_from_variant(VARIANT), "rec",
                        storage=Storage(env=env), server_config=config,
                        ctx=ComputeContext.create(device="cpu"),
                        max_batch=4, warmup=False)


def _http_of(pkg, kind, store, config):
    """(start-able HTTPServer, close) of one package's ``kind`` server
    on a free port under ``config``."""
    env, jax_storage = store
    port_storage = Storage(env=env)
    if kind == "engine":
        server = _engine_server(pkg, store, config)
        return server.serve(host="127.0.0.1", port=0), server.close
    if kind == "event":
        mod = jax_event_server if pkg == "jax" else event_server
        return mod.create_event_server(
            host="127.0.0.1", port=0, server_config=config,
            storage=jax_storage if pkg == "jax" else port_storage,
        ), lambda: None
    if kind == "dashboard":
        mod = jax_dashboard if pkg == "jax" else dashboard
        return mod.create_dashboard(
            host="127.0.0.1", port=0, server_config=config,
            storage=jax_storage if pkg == "jax" else port_storage,
        ), lambda: None
    mod = jax_admin if pkg == "jax" else admin
    return mod.create_admin_server(
        host="127.0.0.1", port=0, server_config=config,
        storage=jax_storage if pkg == "jax" else port_storage,
    ), lambda: None


_PROBES = {
    "engine": [("GET", "/", None, {}),
               ("POST", "/queries.json", {"user": "u3", "num": 4}, {}),
               ("POST", "/reload", {}, {}),
               ("POST", "/reload?accessKey=wrong", {}, {}),
               ("POST", "/reload", {}, {"X-PIO-Server-Key": KEY}),
               ("GET", "/debug/traces.json", None, {}),
               ("GET", "/debug/timeline.json", None,
                {"Authorization": f"Bearer {KEY}"}),
               ("GET", "/metrics.json", None, {}),
               ("POST", "/debug/profile", {"durationMs": "x"}, {}),
               ("POST", "/stop", None, {})],
    "event": [("GET", "/", None, {}),
              ("GET", "/debug/traces.json", None, {}),
              ("GET", f"/debug/traces.json?accessKey={KEY}", None, {}),
              ("GET", "/events.json?accessKey=nope", None, {})],
    "dashboard": [("GET", "/", None, {}),
                  ("GET", f"/?accessKey={KEY}", None, {}),
                  ("GET", "/engine_instances/x", None,
                   {"X-PIO-Server-Key": KEY}),
                  ("GET", "/metrics.json", None, {})],
    "admin": [("GET", "/", None, {}),
              ("GET", "/", None, {"X-PIO-Server-Key": KEY}),
              ("GET", "/cmd/app", None, {"X-PIO-Server-Key": KEY})],
}


@pytest.mark.parametrize("kind", sorted(_PROBES))
def test_https_and_key_like_jax(certs, store, kind):
    configs = dict(zip(("jax", "torch"), _configs(certs)))
    statuses = {}
    for pkg, config in configs.items():
        http, close = _http_of(pkg, kind, store, config)
        http.start()
        try:
            base = f"https://127.0.0.1:{http.port}"
            statuses[pkg] = [_call(base + path, method, body, headers)[0]
                             for method, path, body, headers in _PROBES[kind]]
            # plain HTTP to a TLS listener gets no answer
            with pytest.raises((urllib.error.URLError, ConnectionError,
                                OSError)):
                urllib.request.urlopen(f"http://127.0.0.1:{http.port}/",
                                       timeout=5)
        finally:
            http.shutdown()
            close()
    assert statuses["torch"] == statuses["jax"]
    assert 401 in statuses["torch"] and 200 in statuses["torch"]


def test_stalled_handshake_holds_no_other_connection(certs, store):
    _, config = _configs(certs, enforced=False)
    http, close = _http_of("torch", "dashboard", store, config)
    http.start()
    stalled = socket.create_connection(("127.0.0.1", http.port))
    try:
        t0 = time.monotonic()
        status, _ = _call(f"https://127.0.0.1:{http.port}/")
        assert status == 200
        assert time.monotonic() - t0 < 5
    finally:
        stalled.close()
        http.shutdown()
        close()


@pytest.mark.parametrize("server_pkg, caller", [
    ("torch", "torch"), ("jax", "torch"), ("torch", "jax")])
def test_undeploy_over_tls_with_the_key(certs, store, server_pkg, caller):
    configs = dict(zip(("jax", "torch"), _configs(certs)))
    server = _engine_server(server_pkg, store, configs[server_pkg])
    http = server.serve(host="127.0.0.1", port=0)
    http.start()
    port = http.port
    try:
        base = f"https://127.0.0.1:{port}"
        assert _call(base + "/stop", "POST")[0] == 401
        undeploy = undeploy_existing if caller == "torch" else jax_undeploy
        # without TLS the handshake reaches nothing
        assert undeploy("127.0.0.1", port, None) is False
        assert undeploy("127.0.0.1", port, configs[caller]) is True
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                socket.create_connection(("127.0.0.1", port), 0.2).close()
                time.sleep(0.05)
            except OSError:
                break
        else:
            raise AssertionError("the TLS server still listens")
    finally:
        http.shutdown()
        server.close()
