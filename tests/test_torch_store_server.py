"""The port's store server and ``httpstore`` client against the JAX
package's.

* Both store servers, each over its own sqlite metadata, event log and
  localfs models, give the same status and body to one seeded script of
  requests: every route (metadata kinds and their filters, the two-part
  manifest key, models with ``GET /models``, events with find filters,
  the watermark, get and delete), the ``X-PIO-Store-Seq`` replay, the
  upload digest check (422, nothing stored), bad requests, and the key;
  once over plain HTTP and once over TLS.
* Each package's ``httpstore`` client drives the other package's server
  through the storage contract: metadata, models (``X-PIO-SHA256`` on
  upload), events, ``list_ids``, and the key over TLS.
* ``create_store_server(peers=...)`` refuses the replicated tier, naming
  ROADMAP.md item 3b.
"""

from __future__ import annotations

import base64
import dataclasses
import datetime as dt
import hashlib
import http.client
import json
import ssl

import numpy as np
import pytest

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.serving.config import ServerConfig as JaxServerConfig
from predictionio_tpu.serving.store_server import (
    create_store_server as jax_create_store_server,
)
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import Storage, StorageError
from predictionio_tpu_torch.serving.config import ServerConfig
from predictionio_tpu_torch.serving.store_server import (
    create_store_server,
    event_set_checksum,
)


def _self_signed_cert(tmp_path):
    """PEM certificate and key for 127.0.0.1 (a subject alternative
    name, which a verifying client checks), made with cryptography."""
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = dt.datetime.now(dt.timezone.utc)
    cert = (
        x509.CertificateBuilder().subject_name(name).issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - dt.timedelta(days=1))
        .not_valid_after(now + dt.timedelta(days=2))
        .add_extension(x509.SubjectAlternativeName([
            x509.DNSName("localhost"),
            x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
            critical=False)
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .sign(key, hashes.SHA256())
    )
    cert_path, key_path = tmp_path / "cert.pem", tmp_path / "key.pem"
    cert_path.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    key_path.write_bytes(key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption()))
    return str(cert_path), str(key_path)

KEY = "store-key"
T0 = dt.datetime(2024, 5, 1, 8, 0, 0, tzinfo=dt.timezone.utc)


def _own_env(base) -> dict:
    """A store server's own storage: sqlite metadata, the event log,
    localfs models."""
    env = {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(base / "pio.sqlite"),
        "PIO_STORAGE_SOURCES_LOG_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_LOG_PATH": str(base / "eventlog"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(base / "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "LOG",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }
    return env


PKGS = {
    "jax": (jax_create_store_server, JaxStorage, JaxServerConfig),
    "port": (create_store_server, Storage, ServerConfig),
}


def _start(pkg, base, key="", tls=None):
    create, storage_cls, config_cls = PKGS[pkg]
    base.mkdir(parents=True)
    config = config_cls(key_auth_enforced=bool(key), access_key=key)
    if tls is not None:
        config = dataclasses.replace(config, ssl_enabled=True,
                                     ssl_certfile=tls[0], ssl_keyfile=tls[1])
    server = create(host="127.0.0.1", port=0,
                    storage=storage_cls(env=_own_env(base)),
                    server_config=config)
    server.start()
    return server


def _script(seed: int) -> list:
    """(method, path, body, headers) of the seeded script."""
    rng = np.random.default_rng(seed)
    blob = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    digest = hashlib.sha256(blob).hexdigest()
    flipped = bytearray(blob)
    flipped[17] ^= 0x01
    events = []
    for i in range(12):
        events.append({
            "eventId": f"ev{i:02d}", "event": ["rate", "view"][i % 2],
            "entityType": "user", "entityId": f"u{int(rng.integers(4))}",
            "targetEntityType": "item",
            "targetEntityId": f"i{int(rng.integers(6))}",
            "properties": {"rating": int(rng.integers(1, 6))},
            "eventTime": (T0 + dt.timedelta(seconds=i)).isoformat(),
            "creationTime": (T0 + dt.timedelta(seconds=100 + i)).isoformat(),
        })
    ts = T0.isoformat()
    inst = {"id": "inst1", "status": "COMPLETED", "start_time": ts,
            "end_time": ts, "engine_id": "e", "engine_version": "1",
            "engine_variant": "v", "engine_factory": "f", "env": {"a": "b"}}
    octet = {"Content-Type": "application/octet-stream"}
    seq = {"X-PIO-Store-Seq": "writer-a:1"}
    return [
        ("GET", "/", None, {}),
        ("POST", "/meta/apps", {"id": 0, "name": "shop",
                                "description": "d"}, {}),
        ("POST", "/meta/apps", {"id": 0, "name": "shop"}, {}),
        ("POST", "/meta/apps", {"name": "no id"}, {}),
        ("GET", "/meta/apps", None, {}),
        ("GET", "/meta/apps?name=shop", None, {}),
        ("GET", "/meta/apps/1", None, {}),
        ("GET", "/meta/apps/99", None, {}),
        ("GET", "/meta/apps/x", None, {}),
        ("PUT", "/meta/apps/1", {"id": 1, "name": "shop",
                                 "description": "new"}, {}),
        ("POST", "/meta/access_keys", {"key": "k1", "appid": 1,
                                       "events": ["rate"]}, {}),
        ("GET", "/meta/access_keys?app_id=1", None, {}),
        ("GET", "/meta/access_keys?app_id=x", None, {}),
        ("DELETE", "/meta/access_keys/k1", None, {}),
        ("DELETE", "/meta/access_keys/k1", None, {}),
        ("POST", "/meta/channels", {"id": 0, "name": "side", "appid": 1},
         {}),
        ("GET", "/meta/channels?app_id=1", None, {}),
        ("POST", "/meta/engine_instances", inst, {}),
        ("GET", "/meta/engine_instances?completed=1&engine_id=e&"
                "engine_version=1&engine_variant=v&latest=1", None, {}),
        ("PUT", "/meta/engine_instances/inst1", dict(inst, status="FAILED"),
         {}),
        ("GET", "/meta/engine_instances/inst1", None, {}),
        ("POST", "/meta/evaluation_instances", {
            "id": "ev1", "status": "EVALCOMPLETED", "start_time": ts,
            "end_time": ts}, {}),
        ("GET", "/meta/evaluation_instances?completed=1", None, {}),
        ("POST", "/meta/engine_manifests", {
            "id": "m", "version": "1", "name": "rec", "files": ["a.py"],
            "engine_factory": "f"}, {}),
        ("GET", "/meta/engine_manifests/m/1", None, {}),
        ("GET", "/meta/engine_manifests/m", None, {}),
        ("DELETE", "/meta/engine_manifests/m/1", None, {}),
        ("GET", "/meta/bogus", None, {}),
        ("PUT", "/models/gen%2F1", blob, dict(octet, **{
            "X-PIO-SHA256": digest})),
        ("PUT", "/models/flipped", bytes(flipped), dict(octet, **{
            "X-PIO-SHA256": digest})),
        ("GET", "/models/flipped", None, {}),
        ("GET", "/models/gen%2F1", None, {}),
        ("GET", "/models", None, {}),
        ("DELETE", "/models/gen%2F1", None, {}),
        ("GET", "/models/gen%2F1", None, {}),
        ("PUT", "/events/1", None, {}),
        ("POST", "/events/1", events[0], seq),
        ("POST", "/events/1", events[0], seq),
        ("POST", "/events/1", events[1], {"X-PIO-Store-Seq": "writer-a:2"}),
        ("POST", "/events/1", {"event": "rate"}, {}),
        ("POST", "/events/1/batch", events[2:10], {}),
        ("POST", "/events/1/batch", events[10:], {
            "X-PIO-Store-Seq": "writer-b:1"}),
        ("POST", "/events/1/batch", events[10:], {
            "X-PIO-Store-Seq": "writer-b:1"}),
        ("GET", "/events/1", None, {}),
        ("GET", "/events/1?entity_type=user&entity_id=u1&limit=3", None,
         {}),
        ("GET", "/events/1?event_names=%5B%22view%22%5D&reversed=1", None,
         {}),
        ("GET", "/events/1?target_entity_type=__null__", None, {}),
        ("GET", "/events/1?start_time=" + (T0 + dt.timedelta(seconds=3))
         .isoformat().replace("+", "%2B"), None, {}),
        ("GET", "/events/1?limit=x", None, {}),
        ("GET", "/events/1/watermark", None, {}),
        ("GET", "/events/1/one/ev03", None, {}),
        ("DELETE", "/events/1/one/ev03", None, {}),
        ("GET", "/events/1/one/ev03", None, {}),
        ("GET", "/events/1/watermark", None, {}),
        ("DELETE", "/events/1", None, {}),
        ("GET", "/events/1", None, {}),
    ]


def _drive(port: int, script, key: str = "", tls=None) -> list:
    if tls is None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    else:
        conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=30,
                                           context=tls)
    out = []
    try:
        for method, path, body, headers in script:
            headers = dict(headers)
            if key:
                headers["Authorization"] = f"Bearer {key}"
            if isinstance(body, (dict, list)):
                body = json.dumps(body).encode()
                headers.setdefault("Content-Type", "application/json")
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            try:
                payload = json.loads(raw)
            except ValueError:
                payload = base64.b64encode(raw).decode()
            if isinstance(payload, dict):
                # each server names its own process and mints its own
                # request ids
                payload.pop("pid", None)
                payload.pop("requestId", None)
            out.append((method, path, resp.status, payload))
    finally:
        conn.close()
    return out


@pytest.mark.parametrize("transport", ["http", "tls_key"])
def test_both_servers_answer_the_seeded_script_alike(tmp_path, transport):
    tls_files = client_ctx = None
    key = ""
    if transport == "tls_key":
        tls_files = _self_signed_cert(tmp_path)
        client_ctx = ssl.create_default_context(cafile=tls_files[0])
        key = KEY
    got = {}
    for pkg in PKGS:
        server = _start(pkg, tmp_path / pkg, key=key, tls=tls_files)
        try:
            got[pkg] = _drive(server.port, _script(5), key=key,
                              tls=client_ctx)
            if key:
                keyless = _drive(server.port, _script(5)[:2], tls=client_ctx)
                got[pkg].append(keyless)
        finally:
            server.shutdown()
    for g, w in zip(got["port"], got["jax"]):
        assert g == w
    assert len(got["port"]) == len(got["jax"])
    statuses = [s for _m, _p, s, _b in got["port"][:len(_script(5))]]
    assert 422 in statuses and 404 in statuses and 400 in statuses
    if key:
        assert [s for _m, _p, s, _b in got["port"][-1]] == [401, 401]


def test_the_watermark_checksum_is_the_jax_packages():
    from predictionio_tpu.serving.store_server import (
        event_set_checksum as jax_checksum,
    )

    ids = [f"ev{i}" for i in range(50)]
    assert event_set_checksum(ids) == jax_checksum(ids)
    assert event_set_checksum(reversed(ids)) == event_set_checksum(ids)


# -- each client against the other package's server -----------------------------


def _client_env(port: int, tls_files) -> dict:
    env = {
        "PIO_STORAGE_SOURCES_STORE_TYPE": "httpstore",
        "PIO_STORAGE_SOURCES_STORE_URL": f"https://127.0.0.1:{port}",
        "PIO_STORAGE_SOURCES_STORE_KEY": KEY,
        "PIO_STORAGE_SOURCES_STORE_CACERT": tls_files[0],
    }
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "STORE"
    return env


def _contract(storage, event_cls, app_cls, model_cls) -> list:
    out = []
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "shop", "d"))
    out.append(dataclasses.asdict(storage.get_meta_data_apps().get(app_id)))
    events = storage.get_events()
    events.init(app_id)
    made = [event_cls(event="rate", entity_type="user", entity_id=f"u{i % 3}",
                      target_entity_type="item", target_entity_id=f"i{i}",
                      properties={"rating": i}, event_id=f"e{i}",
                      event_time=T0 + dt.timedelta(seconds=i),
                      creation_time=T0)
            for i in range(7)]
    events.insert(made[0], app_id)
    out.append(events.insert_batch(made[1:], app_id))
    out.append([e.to_json_dict() for e in events.find(
        app_id, entity_id="u1", limit=2, reversed=True)])
    out.append(events.delete("e3", app_id))
    out.append(events.get("e3", app_id))
    models = storage.get_model_data_models()
    models.insert(model_cls("g1", b"\x00\x01blob"))
    models.insert(model_cls("g1.manifest", b"{}"))
    out.append(models.get("g1").models)
    out.append(models.list_ids())
    out.append(models.delete("g1"))
    out.append(models.list_ids())
    return out


@pytest.mark.parametrize("client_pkg, server_pkg", [("port", "jax"),
                                                    ("jax", "port")])
def test_each_client_against_the_other_server(tmp_path, client_pkg,
                                              server_pkg):
    from predictionio_tpu.data.storage import App as JaxApp
    from predictionio_tpu.data.storage import Model as JaxModel
    from predictionio_tpu_torch.data.storage import App, Model

    tls_files = _self_signed_cert(tmp_path)
    got = {}
    for pkg in (server_pkg, client_pkg):
        server = _start(pkg, tmp_path / f"{pkg}-server", key=KEY,
                        tls=tls_files)
        try:
            client = (Storage, Event, App, Model) if client_pkg == "port" \
                else (JaxStorage, JaxEvent, JaxApp, JaxModel)
            storage = client[0](env=_client_env(server.port, tls_files))
            got[pkg] = _contract(storage, *client[1:])
        finally:
            server.shutdown()
    # the other package's server answers this client as its own does
    assert got[server_pkg] == got[client_pkg]
    assert got[server_pkg][-1] == ["g1.manifest"]


def test_peers_are_refused_naming_the_item(tmp_path):
    with pytest.raises(StorageError, match="item 3b"):
        create_store_server(host="127.0.0.1", port=0,
                            storage=Storage(env=_own_env(tmp_path)),
                            peers=["http://127.0.0.1:1"])
