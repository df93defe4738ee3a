"""Server security configuration: access-key auth and TLS.

Counterpart of ``ServerConfig`` in ``predictionio_tpu/serving/config.py``
(reference ``KeyAuthentication.scala:30-58`` and
``SSLConfiguration.scala``), with the same settings read the same way:
env vars win, then an optional JSON file ``$PIO_CONF_DIR/server.json``,
then the defaults (auth off, TLS off). Certificates are PEM files loaded
through :mod:`ssl`.

Env vars / server.json keys::

    PIO_SERVER_KEY_AUTH_ENFORCED   "key_auth_enforced": bool
    PIO_SERVER_ACCESS_KEY          "access_key": str
    PIO_SERVER_SSL_ENABLED         "ssl_enabled": bool
    PIO_SERVER_SSL_CERTFILE        "ssl_certfile": PEM cert chain path
    PIO_SERVER_SSL_KEYFILE         "ssl_keyfile": PEM private key path
    PIO_SERVER_SSL_KEY_PASSWORD    "ssl_key_password": key password
"""

from __future__ import annotations

import dataclasses
import hmac
import json
import os
import ssl
from typing import Mapping

from predictionio_tpu_torch.serving.http import HTTPError, Request

_TRUE = {"1", "true", "yes", "on"}


def _as_bool(value: object) -> bool:
    if isinstance(value, bool):
        return value
    return str(value).strip().lower() in _TRUE


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Security settings for one HTTP server."""

    key_auth_enforced: bool = False
    access_key: str = ""
    ssl_enabled: bool = False
    ssl_certfile: str = ""
    ssl_keyfile: str = ""
    ssl_key_password: str = ""

    @staticmethod
    def from_env(env: Mapping[str, str] | None = None) -> "ServerConfig":
        env = dict(env if env is not None else os.environ)
        conf: dict = {}
        conf_dir = env.get("PIO_CONF_DIR")
        if conf_dir:
            path = os.path.join(conf_dir, "server.json")
            if os.path.exists(path):
                with open(path) as f:
                    conf = json.load(f)

        def pick(env_key: str, conf_key: str, default):
            if env_key in env:
                return env[env_key]
            return conf.get(conf_key, default)

        return ServerConfig(
            key_auth_enforced=_as_bool(
                pick("PIO_SERVER_KEY_AUTH_ENFORCED", "key_auth_enforced",
                     False)
            ),
            access_key=str(
                pick("PIO_SERVER_ACCESS_KEY", "access_key", "")
            ),
            ssl_enabled=_as_bool(
                pick("PIO_SERVER_SSL_ENABLED", "ssl_enabled", False)
            ),
            ssl_certfile=str(
                pick("PIO_SERVER_SSL_CERTFILE", "ssl_certfile", "")
            ),
            ssl_keyfile=str(
                pick("PIO_SERVER_SSL_KEYFILE", "ssl_keyfile", "")
            ),
            ssl_key_password=str(
                pick("PIO_SERVER_SSL_KEY_PASSWORD", "ssl_key_password", "")
            ),
        )

    # -- key auth (reference KeyAuthentication.withAccessKeyFromFile) -----
    def check_key(self, request: Request) -> None:
        """Raise 401 unless auth is off or the supplied server key
        matches. The key is read from (in order) the
        ``X-PIO-Server-Key`` header, an ``Authorization: Bearer`` header,
        or the ``accessKey`` query param (reference parity) — prefer the
        headers: query strings leak into request logs, shell history,
        and upstream proxies when TLS terminates early."""
        if not self.key_auth_enforced:
            return
        headers = getattr(request, "headers", None) or {}
        supplied = headers.get("X-PIO-Server-Key", "")
        if not supplied:
            auth = headers.get("Authorization", "")
            if auth.startswith("Bearer "):
                supplied = auth[len("Bearer "):].strip()
        if not supplied:
            supplied = request.query.get("accessKey", "")
        # compare as bytes: compare_digest rejects non-ASCII str input
        if not self.access_key or not hmac.compare_digest(
            supplied.encode("utf-8"), self.access_key.encode("utf-8")
        ):
            raise HTTPError(401, "invalid server access key")

    # -- TLS (reference SSLConfiguration.sslContext) ----------------------
    def ssl_context(self) -> ssl.SSLContext | None:
        if not self.ssl_enabled:
            return None
        if not self.ssl_certfile or not self.ssl_keyfile:
            raise ValueError(
                "ssl_enabled requires ssl_certfile and ssl_keyfile"
            )
        context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        context.minimum_version = ssl.TLSVersion.TLSv1_2
        context.load_cert_chain(
            certfile=self.ssl_certfile,
            keyfile=self.ssl_keyfile,
            password=self.ssl_key_password or None,
        )
        return context
