"""Server security configuration: access-key auth and TLS, as asked for.

Counterpart of ``ServerConfig`` in ``predictionio_tpu/serving/config.py``,
with the same settings read the same way: env vars win, then an
optional JSON file ``$PIO_CONF_DIR/server.json``, then the defaults
(auth off, TLS off).

Env vars / server.json keys::

    PIO_SERVER_KEY_AUTH_ENFORCED   "key_auth_enforced": bool
    PIO_SERVER_ACCESS_KEY          "access_key": str
    PIO_SERVER_SSL_ENABLED         "ssl_enabled": bool
    PIO_SERVER_SSL_CERTFILE        "ssl_certfile": PEM cert chain path
    PIO_SERVER_SSL_KEYFILE         "ssl_keyfile": PEM private key path
    PIO_SERVER_SSL_KEY_PASSWORD    "ssl_key_password": key password

The port's servers do not check the server key nor wrap TLS yet
(``check_key`` and ``ssl_context`` are ROADMAP.md, queue 1, item 5a).
So a console verb that binds an HTTP server asks :meth:`refusal` first
and exits when either is asked for: the port must not serve open what
the JAX package would guard.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping

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

    def refusal(self, server: str) -> str | None:
        """Why ``server`` may not start under this config (key auth or
        TLS asked for, neither ported), or None when it may."""
        asked = [
            what
            for what, on in (
                ("server key auth (PIO_SERVER_KEY_AUTH_ENFORCED)",
                 self.key_auth_enforced),
                ("TLS (PIO_SERVER_SSL_ENABLED)", self.ssl_enabled),
            )
            if on
        ]
        if not asked:
            return None
        return (
            f"{server}: {' and '.join(asked)} is not ported yet, and the "
            "server will not start without it (ROADMAP.md, queue 1, "
            "item 5a)"
        )
