"""Request-ID propagation.

Counterpart of ``predictionio_tpu/obs/context.py``, copied.

Every inbound HTTP request gets (or forwards, via ``X-Request-ID``) an
ID held in a :class:`contextvars.ContextVar`. The serving stack is
thread-per-request with synchronous handlers, so the contextvar rides
the handler thread end-to-end: the micro-batcher reads it at submit
time and carries it into the device-dispatch log line, which is what
makes one slow query traceable through the batcher to the device step.
"""

from __future__ import annotations

import contextvars
import json
import logging
import re
import secrets
import time

_request_id: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "pio_request_id", default=None
)

#: forwarded IDs (X-Request-ID, X-Parent-Span) are clamped to this
#: shape so a hostile header cannot smuggle log-breaking bytes or
#: unbounded cardinality into log lines or traces — ONE pattern for
#: request-ID and span-ID validation, so acceptance cannot drift
ID_OK = re.compile(r"^[A-Za-z0-9._:-]{1,128}$")


def new_request_id() -> str:
    return secrets.token_hex(8)


def set_request_id(request_id: str | None) -> str:
    """Install ``request_id`` (sanitized) for the current context,
    minting a fresh one when absent or malformed; returns the ID."""
    if not request_id or not ID_OK.match(request_id):
        request_id = new_request_id()
    _request_id.set(request_id)
    return request_id


def get_request_id() -> str | None:
    return _request_id.get()


#: keys travel in query strings for reference parity; they must never
#: land in logs, terminals, or CI output — one regex, shared by the
#: HTTP access log and the CLI, so the rule cannot drift
_ACCESS_KEY = re.compile(r"(accessKey=)[^&\s\"]+")


def redact_keys(text: str) -> str:
    """Blank accessKey values out of a URL or log line."""
    return _ACCESS_KEY.sub(r"\1[redacted]", text)


#: keys every structured line owns; caller fields must not shadow them
#: (log pipelines key on `event`, and a spoofed `requestId` would break
#: the correlation the header propagation exists for)
_RESERVED_KEYS = ("event", "ts", "requestId")


def log_json(
    logger: logging.Logger, level: int, event: str, /, **fields
) -> None:
    """One structured JSON log line, request ID included when present.

    Rendered eagerly only when the level is enabled — the hot path pays
    an ``isEnabledFor`` check, not a ``json.dumps``. Caller fields that
    collide with the reserved ``event``/``ts``/``requestId`` keys are
    re-keyed with a trailing underscore instead of overwriting them
    (the positional-only ``/`` keeps a caller's ``event=...`` out of
    the parameter slot, where it used to raise TypeError mid-log).
    """
    if not logger.isEnabledFor(level):
        return
    record = {"event": event, "ts": round(time.time(), 3)}
    rid = _request_id.get()
    if rid is not None:
        record["requestId"] = rid
    for key in _RESERVED_KEYS:
        if key in fields:
            fields[f"{key}_"] = fields.pop(key)
    record.update(fields)
    logger.log(level, json.dumps(record, default=str))
