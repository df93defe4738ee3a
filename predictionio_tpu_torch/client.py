"""Python client SDK — EventClient + EngineClient.

Counterpart of ``predictionio_tpu/client.py``: a thin stdlib-only HTTP
client for the Event Server (create/get/delete events, ``$set``
helpers, batch) and the Engine Server (``send_query``), as the
examples' seed scripts use it.

Resilience (docs/robustness.md): every request mints an
``X-PIO-Deadline`` header from its timeout so servers downstream can
refuse or drop work the caller has already given up on; idempotent
operations (GET/DELETE) retry with jittered exponential backoff inside
that budget; and each target host sits behind a process-wide circuit
breaker that fast-fails (:class:`~predictionio_tpu_torch.serving.resilience
.CircuitOpenError`) instead of piling timeouts onto a host that is
down. Raised :class:`PIOClientError`\\ s carry the server-echoed
``X-Request-ID`` as ``request_id`` for log/trace correlation.

Cooperative backpressure (docs/robustness.md "Overload &
backpressure"): a 429/503 shed carrying ``Retry-After`` is the server
ANSWERING — it never counts as a breaker failure — and the hint is
honored: the retry sleeps what the server asked (inside the deadline
budget) instead of a blind backoff. A shed guarantees the request was
not processed, so even POSTs replay safely after one. The in-context
criticality class (``X-PIO-Criticality``) propagates on every hop;
:meth:`EngineClient.send_query` takes it as a keyword.
"""

from __future__ import annotations

import datetime as _dt
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Mapping, Sequence

from predictionio_tpu_torch.obs.context import get_request_id
from predictionio_tpu_torch.obs.tracing import PARENT_SPAN_HEADER, current_span
from predictionio_tpu_torch.serving import admission, resilience


#: sticky-routing affinity key — same spelling as
#: ``serving.router.AFFINITY_HEADER`` (kept local so the client SDK
#: never imports the router module); the router hashes the value onto
#: its consistent ring so one affinity key always lands on the same
#: replica while the pool is stable
AFFINITY_HEADER = "X-PIO-Affinity"


class PIOClientError(RuntimeError):
    def __init__(
        self, status: int, message: str, request_id: str | None = None
    ):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message
        #: the server-echoed X-Request-ID — join a client-side failure
        #: to the server's logs and traces
        self.request_id = request_id


def _send_once(
    url: str, method: str, data: bytes | None, deadline, timeout: float,
    extra_headers: Mapping[str, str] | None = None,
) -> Any:
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    for name, value in (extra_headers or {}).items():
        req.add_header(name, value)
    # join the caller's trace: forward the context request ID (even
    # with tracing off — without it every hop mints a fresh ID and
    # cross-server log correlation breaks) and, when a span is open,
    # our span ID so the downstream server's root span nests under it
    rid = get_request_id()
    if rid:
        req.add_header("X-Request-ID", rid)
    parent = current_span()
    if parent is not None:
        req.add_header(PARENT_SPAN_HEADER, parent.span_id)
    criticality = admission.get_criticality()
    if criticality != admission.DEFAULT:
        # the class travels like the deadline: downstream admission
        # sheds by the ORIGINATING caller's criticality
        req.add_header(admission.CRITICALITY_HEADER, criticality)
    # whatever budget is left NOW rides to the server, so a retry
    # carries a smaller budget than the first attempt did
    req.add_header(resilience.DEADLINE_HEADER, deadline.to_header())
    with urllib.request.urlopen(
        req, timeout=deadline.cap(timeout)
    ) as resp:
        raw = resp.read()
        return json.loads(raw) if raw else None


def _request(
    url: str, method: str = "GET", body: Any = None, timeout: float = 10.0,
    extra_headers: Mapping[str, str] | None = None,
) -> Any:
    data = json.dumps(body).encode() if body is not None else None
    target = urllib.parse.urlsplit(url).netloc
    breaker = resilience.get_breaker(target)
    policy = resilience.RetryPolicy.from_env()
    # inherit a tighter ambient deadline when running inside a server
    # (feedback hop, tests); otherwise the timeout IS the budget.
    # `inherited` records WHOSE clock the budget is: only an inherited
    # budget expiring exempts a timeout from breaker accounting — a
    # self-minted budget times out exactly when the socket does, and
    # treating that as "our clock ran out" would mean a blackholed
    # host could never trip the breaker
    ambient = resilience.get_deadline()
    deadline = resilience.Deadline.after(timeout)
    inherited = (
        ambient is not None
        and ambient.expires_mono < deadline.expires_mono
    )
    if inherited:
        deadline.expires_mono = ambient.expires_mono
    idempotent = method in resilience.IDEMPOTENT_METHODS
    attempt = 0
    while True:
        if not breaker.allow():
            raise resilience.CircuitOpenError(target)
        try:
            out = _send_once(
                url, method, data, deadline, timeout, extra_headers
            )
            breaker.record_success()
            return out
        except urllib.error.HTTPError as e:
            request_id = e.headers.get("X-Request-ID") if e.headers else None
            try:
                message = json.loads(e.read()).get("message", "")
            except Exception:  # noqa: BLE001
                message = ""
            retry_after = admission.parse_retry_after(
                e.headers.get("Retry-After") if e.headers else None
            )
            if e.code in (429, 503) and retry_after is not None:
                # a shed carrying a hint is the server ANSWERING
                # (overload, drain, or fair share) — health, not
                # failure, for breaker purposes; tripping the breaker
                # on sheds would blackhole a merely-busy host. Only a
                # shed the server MARKS as refused-before-processing
                # (X-PIO-Shed) makes a non-idempotent POST safe to
                # replay — a bare 503 (e.g. a dependency's open
                # breaker surfacing mid-handler) may have partially
                # run. Honor the hinted delay when another attempt
                # fits the budget.
                breaker.record_success()
                replay_safe = idempotent or bool(
                    e.headers.get(admission.SHED_HEADER)
                )
                if (
                    replay_safe
                    and attempt + 1 < policy.max_attempts
                    and deadline.remaining_s() > retry_after
                ):
                    time.sleep(retry_after)
                    attempt += 1
                    continue
                raise PIOClientError(e.code, message, request_id) from e
            if e.code >= 500 and e.code != 504:
                breaker.record_failure()
                # retry only while the breaker stayed closed: when THIS
                # failure tripped it, sleeping a backoff to then raise
                # "circuit open" would waste the wait AND mask the real
                # error the caller needs
                if (
                    idempotent
                    and breaker.state == resilience.CLOSED
                    and policy.sleep_before_retry(attempt, deadline)
                ):
                    attempt += 1
                    continue
            else:
                # a 4xx — or a 504 refusing OUR expired budget — is the
                # server ANSWERING: health, not failure, for breaker
                # purposes
                breaker.record_success()
            raise PIOClientError(e.code, message, request_id) from e
        except OSError:
            # URLError (connection refused/reset, DNS, timeout) and
            # friends: the server never answered
            if inherited and deadline.expired:
                # starved by an INHERITED budget tighter than our own
                # timeout: the caller's clock ran out, which says
                # nothing about the target — release any half-open
                # probe slot instead of wedging the breaker
                breaker.release()
                raise
            breaker.record_failure()
            if (
                idempotent
                and breaker.state == resilience.CLOSED
                and policy.sleep_before_retry(attempt, deadline)
            ):
                attempt += 1
                continue
            raise
        except Exception:
            # anything else escaping the admitted call (malformed JSON
            # in a 200 body, a garbage status line) is no verdict on
            # the target's reachability — release, don't leak the slot
            breaker.release()
            raise


class EventClient:
    """Talks to the Event Server (default :7070)."""

    def __init__(
        self,
        access_key: str,
        url: str = "http://127.0.0.1:7070",
        channel: str | None = None,
    ):
        self._base = url.rstrip("/")
        self._key = access_key
        self._channel = channel

    def _qs(self, **extra) -> str:
        params = {"accessKey": self._key}
        if self._channel:
            params["channel"] = self._channel
        params.update({k: str(v) for k, v in extra.items()})
        return urllib.parse.urlencode(params)

    def create_event(
        self,
        event: str,
        entity_type: str,
        entity_id: str,
        target_entity_type: str | None = None,
        target_entity_id: str | None = None,
        properties: Mapping[str, Any] | None = None,
        event_time: _dt.datetime | str | None = None,
    ) -> str:
        body: dict[str, Any] = {
            "event": event,
            "entityType": entity_type,
            "entityId": entity_id,
        }
        if target_entity_type is not None:
            body["targetEntityType"] = target_entity_type
            body["targetEntityId"] = target_entity_id
        if properties:
            body["properties"] = dict(properties)
        if event_time is not None:
            body["eventTime"] = (
                event_time.isoformat()
                if isinstance(event_time, _dt.datetime)
                else event_time
            )
        out = _request(
            f"{self._base}/events.json?{self._qs()}", "POST", body
        )
        return out["eventId"]

    def create_events(self, events: Sequence[Mapping[str, Any]]) -> list:
        """Batch insert (≤50 per request); returns per-event statuses."""
        return _request(
            f"{self._base}/batch/events.json?{self._qs()}",
            "POST",
            list(events),
        )

    # -- $set sugar (SDK set_user/set_item equivalents) -------------------
    def set_user(self, uid: str, properties=None, event_time=None) -> str:
        return self.create_event(
            "$set", "user", uid, properties=properties, event_time=event_time
        )

    def set_item(self, iid: str, properties=None, event_time=None) -> str:
        return self.create_event(
            "$set", "item", iid, properties=properties, event_time=event_time
        )

    def record_user_action_on_item(
        self, action: str, uid: str, iid: str, properties=None,
        event_time=None,
    ) -> str:
        return self.create_event(
            action,
            "user",
            uid,
            target_entity_type="item",
            target_entity_id=iid,
            properties=properties,
            event_time=event_time,
        )

    def get_event(self, event_id: str) -> dict:
        eid = urllib.parse.quote(event_id, safe="")
        return _request(f"{self._base}/events/{eid}.json?{self._qs()}")

    def delete_event(self, event_id: str) -> None:
        eid = urllib.parse.quote(event_id, safe="")
        _request(
            f"{self._base}/events/{eid}.json?{self._qs()}", "DELETE"
        )

    def find_events(self, **params) -> list[dict]:
        return _request(f"{self._base}/events.json?{self._qs(**params)}")


class EngineClient:
    """Talks to the Engine Server (default :8000) — or to a
    router front tier, which speaks the same protocol.

    ``tenant`` labels every request for per-tenant fair-share admission
    (``X-PIO-Tenant``; docs/robustness.md "Overload & backpressure"):
    under sustained pressure a tenant over its equal share is shed
    first, so an unlabeled client competes in the anonymous bucket."""

    def __init__(
        self,
        url: str = "http://127.0.0.1:8000",
        tenant: str | None = None,
    ):
        self._base = url.rstrip("/")
        self._tenant = tenant

    def _headers(
        self, affinity: str | None = None
    ) -> dict[str, str]:
        headers: dict[str, str] = {}
        if self._tenant:
            headers[admission.TENANT_HEADER] = self._tenant
        if affinity:
            headers[AFFINITY_HEADER] = affinity
        return headers

    def send_query(
        self,
        data: Mapping[str, Any],
        timeout: float = 30.0,
        criticality: str | None = None,
        affinity: str | None = None,
    ):
        """``criticality`` labels the request for admission control
        (``critical`` | ``default`` | ``sheddable``; docs/robustness.md
        "Overload & backpressure") — under server overload the lowest
        class sheds first. ``affinity`` (docs/scale_out.md) pins the
        request to a consistent replica when the target is a serving
        router: pass a stable key (user ID, session) and the router's
        hash ring keeps sending it to the same replica while the pool
        is stable — without it affinity falls back to body bytes, so
        two different queries from one user can land on two replicas."""
        extra = self._headers(affinity)
        if criticality is not None:
            with admission.criticality(criticality):
                return _request(
                    f"{self._base}/queries.json", "POST", dict(data),
                    timeout, extra_headers=extra,
                )
        return _request(
            f"{self._base}/queries.json", "POST", dict(data), timeout,
            extra_headers=extra,
        )

    def send_batch_queries(
        self,
        queries: Sequence[Mapping[str, Any]],
        timeout: float = 60.0,
    ) -> list[dict]:
        """Many queries in one round trip (``/batch/queries.json``,
        ≤100 per call); returns per-query slots:
        ``{"status": 200, "prediction": ...}`` or
        ``{"status": 4xx/5xx, "message": ...}``. Roughly an order of
        magnitude more throughput per connection than send_query
        (BASELINE.md)."""
        return _request(
            f"{self._base}/batch/queries.json",
            "POST",
            [dict(q) for q in queries],
            timeout,
            extra_headers=self._headers(),
        )

    def status(self) -> dict:
        return _request(f"{self._base}/")
