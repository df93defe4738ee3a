"""The serving router: the port's ``serving/router.py`` against the JAX
package's.

* ``_hash64`` and ``_ring_pick`` pick the same replica for the same
  replica set and keys;
* ``_candidates`` orders the same replicas alike for drawn inflight
  counts, saturation and breaker states; ``_affinity_key`` resolves
  alike (``X-PIO-Affinity``, tenant, body, then ``Request.client_addr``,
  which each package's HTTP server sets); a replica's breaker moves
  alike under one fake clock; the ``X-PIO-Deadline`` a replica receives
  is decremented alike with the clock held;
* the faults of the JAX router this port repairs: a tenant's key keeps
  the tenant on its home replica under load, where JAX lets the
  least-loaded replica take it; a replica dying mid-answer fails over,
  where JAX answers 500;
* each package's router adopts a state file the other wrote, and both
  discard a torn, stale, foreign or unreadable one with the same note;
* scripted replica signals (resets, 500s, sheds, drains, a cold or dead
  replica, swaps plain and gated, token replays, the admin routes)
  give equal statuses, bodies, swap records and phases, and
  ``pio_router_*`` samples, ids and times masked;
* both routers in front of the same two in-process port engine servers
  on the CPU answer one seeded script with equal statuses, bodies and
  ``pio_router_*`` samples.
"""

from __future__ import annotations

import datetime as dt
import hashlib
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from predictionio_tpu.obs import MetricRegistry as JaxRegistry
from predictionio_tpu.serving import admission as jax_admission
from predictionio_tpu.serving import canary as jax_canary
from predictionio_tpu.serving import config as jax_config
from predictionio_tpu.serving import http as jax_http
from predictionio_tpu.serving import resilience as jax_resilience
from predictionio_tpu.serving import router as jax_router
from predictionio_tpu_torch.obs import MetricRegistry
from predictionio_tpu_torch.serving import admission, canary, config, http
from predictionio_tpu_torch.serving import resilience
from predictionio_tpu_torch.serving import router

PKGS = {
    "jax": SimpleNamespace(name="jax", Registry=JaxRegistry, router=jax_router,
                           http=jax_http, resilience=jax_resilience,
                           canary=jax_canary, config=jax_config,
                           admission=jax_admission),
    "port": SimpleNamespace(name="port", Registry=MetricRegistry,
                            router=router, http=http, resilience=resilience,
                            canary=canary, config=config,
                            admission=admission),
}


def _both(scenario, *args):
    """(port's observation, JAX's) of one scenario run on each package."""
    return scenario(PKGS["port"], *args), scenario(PKGS["jax"], *args)


def _wait(cond, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _unminted(body):
    """A body without the ``requestId`` each server mints anew."""
    if isinstance(body, dict):
        return {k: v for k, v in body.items() if k != "requestId"}
    return body


def _post(base: str, path: str, body, headers=None, raw: bytes | None = None):
    req = urllib.request.Request(
        base + path, method="POST", headers=headers or {},
        data=raw if raw is not None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            return (resp.status, _unminted(json.loads(resp.read())),
                    dict(resp.headers))
    except urllib.error.HTTPError as e:
        return (e.code, _unminted(json.loads(e.read() or b"null")),
                dict(e.headers))


def _get(base: str, path: str, headers=None, method: str = "GET"):
    req = urllib.request.Request(base + path, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            return resp.status, _unminted(json.loads(resp.read()))
    except urllib.error.HTTPError as e:
        return e.code, _unminted(json.loads(e.read() or b"null"))


def _router_samples(registry) -> dict:
    """The ``pio_router_*`` samples of a registry."""
    return {name: sorted(json.dumps(s, sort_keys=True)
                         for s in fam["samples"])
            for name, fam in registry.to_dict().items()
            if name.startswith("pio_router_")}


# -- hashing and selection ---------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(data=st.binary(max_size=64))
def test_hash64_alike(data):
    assert router._hash64(data) == jax_router._hash64(data)
    assert router._hash64(data) == int.from_bytes(
        hashlib.sha1(data).digest()[:8], "big")


def _selection_router(p, n):
    r = p.router.ServingRouter(probe_interval_s=999.0, registry=p.Registry())
    reps = [r.add_replica(f"http://127.0.0.1:{9000 + i}", replica_id=f"r{i}")
            for i in range(n)]
    for rep in reps:
        rep.state = p.router.HEALTHY
    return r, reps


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_ring_pick_alike(n):
    def picks(p):
        r, reps = _selection_router(p, n)
        try:
            keys = [f"key-{i}".encode() for i in range(300)]
            out = [r._ring_pick(reps, k).replica_id for k in keys]
            # a tied subset rings alike too
            out += [r._ring_pick(reps[: max(1, n // 2)], k).replica_id
                    for k in keys[:50]]
            return out
        finally:
            r.close()

    port, jax = _both(picks)
    assert port == jax
    assert len(set(port[:300])) == min(n, len(set(port[:300])))


_REPLICA_STATE = st.tuples(st.integers(0, 3), st.booleans(),
                           st.sampled_from(["closed", "open"]))


@settings(max_examples=60, deadline=None)
@given(states=st.lists(_REPLICA_STATE, min_size=1, max_size=5),
       keys=st.lists(st.binary(min_size=1, max_size=12), min_size=1,
                     max_size=8),
       exclude=st.sets(st.sampled_from(["r0", "r1", "r2"]), max_size=2))
def test_candidates_order_alike(states, keys, exclude):
    now = time.monotonic()

    def order(p):
        r, reps = _selection_router(p, len(states))
        try:
            for rep, (inflight, saturated, breaker) in zip(reps, states):
                rep._inflight = inflight
                rep.saturated_until = now + 60.0 if saturated else 0.0
                if breaker == "open":
                    for _ in range(10):
                        rep.breaker.record_failure()
            return [[c.replica_id for c in r._candidates(k, set(exclude))]
                    for k in keys]
        finally:
            r.close()

    port, jax = _both(order)
    assert port == jax


def test_tenant_stays_home_under_load_where_jax_spreads_it():
    """A fault of the JAX router: its ``_affinity_key`` keys a tenant's
    traffic to one replica so the tenant's model stays hot in one pool,
    but ``_candidates`` lets the least-loaded replica win first, so
    under concurrent traffic a tenant spreads over every replica. The
    port pins the tenant's home replica (saturation or a failover still
    moves it); plain keys keep least-inflight."""
    def first(p, key, home_busy):
        r, reps = _selection_router(p, 2)
        try:
            home = r._ring_pick(reps, key)
            other = [x for x in reps if x is not home][0]
            home._inflight = 3 if home_busy else 0
            picks = [c.replica_id for c in r._candidates(key, set())]
            home.saturated_until = time.monotonic() + 60.0
            spilled = r._candidates(key, set())[0].replica_id
            return home.replica_id, other.replica_id, picks, spilled
        finally:
            r.close()

    key = b"tenant:acme"
    home, other, picks, spilled = first(PKGS["port"], key, True)
    assert picks == [home, other]  # the busy home replica first
    assert spilled == other  # a saturated home spills to the next
    j_home, j_other, j_picks, _ = first(PKGS["jax"], key, True)
    assert j_home == home and j_picks == [other, home]  # JAX: load wins
    # idle: both packages pick the home replica
    assert first(PKGS["port"], key, False)[2] == first(
        PKGS["jax"], key, False)[2]
    # a plain key stays least-inflight in the port
    _h, _o, plain, _s = first(PKGS["port"], b"body", True)
    assert plain == _both(lambda p: first(p, b"body", True)[2])[1]


_AFFINITY_CASES = {
    "explicit": ({"X-PIO-Affinity": "u9"}, {"accessKey": "alice"}, b"{}",
                 "127.0.0.1:5"),
    "access_key": ({}, {"accessKey": "alice"}, b"{'x': 1}", "1.2.3.4:5"),
    "tenant_header": ({"X-PIO-Tenant": "alice"}, {}, b"other", ""),
    "key_beats_header": ({"X-PIO-Tenant": "bob"}, {"accessKey": "alice"},
                         b"", ""),
    "body": ({}, {}, b'{"user": "u1"}', "127.0.0.1:40000"),
    "client_addr": ({}, {}, b"", "127.0.0.1:40000"),
    "nothing": ({}, {}, b"", ""),
}


@pytest.mark.parametrize("case", sorted(_AFFINITY_CASES))
def test_affinity_key_alike(case):
    headers, query, body, addr = _AFFINITY_CASES[case]

    def key(p):
        r = p.router.ServingRouter(probe_interval_s=999.0,
                                   registry=p.Registry())
        try:
            req = p.http.Request("POST", "/queries.json", dict(query),
                                 dict(headers), body, {})
            req.client_addr = addr
            return r._affinity_key(req)
        finally:
            r.close()

    port, jax = _both(key)
    assert port == jax
    if case == "client_addr":
        assert port == b"127.0.0.1:40000"


def test_server_sets_client_addr_alike():
    def seen(p):
        got = []
        r = p.http.Router()
        r.route("GET", "/x", lambda req: (
            got.append(req.client_addr), p.http.Response(200, {}))[1])
        server = p.http.HTTPServer(r, host="127.0.0.1", port=0)
        server.start()
        try:
            assert _get(f"http://127.0.0.1:{server.port}", "/x")[0] == 200
        finally:
            server.shutdown()
        host, _, port = got[0].rpartition(":")
        return host, int(port) > 0

    port, jax = _both(seen)
    assert port == jax == ("127.0.0.1", True)


def test_breaker_transitions_alike_under_a_fake_clock():
    def transitions(p):
        clock = [100.0]
        rep = p.router.Replica(
            "r0", "http://127.0.0.1:1", registry=p.Registry(),
            breaker_config=p.resilience.BreakerConfig(
                failure_threshold=2, reset_after_s=5.0))
        rep.breaker._clock = lambda: clock[0]
        seen = []
        for step in ("fail", "fail", "allow", "tick4", "allow", "tick2",
                     "allow", "allow", "fail", "tick6", "allow", "ok",
                     "allow", "fail", "ok", "allow"):
            if step == "fail":
                rep.breaker.record_failure()
            elif step == "ok":
                rep.breaker.record_success()
            elif step.startswith("tick"):
                clock[0] += float(step[4:])
            else:
                seen.append(rep.breaker.allow())
            seen.append(rep.breaker.state)
        return seen

    port, jax = _both(transitions)
    assert port == jax
    assert "open" in port and "half_open" in port


class _Capture:
    """A replica of one package that records the headers it is sent."""

    def __init__(self, p, status: int = 200, retry_after: str | None = None):
        self.headers: list = []
        self.p = p
        r = p.http.Router()

        def handle(req):
            self.headers.append({k.lower(): v for k, v in req.headers.items()})
            extra = {"Retry-After": retry_after} if retry_after else None
            return p.http.Response(status, {"ok": status}, headers=extra)

        r.route("POST", "/queries.json", handle)
        self.server = p.http.HTTPServer(r, host="127.0.0.1", port=0)
        self.server.start()
        self.url = f"http://127.0.0.1:{self.server.port}"

    def close(self):
        self.server.shutdown()


@pytest.mark.parametrize("budget_ms", [10_000, 1_500, 400])
def test_deadline_decrement_alike(budget_ms, monkeypatch):
    """With the clock held, the budget a replica receives is the
    client's less the failover reserve (none when too tight), alike."""
    def forwarded(p):
        frozen = time.monotonic()
        monkeypatch.setattr(p.resilience.time, "monotonic", lambda: frozen)
        cap = _Capture(p)
        r = p.router.ServingRouter(probe_interval_s=999.0,
                                   registry=p.Registry(),
                                   proxy_timeout_s=4.0)
        try:
            rep = r.add_replica(cap.url, replica_id="a")
            rep.state = p.router.HEALTHY
            req = p.http.Request("POST", "/queries.json", {},
                                 {"Content-Type": "application/json"},
                                 b'{"x": 1}', {})
            p.resilience.set_deadline(
                p.resilience.Deadline.after(budget_ms / 1000.0))
            try:
                resp = r._proxy(req)
            finally:
                p.resilience.set_deadline(None)
            return resp.status, cap.headers[0].get("x-pio-deadline")
        finally:
            r.close()
            cap.close()
            monkeypatch.undo()

    port, jax = _both(forwarded)
    assert port == jax
    assert int(port[1]) <= budget_ms


@pytest.mark.parametrize("case", ["all_saturated", "one_saturated",
                                  "critical_bypass"])
def test_shed_decision_alike(case):
    def decide(p):
        caps = [_Capture(p), _Capture(p)]
        r = p.router.ServingRouter(probe_interval_s=999.0,
                                   registry=p.Registry())
        try:
            reps = [r.add_replica(c.url, replica_id=f"r{i}")
                    for i, c in enumerate(caps)]
            for i, rep in enumerate(reps):
                rep.state = p.router.HEALTHY
                if case != "one_saturated" or i == 0:
                    rep.saturated_until = time.monotonic() + 30.0
            headers = {"Content-Type": "application/json"}
            req = p.http.Request("POST", "/queries.json", {}, headers,
                                 b'{"x": 1}', {})
            if case == "critical_bypass":
                req.criticality = p.admission.CRITICAL
            resp = r._proxy(req)
            return (resp.status,
                    (resp.headers or {}).get(p.admission.SHED_HEADER),
                    "Retry-After" in (resp.headers or {}),
                    [len(c.headers) for c in caps], r._shed_count)
        finally:
            r.close()
            for c in caps:
                c.close()

    port, jax = _both(decide)
    assert port == jax
    if case == "all_saturated":
        assert port[:3] == (503, "saturated", True) and port[4] == 1
    else:
        assert port[0] == 200



class _CutShort:
    """A replica that dies while it sends its answer: the status line and
    headers, a few bytes of a 100-byte body, then the connection closes."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.url = f"http://127.0.0.1:{self.sock.getsockname()[1]}"
        self.calls = 0
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _addr = self.sock.accept()
            except OSError:
                return
            with conn:
                # the whole request is read first: unread bytes at close
                # would make the kernel reset the connection (an OSError
                # to the reader) instead of ending it after the cut body
                data = b""
                while b"\r\n\r\n" not in data:
                    chunk = conn.recv(4096)
                    if not chunk:
                        break
                    data += chunk
                head, _, body = data.partition(b"\r\n\r\n")
                length = int(re.search(rb"(?i)content-length:\s*(\d+)",
                                       head).group(1))
                while len(body) < length:
                    body += conn.recv(4096)
                self.calls += 1
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Type: "
                             b"application/json\r\nContent-Length: 100"
                             b"\r\n\r\n{\"res")
                conn.shutdown(socket.SHUT_WR)

    def close(self):
        self.sock.close()


def test_replica_dying_mid_body_fails_over_where_jax_answers_500():
    """A fault of the JAX router: a replica killed while it sends its
    body raises ``http.client.IncompleteRead`` in ``_forward``, which is
    not an ``OSError``; the JAX router lets it escape and the client gets
    a 500. The port counts it a transport error: the breaker records a
    failure and the request fails over to a sibling."""
    def run(p):
        cut, ok = _CutShort(), _Replica(p, "ok")
        r = p.router.ServingRouter(probe_interval_s=999.0,
                                   registry=p.Registry(), failover_retries=1)
        server = r.serve(host="127.0.0.1", port=0)
        server.start()
        try:
            reps = [r.add_replica(cut.url, replica_id="cut"),
                    r.add_replica(ok.url, replica_id="ok")]
            for rep in reps:
                rep.state = p.router.HEALTHY
            key = next(f"k{i}" for i in range(100) if r._ring_pick(
                reps, f"k{i}".encode()).replica_id == "cut")
            status, body, _h = _post(f"http://127.0.0.1:{server.port}",
                                     "/queries.json", {"x": 4},
                                     {"X-PIO-Affinity": key})
            failovers = _router_samples(r._registry).get(
                "pio_router_failovers_total")
            return status, body, cut.calls, ok.calls, failovers
        finally:
            r.close()
            server.shutdown()
            cut.close()
            ok.close()

    port, jax = _both(run)
    assert port[:4] == (200, {"result": 4}, 1, 1)
    assert port[4] == ['{"labels": {}, "value": 1.0}']
    assert jax[0] == 500 and "IncompleteRead" in jax[1]["message"]
    assert jax[2:4] == (1, 0)


# -- state files across packages -------------------------------------------


def _stateful_router(p, path, **kw):
    return p.router.ServingRouter(probe_interval_s=999.0,
                                  registry=p.Registry(), state_path=path,
                                  **kw)


def _fleet_picture(r) -> dict:
    with r._lock:
        return {
            "replicas": sorted(
                (x.replica_id, x.url, x.generation, x.pid, x.staged,
                 x.admin_draining, x.state) for x in r._replicas.values()),
            "serving": r._serving_generation,
            "swaps": sorted(json.dumps(s, sort_keys=True)
                            for s in r._swaps.values()),
            "completed": r._swaps_completed_total,
            "tokens": sorted(r._swap_tokens),
        }


@pytest.mark.parametrize("writer, reader", [("jax", "port"),
                                            ("port", "jax")])
def test_state_file_adopted_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "state.json")
    w = _stateful_router(PKGS[writer], path)
    try:
        w.add_replica("http://127.0.0.1:9101", replica_id="a",
                      generation="g1", pid=4242)
        w.add_replica("http://127.0.0.1:9102", replica_id="b",
                      generation="g1")
        w.add_replica("http://127.0.0.1:9103", replica_id="c",
                      generation="g2", staged=True)
        w.park("b")
        with w._lock:
            w._serving_generation = "g1"
            w._swaps["swap-1"] = {"id": "swap-1", "token": "tok",
                                  "phase": "done", "generation": "g0",
                                  "retired": ["z"]}
            w._swap_tokens["tok"] = "swap-1"
            w._swaps_completed_total = 3
        w._persist_state()
        written = _fleet_picture(w)
    finally:
        w.close()
    with open(path) as f:
        doc = json.load(f)
    assert doc["schema"] == "pio-router-state/v1"
    r = _stateful_router(PKGS[reader], path)
    try:
        adopted = _fleet_picture(r)
        with r._lock:
            note = r._state_note
    finally:
        r.close()
    # every adopted replica re-proves itself: WARMING (parked: DRAINING)
    assert adopted["replicas"] == [
        (rid, url, gen, pid, staged, parked,
         "draining" if parked else "warming")
        for rid, url, gen, pid, staged, parked, _s in written["replicas"]]
    assert {k: v for k, v in adopted.items() if k != "replicas"} == {
        k: v for k, v in written.items() if k != "replicas"}
    assert note == "adopted 3 replica(s)"


def _spoil(path, how: str) -> None:
    with open(path) as f:
        doc = json.load(f)
    if how == "torn":
        doc["payload"]["servingGeneration"] = "tampered"
    elif how == "stale":
        doc["savedAtUtc"] = (dt.datetime.now(dt.timezone.utc)
                             - dt.timedelta(hours=2)).isoformat(
                                 timespec="seconds")
    elif how == "schema":
        doc["schema"] = "something-else/v9"
    if how == "unreadable":
        text = "{not json"
    else:
        text = json.dumps(doc)
    with open(path, "w") as f:
        f.write(text)


@pytest.mark.parametrize("how", ["torn", "stale", "schema", "unreadable",
                                 "missing"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spoiled_state_discarded_alike(tmp_path, how, writer):
    path = str(tmp_path / "state.json")
    if how != "missing":
        w = _stateful_router(PKGS[writer], path)
        try:
            w.add_replica("http://127.0.0.1:9101", replica_id="a")
        finally:
            w.close()
        _spoil(path, how)

    def adopt(p):
        r = _stateful_router(p, path, state_max_age_s=300.0)
        try:
            with r._lock:
                note = r._state_note
            if how == "unreadable":  # the parser's own words follow
                note = ": ".join(note.split(": ")[:2])
            return note, sorted(r.replica_states())
        finally:
            r.close()

    port = adopt(PKGS["port"])
    jax = adopt(PKGS["jax"])
    assert port == jax
    assert port[1] == []
    if how == "missing":
        assert port[0] == ""
    else:
        assert port[0].startswith("discarded: state file")


# -- scripted replica signals ------------------------------------------------


class _Replica:
    """A replica-shaped server of one package with scriptable behavior:
    resets, 500s, sheds, a delay, its warmup gauge, NaN or offset
    answers (the fleet gate's evidence)."""

    def __init__(self, p, name: str, warm: float = 1.0, offset: int = 0):
        self.p = p
        self.name = name
        self.warm = warm
        self.offset = offset
        self.nan = False
        self.fail_next = self.reset_next = self.shed_next = 0
        self.delay_s = 0.0
        self.calls = 0
        self.deadlines: list = []
        self.criticality: list = []
        self.tenants: list = []
        self._lock = threading.Lock()
        r = p.http.Router()
        r.route("POST", "/queries.json", self._queries)
        r.route("POST", "/batch/queries.json", self._queries)
        r.route("GET", "/metrics.json", self._metrics)
        self.http = p.http.HTTPServer(r, host="127.0.0.1", port=0,
                                      service=f"replica-{name}")
        self.http.start()
        self.url = f"http://127.0.0.1:{self.http.port}"

    def _queries(self, request):
        p = self.p
        with self._lock:
            self.calls += 1
            self.deadlines.append(
                request.headers.get(p.resilience.DEADLINE_HEADER))
            self.criticality.append(
                request.headers.get(p.admission.CRITICALITY_HEADER))
            self.tenants.append(
                request.headers.get(p.admission.TENANT_HEADER))
            if self.reset_next > 0:
                self.reset_next -= 1
                raise p.resilience.ChaosReset()
            if self.fail_next > 0:
                self.fail_next -= 1
                raise p.http.HTTPError(500, "injected replica failure")
            if self.shed_next > 0:
                self.shed_next -= 1
                return p.http.Response(503, {"message": "overloaded"},
                                       headers={"Retry-After": "0.30"})
        if self.delay_s:
            time.sleep(self.delay_s)
        q = json.loads(request.body)
        if isinstance(q, list):
            if request.path == "/queries.json":
                return p.http.Response(400, {"message": "not an object"})
            return p.http.Response(
                200, [{"result": x.get("x", 0) + self.offset} for x in q])
        value = float("nan") if self.nan else q.get("x", 0) + self.offset
        return p.http.Response(200, {"result": value})

    def _metrics(self, request):
        return self.p.http.Response(200, {"pio_warmup_complete": {
            "type": "gauge", "samples": [{"labels": {}, "value": self.warm}]}})

    def close(self):
        self.http.shutdown()


def _make(p, *replicas, **kw):
    kw.setdefault("probe_interval_s", 0.05)
    kw.setdefault("unhealthy_after", 1)
    kw.setdefault("registry", p.Registry())
    kw.setdefault("breaker_config", p.resilience.BreakerConfig(
        failure_threshold=2, reset_after_s=0.25))
    r = p.router.ServingRouter(**kw)
    for rep in replicas:
        r.add_replica(rep.url, replica_id=rep.name)
    return r


def _gate(p, **kw):
    cfg = dict(shadow_sample=1.0, min_shadow=3, max_divergence=0.05,
               watch_min_requests=2, watch_s=0.3, shadow_timeout_s=5.0,
               latency_factor=50.0)
    cfg.update(kw)
    return p.canary.CanaryConfig(**cfg)


def _mask_record(rec: dict) -> dict:
    """A swap record without its ids, and with the counts a verdict
    races (how many samples landed before it was read) as signs."""
    out = {k: v for k, v in rec.items() if k not in ("id", "url", "gate")}
    if rec.get("gate"):
        out["gate"] = {"state": rec["gate"].get("state"),
                       "nan": bool(rec["gate"].get("nanPredictions")),
                       "exceptions": rec["gate"].get("exceptions")}
    if out.get("error"):
        out["error"] = re.sub(r"\d+\.\d+", "#",
                              out["error"].split(" (")[0])
    return out


def _pump(base, rec, phases, timeout=30.0, on_phase=None, body=None):
    seen = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        phase = rec.get("phase")
        if not seen or seen[-1] != phase:
            seen.append(phase)
            if on_phase is not None:
                on_phase(phase)
        if phase in phases:
            break
        _post(base, "/queries.json", body or {"x": 7})
        time.sleep(0.01)
    return seen


def _scenario(p, name):
    """Run one scripted scenario against package ``p``'s router and
    fake replicas; what a client and the router's registry saw."""
    reps: list = []
    r = server = None
    seen: dict = {}

    def mk(*names, **kw):
        made = [_Replica(p, n) for n in names]
        reps.extend(made)
        return made

    def serve(rt):
        nonlocal server
        server = rt.serve(host="127.0.0.1", port=0)
        server.start()
        return f"http://127.0.0.1:{server.port}"

    try:
        if name in ("failover_reset", "both_die_502", "expired_deadline",
                    "passthrough_4xx", "all_draining", "one_draining",
                    "shed_failover", "all_saturated", "critical_bypass",
                    "forwarded_headers", "open_breaker", "trace"):
            a, b = mk("a", "b")
            r = _make(p, a, b, failover_retries=1)
            base = serve(r)
            assert _wait(lambda: set(r.replica_states().values())
                         == {p.router.HEALTHY})
            if name == "failover_reset":
                a.reset_next = 5
                seen["q"] = _post(base, "/queries.json", {"x": 7},
                                  {"X-PIO-Deadline": "10000"})[:2]
            elif name == "both_die_502":
                a.reset_next = b.reset_next = 1
                seen["q"] = _post(base, "/queries.json", {"x": 1},
                                  {"X-PIO-Deadline": "10000"})[:2]
                ds = [float(h) for h in a.deadlines + b.deadlines if h]
                seen["decremented"] = bool(ds) and all(v <= 10000
                                                       for v in ds)
            elif name == "expired_deadline":
                seen["q"] = _post(base, "/queries.json", {"x": 1},
                                  {"X-PIO-Deadline": "0"})[:2]
                seen["calls"] = a.calls + b.calls
            elif name == "passthrough_4xx":
                seen["nope"] = _post(base, "/nope.json", {"x": 1})[0]
                seen["bad"] = _post(base, "/queries.json", None,
                                    raw=b"{not json")[:2]
            elif name == "all_draining":
                a.http.begin_drain()
                b.http.begin_drain()
                assert _wait(lambda: set(r.replica_states().values())
                             == {p.router.DRAINING})
                st_, body, h = _post(base, "/queries.json", {"x": 1})
                seen["q"] = (st_, body, h.get("Retry-After"))
            elif name == "one_draining":
                a.http.begin_drain()
                assert _wait(lambda: r.replica_states()["a"]
                             == p.router.DRAINING)
                seen["q"] = [_post(base, "/queries.json", {"x": i})[:2]
                             for i in range(5)]
                seen["b_calls"] = b.calls
            elif name == "shed_failover":
                a.shed_next = 5
                # a's ring point takes x=3: the shed is a's answer
                seen["q"] = [_post(base, "/queries.json", {"x": 3},
                                   {"X-PIO-Deadline": "10000"})[0]
                             for _ in range(4)]
                with r._lock:
                    rep_a = r._replicas["a"]
                seen["a"] = (rep_a.breaker.state,)
            elif name == "all_saturated":
                a.shed_next = b.shed_next = 2
                st_, body, h = _post(base, "/queries.json", {"x": 5},
                                     {"X-PIO-Deadline": "10000"})
                seen["first"] = (st_, body, h.get("X-PIO-Shed"))
                calls = a.calls + b.calls
                st2, body2, h2 = _post(base, "/queries.json", {"x": 6})
                seen["second"] = (st2, body2, h2.get("X-PIO-Shed"),
                                  a.calls + b.calls - calls)
            elif name == "critical_bypass":
                a.shed_next = b.shed_next = 1
                _post(base, "/queries.json", {"x": 1},
                      {"X-PIO-Deadline": "10000"})
                calls = a.calls + b.calls
                seen["q"] = _post(base, "/queries.json", {"x": 2}, {
                    p.admission.CRITICALITY_HEADER: "critical"})[:2]
                seen["forwarded"] = a.calls + b.calls - calls
            elif name == "forwarded_headers":
                _post(base, "/queries.json", {"x": 9},
                      {p.admission.CRITICALITY_HEADER: "sheddable"})
                _post(base, "/queries.json", {"x": 1},
                      {p.admission.TENANT_HEADER: "acme"})
                _post(base, "/queries.json?accessKey=k-42", {"x": 2},
                      {p.admission.TENANT_HEADER: "acme"})
                seen["crit"] = sorted(str(c) for c in
                                      a.criticality + b.criticality)
                seen["tenants"] = sorted(str(t) for t in
                                         a.tenants + b.tenants)
            elif name == "open_breaker":
                a.fail_next = 100
                seen["q"] = [_post(base, "/queries.json", {"x": i})[:2]
                             for i in range(3)]
                with r._lock:
                    seen["breaker"] = r._replicas["a"].breaker.state
            elif name == "trace":
                from_pkg = __import__(
                    f"{p.router.__name__.rsplit('.', 2)[0]}.obs.tracing",
                    fromlist=["get_tracer"])
                _post(base, "/queries.json", {"x": 1},
                      {"X-Request-ID": f"trace-{p.name}"})
                names = {s["name"] for t in from_pkg.get_tracer().to_dict()
                         .get("traces", []) for s in t.get("spans", [])
                         if s.get("traceId") == f"trace-{p.name}"}
                seen["spans"] = sorted(
                    "router " if n.startswith("router ") and "/" not in n
                    else n.split(" ")[0] for n in names)
        elif name == "cold_until_warm":
            (rep,) = mk("cold")
            rep.warm = 0.0
            r = _make(p, rep)
            time.sleep(0.3)
            seen["cold"] = r.replica_states()
            rep.warm = 1.0
            seen["warm"] = _wait(lambda: r.replica_states()
                                 == {"cold": p.router.HEALTHY})
        elif name == "dead_then_back":
            (rep,) = mk("flappy")
            r = _make(p, rep)
            assert _wait(lambda: r.replica_states()
                         == {"flappy": p.router.HEALTHY})
            rep.http.shutdown()
            seen["down"] = _wait(lambda: r.replica_states()
                                 == {"flappy": p.router.UNHEALTHY})
            (rep2,) = mk("flappy2")
            with r._lock:
                r._replicas["flappy"].url = rep2.url
            seen["back"] = _wait(lambda: r.replica_states()
                                 == {"flappy": p.router.HEALTHY})
        elif name == "no_replicas":
            r = _make(p)
            base = serve(r)
            st_, body, h = _post(base, "/queries.json", {"x": 1})
            seen["q"] = (st_, body, h.get("Retry-After"))
        elif name in ("swap_plain", "swap_never_warm", "swap_token"):
            old, new = mk("old", "new")
            if name == "swap_never_warm":
                new.warm = 0.0
            old.delay_s = 0.3 if name == "swap_plain" else 0.0
            r = _make(p, old, failover_retries=0)
            base = serve(r)
            assert _wait(lambda: r.replica_states().get("old")
                         == p.router.HEALTHY)
            if name == "swap_plain":
                result = {}
                t = threading.Thread(target=lambda: result.setdefault(
                    "slow", _post(base, "/queries.json", {"x": 5})[:2]))
                t.start()
                assert _wait(lambda: old.calls >= 1)
                rec = r.rolling_swap(new.url, generation="g2",
                                     replica_id="new", wait=True)
                t.join(15)
                seen["slow"] = result["slow"]
                seen["after"] = _post(base, "/queries.json", {"x": 9})[:2]
            elif name == "swap_never_warm":
                rec = r.rolling_swap(new.url, generation="g2",
                                     replica_id="new", warm_timeout_s=0.5,
                                     wait=True)
            else:
                rec = r.rolling_swap(new.url, generation="g2",
                                     replica_id="new", wait=True,
                                     token="gen-2")
                replay = r.rolling_swap(new.url, generation="g2",
                                        replica_id="new2", wait=True,
                                        token="gen-2")
                seen["replay_is_first"] = replay is rec
                st_, rep_body, _h = _post(
                    base, "/admin/swap",
                    {"url": new.url, "generation": "g2", "token": "gen-2"})
                seen["http_replay"] = (st_, rep_body["id"] == rec["id"])
            seen["record"] = _mask_record(rec)
            seen["states"] = r.replica_states()
        elif name in ("gate_promote", "gate_divergent", "gate_nan",
                      "gate_rollback", "gate_batch"):
            a = _Replica(p, "a")
            b = _Replica(p, "b", offset=1000 if name == "gate_divergent"
                         else 0)
            reps.extend([a, b])
            b.nan = name == "gate_nan"
            gate = (_gate(p, watch_s=3.0) if name == "gate_rollback"
                    else _gate(p))
            r = _make(p, a, failover_retries=0, gate_config=gate,
                      gate_timeout_s=30.0, watch_timeout_s=30.0)
            base = serve(r)
            assert _wait(lambda: r.replica_states().get("a")
                         == p.router.HEALTHY)
            rec = r.rolling_swap(b.url, generation="g2", replica_id="b")

            def on_phase(phase):
                if name == "gate_rollback" and phase == "watching":
                    b.fail_next = 10 ** 6

            if name == "gate_batch":
                for _ in range(5):
                    _post(base, "/batch/queries.json", [{"x": 1}, {"x": 2}])
            phases = _pump(base, rec, ("done", "failed", "rolled_back"),
                           on_phase=on_phase)
            seen["phases"] = [x for x in phases if x != "warming"]
            if name == "gate_rollback":
                assert _wait(lambda: r.replica_states().get("a")
                             == p.router.HEALTHY)
            seen["record"] = _mask_record(rec)
            seen["serving"] = r.serving_generation
            assert _wait(lambda: "b" not in r.replica_states()
                         or rec["phase"] == "done")
            seen["states"] = r.replica_states()
        elif name == "admin_routes":
            (rep,) = mk("a")
            r = _make(p, server_config=p.config.ServerConfig(
                key_auth_enforced=True, access_key="sekrit"))
            base = serve(r)
            key = {"X-PIO-Server-Key": "sekrit"}
            seen["nokey"] = _post(base, "/admin/replicas",
                                  {"url": rep.url})[0]
            st_, body, _h = _post(base, "/admin/replicas",
                                  {"id": "a", "url": rep.url,
                                   "generation": "g1"}, key)
            seen["register"] = (st_, body["id"], body["state"])
            seen["dup"] = _post(base, "/admin/replicas",
                                {"id": "a", "url": rep.url}, key)[0]
            seen["badpid"] = _post(base, "/admin/replicas",
                                   {"url": rep.url, "pid": "x"}, key)[0]
            assert _wait(lambda: r.replica_states() == {"a": "healthy"})
            seen["query"] = _post(base, "/queries.json", {"x": 3})[:2]
            seen["urlless"] = _post(base, "/admin/swap",
                                    {"generation": "g2"}, key)[:2]
            seen["badretire"] = _post(base, "/admin/swap", {
                "url": rep.url, "retire": 5}, key)[0]
            seen["unknown_swap"] = _get(base, "/admin/swap/nope", key)[0]
            seen["delete"] = _get(base, "/admin/replicas/a", key,
                                  method="DELETE")
            seen["delete_unknown"] = _get(base, "/admin/replicas/zz", key,
                                          method="DELETE")[0]
            assert _wait(lambda: r.replica_states() == {})
            st_, listing = _get(base, "/admin/replicas", key)
            seen["listing"] = (st_, [(x["id"], x["state"])
                                     for x in listing["retired"]])
            st_, status = _get(base, "/")
            seen["status"] = (st_, status["service"], status["replicas"],
                              status["swaps"], sorted(status))
        elif name == "history_gc":
            (a,) = mk("a")
            r = _make(p, a)
            assert _wait(lambda: r.replica_states() == {"a": "healthy"})
            for i in range(25):
                with r._lock:
                    r._swaps[f"s{i:02d}"] = {"id": f"s{i:02d}",
                                             "phase": "done"}
                    r._gc_swaps_locked()
            with r._lock:
                r._swaps["active"] = {"id": "active", "phase": "warming"}
                r._gc_swaps_locked()
                seen["kept"] = sorted(r._swaps)
        seen["samples"] = _router_samples(r._registry)
    finally:
        if r is not None:
            r.close()
        if server is not None:
            server.shutdown()
        for rep in reps:
            rep.close()
    return seen


_SCENARIOS = [
    "failover_reset", "both_die_502", "expired_deadline", "passthrough_4xx",
    "all_draining", "one_draining", "shed_failover", "all_saturated",
    "critical_bypass", "forwarded_headers", "open_breaker", "trace",
    "cold_until_warm", "dead_then_back", "no_replicas", "swap_plain",
    "swap_never_warm", "swap_token", "gate_promote", "gate_divergent",
    "gate_nan", "gate_rollback", "gate_batch", "admin_routes",
    "history_gc",
]

#: samples that depend on timing, not on the script
_TIMED = {"pio_router_inflight", "pio_router_requests_total",
          "pio_router_replica_healthy"}


@pytest.mark.parametrize("name", _SCENARIOS)
def test_scripted_signals_alike(name):
    port, jax = _both(_scenario, name)
    for obs in (port, jax):
        for fam in _TIMED:
            obs["samples"].pop(fam, None)
    assert port == jax
    if name == "failover_reset":
        assert port["q"][0] == 200
        assert port["samples"]["pio_router_failovers_total"]
    if name in ("swap_plain", "swap_token"):
        assert port["record"]["phase"] == "done"
    if name == "gate_promote":
        assert port["record"]["phase"] == "done"
        assert port["serving"] == "g2"
    if name in ("gate_divergent", "gate_nan"):
        assert port["record"]["phase"] == "failed"
    if name == "gate_rollback":
        assert port["record"]["phase"] == "rolled_back"
    if name == "admin_routes":
        assert port["nokey"] == 401 and port["dup"] == 409


# -- both routers in front of port engine servers ----------------------------


@pytest.fixture(scope="module")
def engine_pair():
    """Two port engine servers on the CPU over one trained generation."""
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import App, Storage, set_storage
    from predictionio_tpu_torch.models.recommendation import (
        recommendation_engine,
    )
    from predictionio_tpu_torch.parallel.mesh import ComputeContext
    from predictionio_tpu_torch.serving.engine_server import (
        create_engine_server,
    )

    storage = Storage(env={"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    rng = np.random.default_rng(5)
    app_id = storage.get_meta_data_apps().insert(App(0, "shop"))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{i}",
              properties={"rating": int(v)})
        for u, i, v in zip(rng.integers(0, 40, 400), rng.integers(0, 30, 400),
                           rng.integers(1, 6, 400))], app_id)
    engine = recommendation_engine()
    variant = {"datasource": {"params": {"app_name": "shop"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 4, "num_iterations": 2}}]}
    params = engine.params_from_variant(variant)
    ctx = ComputeContext.create(device="cpu")
    set_storage(storage)
    try:
        run_train(engine, params, "router-rec", storage=storage, ctx=ctx)
        servers = [create_engine_server(
            engine, params, "router-rec", host="127.0.0.1", port=0,
            storage=storage, ctx=ctx, registry=MetricRegistry())
            for _ in range(2)]
    finally:
        set_storage(None)
    for _es, h in servers:
        h.start()
    yield [f"http://127.0.0.1:{h.port}" for _es, h in servers]
    for es, h in servers:
        h.shutdown()


def _engine_script(p, urls, seed):
    rng = np.random.default_rng(seed)
    r = p.router.ServingRouter(probe_interval_s=0.05, registry=p.Registry())
    for i, u in enumerate(urls):
        r.add_replica(u, replica_id=f"r{i}", generation="g1")
    server = r.serve(host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    out = []
    try:
        assert _wait(lambda: set(r.replica_states().values())
                     == {"healthy"})
        for _ in range(24):
            kind = rng.integers(0, 5)
            if kind == 0:
                body = [{"user": f"u{int(u)}", "num": 3}
                        for u in rng.integers(0, 45, 3)]
                got = _post(base, "/batch/queries.json", body)
            elif kind == 1:
                got = _post(base, "/queries.json", None, raw=b"[1, 2")
            elif kind == 2:
                got = _post(base, "/queries.json",
                            {"user": f"u{int(rng.integers(0, 45))}",
                             "num": int(rng.integers(1, 6))},
                            {"X-PIO-Affinity": "a"})
            else:
                got = _post(base, "/queries.json",
                            {"user": f"u{int(rng.integers(0, 45))}",
                             "num": int(rng.integers(1, 6))})
            status, body, headers = got
            if isinstance(body, dict):
                body = {k: v for k, v in body.items() if k != "prId"}
            elif isinstance(body, list):
                body = [{k: v for k, v in x.items() if k != "prId"}
                        for x in body]
            out.append((status, body))
        st_, status = _get(base, "/")
        out.append((st_, [(x["id"], x["state"], x["generation"])
                          for x in status["replicas"]],
                    status["servingGeneration"]))
        samples = r._registry.to_dict()
        by_status = {}
        for s in samples["pio_router_requests_total"]["samples"]:
            by_status[s["labels"]["status"]] = by_status.get(
                s["labels"]["status"], 0) + s["value"]
        out.append(("requests_by_status", sorted(by_status.items())))
        out.append(("failovers", _router_samples(r._registry).get(
            "pio_router_failovers_total")))
    finally:
        r.close()
        server.shutdown()
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_routers_answer_one_script_alike(engine_pair, seed):
    port, jax = _both(_engine_script, engine_pair, seed)
    assert port == jax
    statuses = {s for s, *_ in port[:24]}
    assert 200 in statuses and 400 in statuses
