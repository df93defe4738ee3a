"""Observability in the port against the JAX package, on the CPU.

* The metric registry: one sequence of counter, gauge and histogram
  operations (labels, both bucket sets, values drawn from a seed with
  numpy) renders byte-equal Prometheus text in both packages, and equal
  ``to_dict()`` output with the derived quantiles within 1e-12; the
  default registries carry the same process families.
* The tracer and the timeline: the same nested spans, attributes,
  errors and ``X-Parent-Span`` parents give equal span trees and equal
  ``chrome_trace`` events once span ids and the clock are made the same
  (both modules' ``new_span_id`` and ``now`` are replaced by one
  counter); the ring, flight recorder and open-trace caps agree; the
  timeline ring keeps the same events at the same capacity and the
  merge is equal.
* ``redact_keys`` and ``sanitize_id`` give equal outputs, ``log_json``
  equal lines; ``StepTimer.publish`` gives equal histograms.
* Over HTTP: both event servers count the same ingest into
  ``pio_events_ingested_total`` and ``pio_http_requests_total``, mount
  the same telemetry routes, and record the same ``store/*`` spans under
  a root whose trace id is the request id and whose parent is
  ``X-Parent-Span``; the telemetry routes are not traced.
* ``run_train`` on a small recommendation engine writes
  ``PIO_TRACE_DIR/pio_train_<id>.trace.json`` with the same span names
  and parent links as the JAX package's (its ``jax.profiler`` wrapper is
  replaced by a no-op here; the port's ``torch.profiler`` trace is
  written beside it), a failed run too.
* ``utils/profiling``: ``trace`` writes a non-empty Chrome trace,
  ``capture`` the JAX package's artifact layout (``torch_trace/`` in
  place of ``jax_trace/``), ``bundle`` a tar of it.
"""

import contextlib
import itertools
import json
import logging
import os
import tarfile
import io
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.core import workflow as jax_workflow
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import (
    AccessKey as JaxAccessKey,
    App as JaxApp,
    Storage as JaxStorage,
    set_storage as jax_set_storage,
)
from predictionio_tpu.models.recommendation import (
    recommendation_engine as jax_rec_engine,
)
from predictionio_tpu.obs import context as jax_context
from predictionio_tpu.obs import registry as jax_registry
from predictionio_tpu.obs import timeline as jax_timeline
from predictionio_tpu.obs import tracing as jax_tracing
from predictionio_tpu.serving.event_server import (
    create_event_server as jax_create_event_server,
)
from predictionio_tpu.utils import profiling as jax_profiling
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import (
    AccessKey,
    App,
    Storage,
    set_storage,
)
from predictionio_tpu_torch.models.recommendation import recommendation_engine
from predictionio_tpu_torch.obs import context, registry, timeline, tracing
from predictionio_tpu_torch.obs.device import CompileTracker, DeviceSampler
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving.event_server import create_event_server
from predictionio_tpu_torch.utils import profiling

QUANTILE_TOL = 1e-12


# -- the registry --------------------------------------------------------------


def _drive_registry(reg_mod, seed: int):
    """One seeded sequence of metric operations on a private registry."""
    rng = np.random.default_rng(seed)
    reg = reg_mod.MetricRegistry()
    c = reg.counter("pio_t_requests_total", "requests", ("route", "status"))
    plain = reg.counter("pio_t_plain_total", "no labels")
    g = reg.gauge("pio_t_depth", "depth", ("queue",))
    fn = reg.gauge("pio_t_fn", "scrape-time")
    lat = reg.histogram("pio_t_latency_seconds", "latency", ("route",))
    steps = reg.histogram("pio_t_step_seconds", "steps", ("step",),
                          buckets=reg_mod.TRAIN_STEP_BUCKETS)
    odd = reg.histogram("pio_t_odd", 'help with "quotes"\\n',
                        buckets=(3.0, 0.5, 1.0))
    routes = ["/a", "/b.json", 'we"ird\\route\n']
    for _ in range(200):
        r = routes[int(rng.integers(0, len(routes)))]
        c.labels(r, str(int(rng.choice([200, 201, 400, 500])))).inc(
            float(rng.integers(1, 4)))
        lat.labels(r).observe(float(rng.lognormal(-4.0, 2.0)))
        steps.labels(f"s{int(rng.integers(0, 3))}").observe(
            float(rng.lognormal(1.0, 3.0)))
        odd.observe(float(rng.uniform(0, 4)))
        g.labels(queue=r).set(float(rng.normal()))
    plain.inc(2.5)
    g.labels("q").inc(3)
    g.labels("q").dec(0.25)
    fn.set_function(lambda: 41.5)
    reg.histogram("pio_t_empty", "never observed", ("x",)).labels("y")
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_renders_byte_equal_prometheus_text(seed):
    got = _drive_registry(registry, seed).render_prometheus()
    want = _drive_registry(jax_registry, seed).render_prometheus()
    assert got == want


def _close_dicts(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _close_dicts(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close_dicts(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=0, abs=QUANTILE_TOL), path
    else:
        assert got == want, path


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_to_dict_equal_with_quantiles(seed):
    got = _drive_registry(registry, seed).to_dict()
    want = _drive_registry(jax_registry, seed).to_dict()
    _close_dicts(got, want)
    # the quantiles are there, not None, where observations were made
    lat = got["pio_t_latency_seconds"]["samples"][0]
    assert lat["p50"] is not None and lat["p99"] >= lat["p50"]


@pytest.mark.parametrize("q", [0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999])
def test_histogram_percentile_equal(q):
    rng = np.random.default_rng(5)
    values = rng.lognormal(-3.0, 2.5, 500)
    out = []
    for mod in (registry, jax_registry):
        h = mod.MetricRegistry().histogram("h", "", ())
        for v in values:
            h.observe(float(v))
        out.append(h.percentile(q))
    assert abs(out[0] - out[1]) <= QUANTILE_TOL


def test_registry_refusals_match():
    for mod in (registry, jax_registry):
        reg = mod.MetricRegistry()
        reg.counter("x_total", "", ("a",))
        with pytest.raises(ValueError):
            reg.gauge("x_total", "", ("a",))
        with pytest.raises(ValueError):
            reg.counter("x_total", "", ("b",))
        with pytest.raises(ValueError):
            reg.counter("x_total", "", ("a",)).inc()
        with pytest.raises(ValueError):
            reg.counter("y_total").inc(-1)
        with pytest.raises(ValueError):
            reg.histogram("h", buckets=())


def test_default_registries_carry_the_same_process_families():
    got = registry.get_registry().to_dict()
    want = jax_registry.get_registry().to_dict()
    process = {
        "pio_build_info", "pio_process_start_time_seconds",
        "pio_process_resident_bytes", "pio_process_open_fds",
    }
    assert process <= set(got) and process <= set(want)
    for name in process:
        assert got[name]["type"] == want[name]["type"]
        assert got[name]["help"] == want[name]["help"]
    from predictionio_tpu_torch.version import __version__

    (build,) = got["pio_build_info"]["samples"]
    assert build == {"labels": {"version": __version__}, "value": 1.0}


def test_bucket_sets_equal():
    assert registry.LATENCY_BUCKETS == jax_registry.LATENCY_BUCKETS
    assert registry.TRAIN_STEP_BUCKETS == jax_registry.TRAIN_STEP_BUCKETS
    assert registry.OCCUPANCY_BUCKETS == jax_registry.OCCUPANCY_BUCKETS


# -- the tracer ----------------------------------------------------------------


@pytest.fixture()
def same_clock(monkeypatch):
    """Both tracing modules draw span ids and times from one counter
    each, reset per package run, so two runs of the same operations
    give the same ids and times."""

    def install():
        ids = itertools.count(1)
        ticks = itertools.count(1)
        for mod in (tracing, jax_tracing):
            monkeypatch.setattr(mod, "new_span_id",
                                lambda: f"s{next(ids):04d}")
            monkeypatch.setattr(mod, "now",
                                lambda: 1.7e9 + next(ticks) * 0.001)

    return install


def _drive_tracer(trace_mod, **tracer_kw):
    t = trace_mod.Tracer(**tracer_kw)
    with t.trace("root", trace_id="req-1", parent_id="remote.span:9",
                 attributes={"service": "svc", "n": 3}) as root:
        root.set("route", "/x")
        with trace_mod.span("store/a", appId=1) as a:
            a.set("rows", [1, 2, {"k": (3, 4)}])
            with trace_mod.span("inner"):
                pass
        with pytest.raises(KeyError):
            with trace_mod.span("store/b", events=50):
                raise KeyError("boom")
        assert trace_mod.current_span() is root
    assert trace_mod.current_span() is None
    assert trace_mod.span("off-trace") is trace_mod.NOOP
    with t.trace("second", trace_id="req-2"):
        with trace_mod.span("child", obj=object):
            pass
    # a record whose root is gone is dropped
    orphan = trace_mod.Span(t, "req-3", "orphan", trace_key="nope")
    t.record(orphan)
    return t


def test_span_trees_equal(same_clock):
    same_clock()
    got = _drive_tracer(tracing).to_dict()
    same_clock()
    want = _drive_tracer(jax_tracing).to_dict()
    assert got == want
    (first, second) = got["traces"]
    assert first["traceId"] == "req-1"
    root = [s for s in first["spans"] if s["name"] == "root"][0]
    assert root["parentId"] == "remote.span:9"
    by_name = {s["name"]: s for s in first["spans"]}
    assert by_name["inner"]["parentId"] == by_name["store/a"]["spanId"]
    assert by_name["store/b"]["attributes"]["error"] == "KeyError: 'boom'"


def test_chrome_trace_events_equal(same_clock):
    same_clock()
    t = _drive_tracer(tracing)
    got = (t.chrome_trace(), t.chrome_trace("req-2"))
    same_clock()
    jt = _drive_tracer(jax_tracing)
    want = (jt.chrome_trace(), jt.chrome_trace("req-2"))
    assert got == want
    assert {e["name"] for e in got[1]["traceEvents"]} == {
        "process_name", "second", "child"}


@pytest.mark.parametrize("kw", [
    dict(max_traces=2, flight_slots=1),
    dict(max_spans_per_trace=2),
    dict(max_open_traces=1),
    dict(enabled=False),
])
def test_tracer_bounds_equal(same_clock, kw):
    def drive(trace_mod):
        t = trace_mod.Tracer(**kw)
        for i in range(4):
            with t.trace(f"r{i}", trace_id=f"t{i}"):
                for j in range(i + 1):
                    with trace_mod.span(f"c{j}"):
                        pass
        # two roots open at once: the open-trace cap abandons the oldest
        outer = t.trace("outer", trace_id="o")
        inner = t.trace("inner", trace_id="i")
        outer.__enter__() if outer is not trace_mod.NOOP else None
        inner.__enter__() if inner is not trace_mod.NOOP else None
        if inner is not trace_mod.NOOP:
            inner.__exit__(None, None, None)
            outer.__exit__(None, None, None)
        return t.to_dict(), t.chrome_trace()

    same_clock()
    got = drive(tracing)
    same_clock()
    want = drive(jax_tracing)
    assert got == want


@pytest.mark.parametrize("raw", [
    None, "", "abc", "A-b_c.d:e", "x" * 128, "x" * 129, "bad id",
    "new\nline", "é", "0123456789abcdef", "span;drop", "a/b",
])
def test_sanitize_id_equal(raw):
    assert tracing.sanitize_id(raw) == jax_tracing.sanitize_id(raw)


def test_parent_span_header_equal():
    assert tracing.PARENT_SPAN_HEADER == jax_tracing.PARENT_SPAN_HEADER
    assert context.ID_OK.pattern == jax_context.ID_OK.pattern


# -- context -------------------------------------------------------------------


@pytest.mark.parametrize("line", [
    "GET /events.json?accessKey=abc123&limit=5",
    "POST /events.json?limit=1&accessKey=k-e_y.1 HTTP/1.1",
    '"accessKey=quoted"',
    "no key here",
    "/a?accessKey=one&accessKey=two b",
    "accessKey=",
])
def test_redact_keys_equal(line):
    assert context.redact_keys(line) == jax_context.redact_keys(line)


def test_redact_keys_equal_on_seeded_strings():
    rng = np.random.default_rng(9)
    alphabet = np.array(list("ab=&? \"accessKey/x1"))
    for _ in range(300):
        s = "".join(rng.choice(alphabet, int(rng.integers(0, 40))))
        assert context.redact_keys(s) == jax_context.redact_keys(s)


@pytest.mark.parametrize("raw", [None, "", "fine-id", "bad id", "x" * 200])
def test_set_request_id_equal_acceptance(raw):
    got = context.set_request_id(raw)
    want = jax_context.set_request_id(raw)
    if raw and jax_context.ID_OK.match(raw):
        assert got == want == raw
    else:
        # both mint a fresh 16-hex id
        assert len(got) == len(want) == 16 and got != raw
    assert context.get_request_id() == got


def test_log_json_equal(caplog, monkeypatch):
    lines = {}
    for name, mod in (("torch", context), ("jax", jax_context)):
        monkeypatch.setattr(mod.time, "time", lambda: 1234.56789)
        mod.set_request_id("rid-1")
        logger = logging.getLogger(f"obs-parity-{name}")
        with caplog.at_level(logging.INFO, logger=logger.name):
            caplog.clear()
            mod.log_json(logger, logging.INFO, "evt", event="shadow",
                         ts=1, requestId="spoof", ok=True, n=[1, 2])
            mod.log_json(logger, logging.DEBUG, "dropped", x=1)
            lines[name] = [r.getMessage() for r in caplog.records]
    assert lines["torch"] == lines["jax"]
    assert json.loads(lines["torch"][0])["requestId"] == "rid-1"


# -- the timeline --------------------------------------------------------------


def _drive_timeline(mod):
    reg = (registry if mod is timeline else jax_registry).MetricRegistry()
    # the ambient request id is captured when an emitter passes none
    (context if mod is timeline else jax_context).set_request_id("amb-1")
    tl = mod.Timeline(4, registry=reg)
    for i in range(7):
        tl.record("kind_a" if i % 2 else "kind_b", f"message {i}",
                  severity=["info", "warn", "error", "bogus"][i % 4],
                  tenant="t" if i == 3 else "", generation=i,
                  request_id="r" if i == 5 else None, extra=i * 2)
    out = tl.to_dict()
    for e in out["events"]:
        e.pop("mono"), e.pop("wall")
    return out, reg.render_prometheus()


def test_timeline_ring_equal():
    got = _drive_timeline(timeline)
    want = _drive_timeline(jax_timeline)
    assert got == want
    assert got[0]["capacity"] == 4 and got[0]["dropped"] == 3


def test_timeline_merge_equal():
    rng = np.random.default_rng(4)
    payloads = []
    for r in range(3):
        events = [
            {"kind": "k", "message": f"{r}-{i}", "seq": i + 1,
             "wall": float(rng.integers(0, 5))}
            for i in range(5)
        ]
        payloads.append((f"rep{r}", {"dropped": r, "events": events}))
    payloads.append(("never-scraped", None))
    payloads.append(("junk", {"events": ["not a dict"]}))
    for limit in (None, 0, 4, 100):
        got = timeline.merge_timelines(payloads, limit=limit)
        want = jax_timeline.merge_timelines(payloads, limit=limit)
        assert got == want


def test_timeline_env_capacity_and_global(monkeypatch):
    monkeypatch.setenv("PIO_TIMELINE_CAPACITY", "3")
    assert timeline.Timeline().to_dict()["capacity"] == 3
    assert jax_timeline.Timeline().to_dict()["capacity"] == 3
    monkeypatch.setenv("PIO_TIMELINE_CAPACITY", "junk")
    assert timeline.Timeline().to_dict()["capacity"] == (
        jax_timeline.DEFAULT_CAPACITY)
    mine = timeline.Timeline(2)
    previous = timeline.set_timeline(mine)
    try:
        assert timeline.get_timeline() is mine
    finally:
        timeline.set_timeline(previous)


# -- StepTimer.publish, the device sampler, compile tracking --------------------


def test_step_timer_publish_equal():
    rng = np.random.default_rng(3)
    records = {f"step{i}": rng.lognormal(0.0, 3.0, 20).tolist()
               for i in range(3)}
    texts = []
    for prof, reg_mod in ((profiling, registry),
                          (jax_profiling, jax_registry)):
        timer = prof.StepTimer()
        for name, xs in records.items():
            for x in xs:
                timer.record(name, x)
        reg = reg_mod.MetricRegistry()
        timer.publish(reg)
        timer.publish(reg, name="pio_other_seconds")
        texts.append(reg.render_prometheus())
        assert timer.summary().keys() == records.keys()
    assert texts[0] == texts[1]


def test_step_timer_steps_are_spans_inside_a_trace_only():
    timer = profiling.StepTimer()
    with timer.step("off-trace"):
        pass
    t = tracing.Tracer()
    with t.trace("run", trace_id="run-1"):
        with timer.step("train/total"):
            with timer.step("als/user_solve"):
                pass
    (rec,) = t.to_dict()["traces"]
    names = {s["name"]: s for s in rec["spans"]}
    assert set(names) == {"run", "train/total", "als/user_solve"}
    assert names["als/user_solve"]["parentId"] == (
        names["train/total"]["spanId"])
    assert len(timer.records["off-trace"]) == 1


def test_device_sampler_publishes_nothing_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = registry.MetricRegistry()
    sampler = DeviceSampler(reg, interval_s=0.05)
    assert sampler.sample_once() == {}
    text = reg.render_prometheus()
    assert 'pio_device_hbm_used_bytes{' not in text
    sampler.start()
    sampler.stop()


def test_device_sampler_gauges_equal_from_one_sample():
    sample = {"devices": {"cuda:0": {"used": 5.0, "limit": 80.0},
                          "cuda:1": {"used": 1.0, "limit": None}},
              "liveArrayBytes": 3.0}
    from predictionio_tpu.obs.device import DeviceSampler as JaxSampler

    texts = []
    for sampler_cls, reg_mod in ((DeviceSampler, registry),
                                 (JaxSampler, jax_registry)):
        reg = reg_mod.MetricRegistry()
        s = sampler_cls(reg, interval_s=0.05, sample_fn=lambda: sample)
        s.start()
        s.stop()
        assert s.last_sample() == sample
        texts.append(reg.to_dict())
    # the help strings name each package's own device API
    for name in ("pio_device_hbm_used_bytes", "pio_device_hbm_limit_bytes",
                 "pio_device_live_array_bytes"):
        assert texts[0][name]["samples"] == texts[1][name]["samples"]


def test_compile_tracker_equal():
    from predictionio_tpu.obs.device import CompileTracker as JaxTracker

    texts = []
    for tracker_cls, reg_mod in ((CompileTracker, registry),
                                 (JaxTracker, jax_registry)):
        reg = reg_mod.MetricRegistry()
        tr = tracker_cls(reg)
        seen = [tr.record(site, sig) for site, sig in
                [("a", (1, 2)), ("a", (1, 2)), ("a", (1, 3)), ("b", "x")]]
        texts.append((seen, reg.render_prometheus()))
    assert texts[0] == texts[1]


# -- over HTTP: the event servers -----------------------------------------------


KEY = "obs-parity-key"


def _event_storage(storage_cls, app_cls, key_cls):
    storage = storage_cls(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
    })
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "obs"))
    storage.get_events().init(app_id)
    storage.get_meta_data_access_keys().insert(key_cls(KEY, app_id))
    return storage


def _request(url, method="GET", body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _ingest_script():
    rng = np.random.default_rng(21)
    batch = [
        {"event": "rate", "entityType": "user", "entityId": f"u{u}",
         "targetEntityType": "item", "targetEntityId": f"i{i}",
         "properties": {"rating": int(r)}}
        for u, i, r in zip(rng.integers(0, 9, 12), rng.integers(0, 5, 12),
                           rng.integers(1, 6, 12))
    ]
    batch[3] = {"event": "rate"}  # invalid: 400 inside the batch
    return [
        ("POST", f"/batch/events.json?accessKey={KEY}", batch),
        ("POST", f"/events.json?accessKey={KEY}", batch[0]),
        ("POST", "/events.json", batch[0]),  # no key: 401
        ("POST", f"/events.json?accessKey={KEY}", {"event": ""}),  # 400
        ("GET", f"/events.json?accessKey={KEY}&limit=3", None),
        ("GET", f"/events/nope.json?accessKey={KEY}", None),  # 404
        ("DELETE", f"/events/nope.json?accessKey={KEY}", None),  # 404
    ]


@pytest.fixture(scope="module")
def event_servers():
    """Both packages' event servers, each on its own private registry
    and tracer, after the same ingest script."""
    from predictionio_tpu.obs import (
        MetricRegistry as JaxRegistry,
        Tracer as JaxTracer,
    )

    regs = {"torch": registry.MetricRegistry(), "jax": JaxRegistry()}
    tracers = {"torch": tracing.Tracer(), "jax": JaxTracer()}
    servers = {
        "torch": create_event_server(
            host="127.0.0.1", port=0,
            storage=_event_storage(Storage, App, AccessKey),
            registry=regs["torch"], tracer=tracers["torch"]),
        "jax": jax_create_event_server(
            host="127.0.0.1", port=0,
            storage=_event_storage(JaxStorage, JaxApp, JaxAccessKey),
            registry=regs["jax"], tracer=tracers["jax"]),
    }
    statuses = {}
    for name, server in servers.items():
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        statuses[name] = [
            _request(base + path, method, body)[0]
            for method, path, body in _ingest_script()
        ]
        # one request joins a distributed trace
        statuses[name].append(_request(
            base + f"/batch/events.json?accessKey={KEY}", "POST",
            [{"event": "view", "entityType": "user", "entityId": "u1"}],
            headers={"X-Request-ID": "client-req-7",
                     "X-Parent-Span": "client.span:1"})[0])
        for path in ("/metrics", "/metrics.json", "/debug/traces",
                     "/debug/traces.json", "/debug/timeline.json",
                     "/healthz"):
            statuses[name].append(_request(base + path)[0])
    yield {"servers": servers, "regs": regs, "tracers": tracers,
           "statuses": statuses}
    for server in servers.values():
        server.shutdown()


def test_event_servers_answer_alike(event_servers):
    st = event_servers["statuses"]
    assert st["torch"] == st["jax"]
    assert st["torch"][-6:] == [200] * 6


@pytest.mark.parametrize("family", [
    "pio_events_ingested_total", "pio_http_requests_total",
])
def test_event_server_counters_equal(event_servers, family):
    got = event_servers["regs"]["torch"].to_dict()[family]
    want = event_servers["regs"]["jax"].to_dict()[family]
    key = lambda s: sorted(s["labels"].items())  # noqa: E731
    assert sorted(got["samples"], key=key) == sorted(want["samples"],
                                                     key=key)
    assert got["type"] == want["type"] and got["help"] == want["help"]


def test_event_server_latency_routes_equal(event_servers):
    def routes(reg):
        fam = reg.to_dict()["pio_http_request_seconds"]
        return sorted((tuple(sorted(s["labels"].items())), s["count"])
                      for s in fam["samples"])

    assert routes(event_servers["regs"]["torch"]) == routes(
        event_servers["regs"]["jax"])


def test_inflight_gauge_registered(event_servers):
    for name in ("torch", "jax"):
        fam = event_servers["regs"][name].to_dict()[
            "pio_http_inflight_requests"]
        assert fam["samples"][0]["labels"] == {"service": "eventserver"}


def _span_shape(tracer):
    """Per retained trace: root name, its parent, and the (name, parent
    name) pairs of its spans; the telemetry routes must not appear."""
    out = []
    for rec in tracer.to_dict()["traces"]:
        names = {s["spanId"]: s["name"] for s in rec["spans"]}
        root = [s for s in rec["spans"] if s["spanId"] == rec["rootSpanId"]]
        out.append((
            rec["root"], root[0]["parentId"],
            rec["traceId"] if rec["traceId"] == "client-req-7" else "*",
            root[0]["attributes"]["route"], root[0]["attributes"]["status"],
            sorted((s["name"], names.get(s["parentId"], s["parentId"]))
                   for s in rec["spans"] if s["spanId"] != rec["rootSpanId"]),
        ))
    return out


def test_event_server_span_trees_equal(event_servers):
    got = _span_shape(event_servers["tracers"]["torch"])
    want = _span_shape(event_servers["tracers"]["jax"])
    assert got == want
    joined = [t for t in got if t[2] == "client-req-7"]
    assert joined and joined[0][1] == "client.span:1"
    assert ("store/insert_batch", "eventserver POST") in joined[0][5]
    assert all(not t[3].startswith(("/metrics", "/debug")) for t in got)


def test_event_server_metrics_text_names_the_same_families(event_servers):
    def families(server):
        _, body = _request(f"http://127.0.0.1:{server.port}/metrics")
        return {line.split()[2] for line in body.decode().splitlines()
                if line.startswith("# TYPE")}

    got = families(event_servers["servers"]["torch"])
    want = families(event_servers["servers"]["jax"])
    # admission, drain and SLO scoring are on in both servers
    assert {"pio_events_ingested_total", "pio_http_requests_total",
            "pio_http_request_seconds", "pio_http_inflight_requests",
            "pio_http_rejected_total", "pio_server_draining",
            "pio_admission_limit"} <= got & want
    assert got == want


def test_request_id_forwarded_or_minted(event_servers):
    server = event_servers["servers"]["torch"]
    base = f"http://127.0.0.1:{server.port}"
    for sent, kept in (("abc-1", True), ("bad id!", False)):
        req = urllib.request.Request(base + "/", headers={
            "X-Request-ID": sent})
        with urllib.request.urlopen(req, timeout=10) as resp:
            rid = resp.headers["X-Request-ID"]
        assert (rid == sent) == kept and tracing.sanitize_id(rid)


# -- the training trace -----------------------------------------------------------

N_USERS, N_ITEMS, N_EVENTS, RANK = 30, 20, 300, 4


def _rate_events(event_cls):
    rng = np.random.default_rng(17)
    return [
        event_cls(event="rate", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}",
                  properties={"rating": int(r)})
        for u, i, r in zip(rng.integers(0, N_USERS, N_EVENTS),
                           rng.integers(0, N_ITEMS, N_EVENTS),
                           rng.integers(1, 6, N_EVENTS))
    ]


def _train_storage(storage_cls, app_cls, event_cls, model_dir, app="obs"):
    storage = storage_cls(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(model_dir),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    })
    app_id = storage.get_meta_data_apps().insert(app_cls(0, app))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(_rate_events(event_cls), app_id)
    return storage


def _trace_links(path):
    events = json.loads(open(path).read())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    names = {e["args"]["spanId"]: e["name"] for e in spans}
    return sorted(
        (e["name"], names.get(e["args"]["parentId"]))
        for e in spans
    )


def _train_both(tmp_path, monkeypatch, app="obs"):
    """Both packages' run_train, with PIO_TRACE_DIR set and checkpoints
    every epoch; returns each trace directory and instance id."""
    monkeypatch.setattr(jax_workflow, "trace", contextlib.nullcontext)
    variant = {
        "datasource": {"params": {"app_name": app}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "num_iterations": 3}}],
    }
    out = {}
    for name in ("torch", "jax"):
        trace_dir = tmp_path / f"traces-{name}"
        monkeypatch.setenv("PIO_TRACE_DIR", str(trace_dir))
        if name == "torch":
            storage = _train_storage(Storage, App, Event,
                                     tmp_path / "m-torch", app)
            engine = recommendation_engine()
            set_storage(storage)
            try:
                iid = run_train(
                    engine, engine.params_from_variant(variant), "rec",
                    ctx=ComputeContext.create(device="cpu"),
                    storage=storage, checkpoint_dir=str(tmp_path / "ck-t"),
                    checkpoint_every=1)
            finally:
                set_storage(None)
        else:
            storage = _train_storage(JaxStorage, JaxApp, JaxEvent,
                                     tmp_path / "m-jax", app)
            engine = jax_rec_engine()
            jax_set_storage(storage)
            try:
                iid = jax_run_train(
                    engine, engine.params_from_variant(variant), "rec",
                    storage=storage, checkpoint_dir=str(tmp_path / "ck-j"),
                    checkpoint_every=1)
            finally:
                jax_set_storage(None)
        out[name] = (trace_dir, iid)
    return out


def test_run_train_trace_file_matches_jax(tmp_path, monkeypatch):
    runs = _train_both(tmp_path, monkeypatch)
    links = {}
    for name, (trace_dir, iid) in runs.items():
        path = trace_dir / f"pio_train_{iid}.trace.json"
        assert path.exists(), sorted(os.listdir(trace_dir))
        links[name] = _trace_links(path)
    assert links["torch"] == links["jax"]
    names = {n for n, _ in links["torch"]}
    assert {"pio_train", "train/total", "als/checkpoint",
            "train/persist_model"} <= names
    assert ("als/checkpoint", "train/total") in links["torch"]
    assert ("train/persist_model", "pio_train") in links["torch"]
    # the port's profiler trace sits beside it, non-empty
    torch_dir = runs["torch"][0]
    (prof,) = [p for p in os.listdir(torch_dir) if p.startswith("torch_")]
    trace = json.loads((torch_dir / prof).read_text())
    assert trace["traceEvents"]


def test_run_train_publishes_step_histogram_and_checkpoints(
    tmp_path, monkeypatch
):
    reg = registry.get_registry()
    before = reg.counter("pio_train_checkpoints_total",
                         "Mid-training factor checkpoints written (atomic "
                         "npz; resume picks up the latest after a "
                         "crash)").value
    _train_both(tmp_path, monkeypatch, app="obs2")
    after = reg.to_dict()
    assert after["pio_train_checkpoints_total"]["samples"][0]["value"] == (
        before + 2)  # iterations 1 and 2 of 3
    steps = {s["labels"]["step"]
             for s in after["pio_train_step_seconds"]["samples"]}
    assert {"train/total", "als/user_solve", "als/item_solve"} <= steps


def test_failed_run_still_writes_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TRACE_DIR", str(tmp_path / "traces"))
    storage = Storage(env={"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    storage.get_meta_data_apps().insert(App(0, "empty"))
    engine = recommendation_engine()
    set_storage(storage)
    try:
        with pytest.raises(Exception):
            run_train(engine, engine.params_from_variant(
                {"datasource": {"params": {"app_name": "empty"}}}), "rec",
                ctx=ComputeContext.create(device="cpu"), storage=storage)
    finally:
        set_storage(None)
    (instance,) = storage.get_meta_data_engine_instances().get_all()
    assert instance.status == "FAILED"
    path = tmp_path / "traces" / f"pio_train_{instance.id}.trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    root = [e for e in events if e["name"] == "pio_train"]
    assert root and "error" in root[0]["args"]


# -- profiling: trace, capture, bundle ----------------------------------------------


def test_trace_is_transparent_without_a_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("PIO_TRACE_DIR", raising=False)
    with profiling.trace():
        pass
    monkeypatch.setenv("PIO_TRACE_DIR", str(tmp_path / "env"))
    import torch

    with profiling.trace():
        torch.ones(8).sum()
    with profiling.trace(str(tmp_path / "explicit")):
        torch.ones(8).sum()
    for sub in ("env", "explicit"):
        (f,) = os.listdir(tmp_path / sub)
        assert f.startswith("torch_") and f.endswith(".trace.json")
        assert json.loads((tmp_path / sub / f).read_text())["traceEvents"]


def test_capture_layout_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_profiling, "trace",
                        lambda d: contextlib.nullcontext())
    t = tracing.Tracer()
    with t.trace("req", trace_id="cap"):
        pass
    got = profiling.capture(0.01, tracer=t, out_dir=str(tmp_path / "t"),
                            device_sample_fn=lambda: {"devices": {}})
    want = jax_profiling.capture(0.01, out_dir=str(tmp_path / "j"),
                                 device_sample_fn=lambda: {"devices": {}})
    assert set(got) == set(want)
    assert sorted(f.replace("torch_trace", "jax_trace")
                  for f in got["files"]) == want["files"]
    art = got["artifactDir"]
    assert sorted(os.listdir(art)) == sorted(
        f.rstrip("/") for f in got["files"])
    spans = json.loads(open(os.path.join(art, "spans.json")).read())
    assert any(e["name"] == "req" for e in spans["traceEvents"])
    blob = profiling.bundle(art)
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tar:
        names = tar.getnames()
    assert os.path.basename(art) + "/manifest.json" in names
