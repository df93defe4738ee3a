"""Fleet metrics federation: the port's copy of ``obs/federation.py``
against the JAX package's.

* ``merge_histogram_samples``, ``merge_payloads``, ``combine_families``,
  ``render_prometheus_families`` and ``counter_total`` give equal output
  on hypothesis-drawn replica registries (counters, gauges and
  histograms, with labels, NaN observations and NaN gauges), each
  registry built alike in both packages, and on each package's payloads
  fed to the other's merge;
* the cases of the JAX package's ``tests/test_federation.py``
  (``TestMergeFunctions``), run through both modules;
* each package's router federates the same replica servers alike: the
  merged fleet view, the ``replica`` label in the Prometheus text, a
  dead replica's last snapshot marked stale, fleet SLO deltas ingested
  once, the burn rate in the autoscaler's signals, device-memory
  headroom in ``fleet_health``, and both metrics routes and ``GET /``
  over HTTP.
"""

from __future__ import annotations

import json
import math
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from predictionio_tpu.obs import MetricRegistry as JaxRegistry
from predictionio_tpu.obs import federation as jax_fed
from predictionio_tpu.obs import timeline as jax_timeline
from predictionio_tpu.obs.slo import SLOMonitor as JaxSLO
from predictionio_tpu.serving import http as jax_http
from predictionio_tpu.serving.router import ServingRouter as JaxRouter
from predictionio_tpu_torch.obs import MetricRegistry
from predictionio_tpu_torch.obs import federation as fed
from predictionio_tpu_torch.obs import timeline
from predictionio_tpu_torch.obs.slo import SLOMonitor
from predictionio_tpu_torch.serving import http
from predictionio_tpu_torch.serving.router import ServingRouter

PKGS = {
    "jax": SimpleNamespace(Registry=JaxRegistry, fed=jax_fed, SLO=JaxSLO,
                           http=jax_http, Router=JaxRouter,
                           timeline=jax_timeline),
    "port": SimpleNamespace(Registry=MetricRegistry, fed=fed, SLO=SLOMonitor,
                            http=http, Router=ServingRouter,
                            timeline=timeline),
}


def _canon(value) -> str:
    """A comparable rendering: NaN equals NaN, float keys stay keys."""
    return json.dumps(value, sort_keys=True, default=str)


# -- drawn registries --------------------------------------------------------

_LABELS = st.sampled_from(["a", "b", "c"])
_OBS = st.one_of(st.floats(min_value=0.0, max_value=20.0),
                 st.just(float("nan")))
_FAMILY = st.tuples(
    st.sampled_from(["counter", "gauge", "histogram"]),
    st.integers(0, 2),  # label count
    st.lists(st.tuples(st.tuples(_LABELS, _LABELS), _OBS),
             min_size=0, max_size=6),
)
#: replica registries: families by name (the same name always has the same
#: kind and label names, as across one fleet's replicas)
_FLEET = st.lists(
    st.dictionaries(st.sampled_from(["f0", "f1", "f2", "f3"]), _FAMILY,
                    max_size=4),
    min_size=1, max_size=3)


def _build(Registry, families: dict, kinds: dict):
    reg = Registry()
    for name, (_kind, n_labels, ops) in sorted(families.items()):
        kind, n_labels = kinds[name]
        labels = ("x", "y")[:n_labels]
        fam_name = f"t_{name}_{kind}"
        if kind == "counter":
            fam = reg.counter(fam_name, "h", labels)
        elif kind == "gauge":
            fam = reg.gauge(fam_name, "h", labels)
        else:
            fam = reg.histogram(fam_name, "h", labels,
                                buckets=(0.1, 0.5, 1.0, 5.0))
        for values, v in ops:
            child = fam.labels(*values[:n_labels]) if n_labels else fam
            if kind == "counter":
                child.inc(0.0 if math.isnan(v) else v)
            elif kind == "gauge":
                child.set(v)
            else:
                child.observe(v)
    return reg.to_dict()


def _payloads(fleet: list, Registry) -> dict:
    kinds = {}
    for families in fleet:
        for name, (kind, n_labels, _ops) in families.items():
            kinds.setdefault(name, (kind, n_labels))
    return {f"r{i}": _build(Registry, families, kinds)
            for i, families in enumerate(fleet)}


@settings(max_examples=60, deadline=None)
@given(fleet=_FLEET)
def test_drawn_registries_merge_alike(fleet):
    jax_payloads = _payloads(fleet, JaxRegistry)
    port_payloads = _payloads(fleet, MetricRegistry)
    assert _canon(port_payloads) == _canon(jax_payloads)
    merged = fed.merge_payloads(port_payloads)
    assert _canon(merged) == _canon(jax_fed.merge_payloads(jax_payloads))
    # each package's merge of the other's payloads
    assert _canon(fed.merge_payloads(jax_payloads)) == _canon(merged)
    local = _build(MetricRegistry, fleet[0], {
        n: (k, c) for n, (k, c, _o) in fleet[0].items()})
    combined = fed.combine_families(local, port_payloads)
    assert _canon(combined) == _canon(
        jax_fed.combine_families(local, jax_payloads))
    assert fed.render_prometheus_families(combined) == (
        jax_fed.render_prometheus_families(combined))
    for name, family in merged.items():
        assert family["type"] in ("counter", "histogram")
        if family["type"] == "counter":
            for label in ("a", "b", "c", None):
                kw = {} if label is None else {"x": label}
                assert fed.counter_total(merged, name, **kw) == (
                    jax_fed.counter_total(merged, name, **kw))


@settings(max_examples=40, deadline=None)
@given(groups=st.lists(st.lists(_OBS, min_size=1, max_size=12), min_size=1,
                      max_size=4),
       drop_inf=st.booleans())
def test_drawn_histogram_samples_merge_alike(groups, drop_inf):
    samples = []
    for obs in groups:
        reg = MetricRegistry()
        h = reg.histogram("t_seconds", buckets=(0.1, 0.5, 1.0, 5.0))
        for v in obs:
            h.observe(v)
        sample = reg.to_dict()["t_seconds"]["samples"][0]
        if drop_inf:  # a snapshot from before the +Inf bucket was kept
            sample["buckets"] = {k: v for k, v in sample["buckets"].items()
                                 if k != "+Inf"}
        samples.append(sample)
    assert _canon(fed.merge_histogram_samples(samples)) == _canon(
        jax_fed.merge_histogram_samples(samples))


# -- the JAX package's merge cases, through both modules --------------------


def _registry_payload(Registry, observations, counter_incs=0):
    reg = Registry()
    hist = reg.histogram("t_seconds", buckets=(0.1, 0.5, 1.0, 5.0))
    for value in observations:
        hist.observe(value)
    c = reg.counter("t_total")
    if counter_incs:
        c.inc(counter_incs)
    return reg.to_dict()


def _case_histogram_union(p):
    xs = [0.05] * 40 + [0.3] * 30 + [0.7] * 5
    ys = [0.05] * 10 + [0.9] * 10 + [4.0] * 4 + [9.0]
    a = _registry_payload(p.Registry, xs)["t_seconds"]["samples"][0]
    b = _registry_payload(p.Registry, ys)["t_seconds"]["samples"][0]
    union = _registry_payload(p.Registry, xs + ys)["t_seconds"]["samples"][0]
    merged = p.fed.merge_histogram_samples([a, b])
    assert merged["count"] == union["count"] == len(xs) + len(ys)
    assert merged["buckets"] == union["buckets"]
    for q in ("p50", "p95", "p99"):
        assert merged[q] == union[q]
    assert merged["sum"] == pytest.approx(sum(xs) + sum(ys))
    return merged


def _case_missing_inf_bucket(p):
    a = _registry_payload(p.Registry, [0.05, 9.0, 9.0])["t_seconds"][
        "samples"][0]
    legacy = dict(a)
    legacy["buckets"] = {k: v for k, v in a["buckets"].items()
                         if k != "+Inf"}
    merged = p.fed.merge_histogram_samples([legacy])
    assert merged["buckets"]["+Inf"] == 2 and merged["count"] == 3
    return merged


def _case_counters_sum_gauges_drop(p):
    payloads = {
        "r0": _registry_payload(p.Registry, [0.1], counter_incs=3),
        "r1": _registry_payload(p.Registry, [0.2], counter_incs=4),
    }
    for payload in payloads.values():
        payload["t_gauge"] = {"type": "gauge",
                              "samples": [{"labels": {}, "value": 7.0}]}
    merged = p.fed.merge_payloads(payloads)
    assert merged["t_total"]["samples"][0]["value"] == 7.0
    assert "t_gauge" not in merged
    assert merged["t_seconds"]["samples"][0]["count"] == 2
    return merged


def _case_label_sets(p):
    def payload(route_counts):
        reg = p.Registry()
        c = reg.counter("t_total", "h", ("route",))
        for route, n in route_counts.items():
            c.labels(route).inc(n)
        return reg.to_dict()

    merged = p.fed.merge_payloads({"r0": payload({"a": 1, "b": 10}),
                                   "r1": payload({"a": 2})})
    assert {s["labels"]["route"]: s["value"]
            for s in merged["t_total"]["samples"]} == {"a": 3.0, "b": 10.0}
    return merged


def _case_replica_label(p):
    local = p.Registry()
    local.counter("r_total").inc(5)
    combined = p.fed.combine_families(
        local.to_dict(),
        {"r0": _registry_payload(p.Registry, [], counter_incs=2)})
    sample = combined["t_total"]["samples"][0]
    assert sample["labels"][p.fed.REPLICA_LABEL] == "r0"
    assert p.fed.REPLICA_LABEL not in combined["r_total"]["samples"][0][
        "labels"]
    return combined


def _case_render(p):
    combined = p.fed.combine_families({}, {
        "r0": _registry_payload(p.Registry, [0.05, 0.3], counter_incs=1),
        "r1": _registry_payload(p.Registry, [0.7], counter_incs=2),
    })
    text = p.fed.render_prometheus_families(combined)
    assert text.count("# TYPE t_total counter") == 1
    assert text.count("# TYPE t_seconds histogram") == 1
    assert 't_total{replica="r0"} 1' in text
    assert 't_seconds_bucket{le="+Inf",replica="r0"} 2' in text
    assert 't_seconds_count{replica="r1"} 1' in text
    return text


def _case_counter_total(p):
    reg = p.Registry()
    c = reg.counter("t_total", "h", ("outcome",))
    c.labels("good").inc(6)
    c.labels("bad").inc(2)
    fams = reg.to_dict()
    got = (p.fed.counter_total(fams, "t_total"),
           p.fed.counter_total(fams, "t_total", outcome="good"),
           p.fed.counter_total(fams, "missing_total"))
    assert got == (8.0, 6.0, 0.0)
    return got


_MERGE_CASES = {
    "histogram_merge_equals_union": _case_histogram_union,
    "histogram_merge_reconstructs_missing_inf_bucket":
        _case_missing_inf_bucket,
    "counter_merge_sums_and_gauges_drop": _case_counters_sum_gauges_drop,
    "counter_merge_respects_label_sets": _case_label_sets,
    "combine_families_injects_replica_label": _case_replica_label,
    "render_prometheus_families": _case_render,
    "counter_total_filters_labels": _case_counter_total,
}


@pytest.mark.parametrize("case", sorted(_MERGE_CASES))
def test_merge_cases_alike(case):
    fn = _MERGE_CASES[case]
    assert _canon(fn(PKGS["port"])) == _canon(fn(PKGS["jax"]))


# -- routers federating live replica servers ---------------------------------


class _MetricReplica:
    """A replica-shaped server of one package on a real registry, so each
    router federates genuine snapshots."""

    def __init__(self, p, name):
        self.name = name
        self.registry = p.Registry()
        self.requests = self.registry.counter("r_requests_total", "h",
                                              ("route",))
        self.latency = self.registry.histogram("r_seconds",
                                               buckets=(0.1, 0.5, 1.0))
        self.slo = p.SLO(self.registry, short_window_s=60.0,
                         long_window_s=600.0)
        self.timeline = p.timeline.Timeline(capacity=64)
        router = p.http.Router()
        router.route("GET", "/metrics.json", lambda r: p.http.Response(
            200, self.registry.to_dict()))
        router.route("GET", "/debug/timeline.json",
                     lambda r: p.http.Response(200, self.timeline.to_dict()))
        self.server = p.http.HTTPServer(router, host="127.0.0.1", port=0,
                                        service=f"rep-{name}")
        self.server.start()
        self.url = f"http://127.0.0.1:{self.server.port}"

    def set_hbm(self, used, limit):
        self.registry.gauge("pio_device_hbm_used_bytes", "h",
                            ("device",)).labels("cuda:0").set(used)
        self.registry.gauge("pio_device_hbm_limit_bytes", "h",
                            ("device",)).labels("cuda:0").set(limit)

    def close(self):
        self.server.shutdown()


def _get(url: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _fleet_script(p, name):
    """One scripted federation run against package ``p``; what it saw."""
    a, b = _MetricReplica(p, "a"), _MetricReplica(p, "b")
    a.requests.labels("q").inc(3)
    b.requests.labels("q").inc(4)
    a.latency.observe(0.05)
    b.latency.observe(0.3)
    b.latency.observe(0.7)
    router = p.Router(probe_interval_s=999.0, registry=p.Registry())
    for rep in (a, b):
        router.add_replica(rep.url, replica_id=rep.name)
    seen = {}
    try:
        if name == "federated_dict":
            data = router.federated_dict()
            seen = {"federation": data["federation"], "fleet": data["fleet"],
                    "perReplica": data["perReplica"],
                    "local_has_healthy": "pio_router_replica_healthy"
                    in data["local"]}
        elif name == "federated_text":
            text = router.federated_text()
            seen = {
                "a": 'r_requests_total{replica="a",route="q"} 3' in text,
                "b": 'r_requests_total{replica="b",route="q"} 4' in text,
                "types": text.count("# TYPE r_requests_total counter"),
                "rollups": ["pio_fleet_goodput_qps" in text,
                            "pio_fleet_replicas" in text],
            }
        elif name == "dead_replica_stale":
            first = router.federated_dict()["federation"]
            b.close()
            second = router.federated_dict()
            seen = {"first": first, "second": second["federation"],
                    "total": p.fed.counter_total(
                        second["fleet"], "r_requests_total", route="q"),
                    "stale": {s["labels"]["replica"]: s["value"]
                              for s in second["local"][
                                  "pio_federation_stale"]["samples"]}}
        elif name == "slo_deltas_once":
            for _ in range(9):
                a.slo.observe("default", 200, 0.01)
            a.slo.observe("default", 500, 0.01)
            router.federated_dict()
            router.federated_dict()
            counts = router._fleet_slo._window_counts("default", 60.0)
            router._slo_seen["a"][("default", "good")] = 100.0
            a.slo.observe("default", 200, 0.01)
            router.federated_dict()
            seen = {"once": counts, "after_reset":
                    router._fleet_slo._window_counts("default", 60.0)}
        elif name == "burn_in_signals":
            a.slo.ingest("sheddable", good=0.0, bad=50.0)
            router.federated_dict()
            signals = router.autoscaler_signals()
            seen = {"burning": signals["burnRate"] > 1.0,
                    "signals": {k: signals[k] for k in (
                        "healthy", "warming", "shedTotal", "swapActive",
                        "servingGeneration", "generationAmbiguous")}}
        elif name == "hbm_headroom":
            a.set_hbm(600.0, 1000.0)
            for replica in list(router._replicas.values()):
                router._probe_one(replica)
            health = router.fleet_health()
            rep = dict(health["replicas"]["a"])
            rep.pop("residentBytes", None)
            seen = {"a": rep, "keys": sorted(health)}
        elif name == "routes":
            server = router.serve(host="127.0.0.1", port=0)
            server.start()
            try:
                base = f"http://127.0.0.1:{server.port}"
                status, body = _get(base + "/metrics.json")
                data = json.loads(body)
                status2, text = _get(base + "/metrics")
                status3, body3 = _get(base + "/")
                root = json.loads(body3)
                seen = {"json": (status, data["federation"],
                                 p.fed.counter_total(data["fleet"],
                                                     "r_requests_total")),
                        "text": (status2,
                                 b'r_requests_total{replica="a"' in text),
                        "root": (status3, root["service"],
                                 "burnRate" in root["fleetHealth"])}
            finally:
                server.shutdown()
    finally:
        router.close()
        a.close()
        b.close()
    return seen


_FLEET_CASES = ["federated_dict", "federated_text", "dead_replica_stale",
                "slo_deltas_once", "burn_in_signals", "hbm_headroom",
                "routes"]


@pytest.mark.parametrize("name", _FLEET_CASES)
def test_routers_federate_alike(name):
    port = _fleet_script(PKGS["port"], name)
    jax = _fleet_script(PKGS["jax"], name)
    assert _canon(port) == _canon(jax)
    assert port  # each script saw something
    if name == "federated_dict":
        assert fed.counter_total(port["fleet"], "r_requests_total",
                                 route="q") == 7.0
        assert port["fleet"]["r_seconds"]["samples"][0]["count"] == 3
    if name == "dead_replica_stale":
        assert port["second"]["stale"] == ["b"] and port["total"] == 7.0
        assert port["stale"] == {"a": 0.0, "b": 1.0}
    if name == "slo_deltas_once":
        assert port["once"] == (9.0, 1.0)
        assert port["after_reset"][0] == 19.0
    if name == "hbm_headroom":
        assert port["a"]["hbmHeadroomBytes"] == 400.0
    if name == "routes":
        assert port["json"][2] == 7.0 and port["root"][1] == "router"
