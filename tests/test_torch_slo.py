"""SLO scoring: the port's copy of ``obs/slo.py`` against the JAX
package's, on the same requests and the same clock.

* ``objectives_from_env`` reads the same ``PIO_SLO_*`` knobs;
* one seeded stream of (class, status, latency, clock step) through both
  monitors gives the same burn rates in both windows, the same budget
  left and the same snapshot after every step, and the same
  ``pio_slo_requests_total`` counts (exactly: both run the same float
  arithmetic);
* ``ingest`` (the router's side) agrees the same way, and the page
  alert lands on the timeline at the same step;
* the port's HTTP tier scores each served request into its monitor:
  a 2xx under the threshold is good, a 429, a 5xx or a slow 2xx bad,
  and the telemetry routes are not scored.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.obs import MetricRegistry as JaxRegistry
from predictionio_tpu.obs import slo as jax_slo
from predictionio_tpu.obs import timeline as jax_timeline
from predictionio_tpu_torch.obs import MetricRegistry, Objective, SLOMonitor
from predictionio_tpu_torch.obs import slo
from predictionio_tpu_torch.obs import timeline
from predictionio_tpu_torch.serving.http import (
    HTTPError,
    HTTPServer,
    Response,
    Router,
    install_metrics_routes,
)


@pytest.mark.parametrize("env", [
    {},
    {"PIO_SLO_CRITICAL_AVAILABILITY": "0.9999",
     "PIO_SLO_DEFAULT_LATENCY_MS": "40", "PIO_SLO_SHEDDABLE_LATENCY_MS": "x"},
    {"PIO_SLO_DEFAULT_AVAILABILITY": "1.5"},
])
def test_objectives_from_env_same(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = slo.objectives_from_env()
    theirs = jax_slo.objectives_from_env()
    assert {k: (o.availability, o.latency_s, o.error_budget)
            for k, o in ours.items()} == {
        k: (o.availability, o.latency_s, o.error_budget)
        for k, o in theirs.items()}


def _stream(seed: int):
    rng = np.random.default_rng(seed)
    classes = ["critical", "default", "sheddable", "unknown"]
    statuses = [200, 200, 200, 200, 201, 400, 404, 429, 500, 503, 504]
    out = []
    for _ in range(1500):
        out.append((classes[rng.choice(4, p=[.2, .5, .25, .05])],
                    int(statuses[rng.integers(0, len(statuses))]),
                    float(rng.lognormal(np.log(0.2), 1.0)),
                    float(rng.exponential(0.4))))
    return out


def _monitors(clock, **kw):
    regs = (MetricRegistry(), JaxRegistry())
    return regs, (
        SLOMonitor(regs[0], clock=clock, **kw),
        jax_slo.SLOMonitor(regs[1], clock=clock, **kw),
    )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("windows", [(60.0, 600.0), (5.0, 30.0),
                                     (120.0, 20.0)])
def test_burn_rates_same_stream(seed, windows):
    now = [1000.0]
    regs, (ours, theirs) = _monitors(
        lambda: now[0], short_window_s=windows[0], long_window_s=windows[1])
    for cls, status, latency, dt in _stream(seed):
        now[0] += dt
        ours.observe(cls, status, latency)
        theirs.observe(cls, status, latency)
        for c in slo.CLASSES:
            for w in slo.WINDOWS:
                assert ours.burn_rate(c, w) == theirs.burn_rate(c, w)
            assert ours.budget_remaining(c) == theirs.budget_remaining(c)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.max_burn_rate("long") == theirs.max_burn_rate("long")
    counts = [
        sorted((k, c.value) for k, c in reg.counter(
            "pio_slo_requests_total", "", ("class", "outcome")
        )._children.items())
        for reg in regs
    ]
    assert counts[0] == counts[1]
    assert {k[1] for k, _ in counts[0]} == {"good", "bad"}


def test_ingest_and_page_alert_alike():
    now = [50.0]
    ours_tl, theirs_tl = timeline.Timeline(), jax_timeline.Timeline()
    old = (timeline.set_timeline(ours_tl), jax_timeline.set_timeline(theirs_tl))
    try:
        _, (ours, theirs) = _monitors(lambda: now[0], short_window_s=10.0,
                                      long_window_s=60.0)
        script = [(c, g, b) for c in ("critical", "default", "x")
                  for g, b in ((100, 0), (90, 10), (0, 50), (500, 0),
                               (0.0, 0.0), (200, 1))]
        for i, (cls, good, bad) in enumerate(script):
            now[0] += 3.0
            ours.ingest(cls, good, bad)
            theirs.ingest(cls, good, bad)
            assert ours.snapshot() == theirs.snapshot()
            kinds = [[(e["kind"], e.get("class")) for e in tl.events()]
                     for tl in (ours_tl, theirs_tl)]
            assert kinds[0] == kinds[1], i
        assert any(k == "slo_burn_alert" for k, _ in kinds[0])
    finally:
        timeline.set_timeline(old[0])
        jax_timeline.set_timeline(old[1])


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def test_http_tier_scores_served_requests():
    import time as _time

    router = Router()
    router.route("GET", "/ok", lambda r: Response(200, {}))
    router.route("GET", "/slow",
                 lambda r: (_time.sleep(0.6), Response(200, {}))[1])

    def fail(r):
        raise HTTPError(int(r.query["s"]), "no")

    router.route("GET", "/fail", fail)
    registry = MetricRegistry()
    install_metrics_routes(router, registry)
    monitor = SLOMonitor(registry, objectives={
        c: Objective(0.99, 0.5) for c in slo.CLASSES})
    http = HTTPServer(router, host="127.0.0.1", port=0, registry=registry,
                      slo=monitor)
    http.start()
    base = f"http://127.0.0.1:{http.port}"
    try:
        assert http.slo is monitor
        for path, cls in (("/ok", "critical"), ("/ok", "sheddable"),
                          ("/slow", "default"), ("/fail?s=429", "default"),
                          ("/fail?s=503", "critical"),
                          ("/fail?s=404", "sheddable")):
            _get(base + path, {"X-PIO-Criticality": cls})
        for path in ("/metrics", "/healthz", "/metrics.json"):
            assert _get(base + path) == 200
        counts = {k: c.value for k, c in registry.counter(
            "pio_slo_requests_total", "", ("class", "outcome")
        )._children.items()}
        assert counts == {("critical", "good"): 1.0,
                          ("critical", "bad"): 1.0,
                          ("sheddable", "good"): 2.0,
                          ("default", "bad"): 2.0}
        text = json.loads(urllib.request.urlopen(
            base + "/metrics.json", timeout=10).read())
        assert "pio_slo_burn_rate" in text
    finally:
        http.shutdown()
    off = HTTPServer(router, host="127.0.0.1", port=0,
                     registry=MetricRegistry(), slo=False)
    assert off.slo is None
    off.shutdown()
