"""Admission control: the port's copy of ``serving/admission.py`` against
the JAX package's, on the same inputs and the same clock.

* the criticality, tenant and ``Retry-After`` helpers give the same
  values for the same headers;
* one seeded sequence of latencies, sheds and clock ticks through both
  ``GradientLimiter``s gives the same limit, EWMA and baseline after
  every step (exactly: both run the same float arithmetic);
* one seeded script of acquires and releases, by class and tenant,
  through both ``AdmissionController``s gives the same admit / refuse
  decisions, statuses, reasons and ``Retry-After`` values, and the same
  shed counters;
* ``from_env`` reads the same ``PIO_ADMISSION_*`` knobs and floor.
"""

from __future__ import annotations

import numpy as np
import pytest

from predictionio_tpu.obs import MetricRegistry as JaxRegistry
from predictionio_tpu.serving import admission as jax_adm
from predictionio_tpu_torch.obs import MetricRegistry
from predictionio_tpu_torch.serving import admission as adm


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("raw", [None, "", "critical", "CRITICAL",
                                 " sheddable ", "default", "bogus", "1"])
def test_parse_criticality_same(raw):
    assert adm.parse_criticality(raw) == jax_adm.parse_criticality(raw)


@pytest.mark.parametrize("seconds", [0.0, 0.01, 0.049, 0.05, 0.051, 0.3,
                                     1.0, 1.2345, 4.9999, 7.0, 120.0])
def test_format_retry_after_same(seconds):
    assert adm.format_retry_after(seconds) == jax_adm.format_retry_after(
        seconds)


@pytest.mark.parametrize("raw", [None, "", "1", "0.25", "2.5", "-1", "x",
                                 "nan", "inf", "Wed, 21 Oct 2015 07:28:00 GMT"])
def test_parse_retry_after_same(raw):
    assert adm.parse_retry_after(raw) == jax_adm.parse_retry_after(raw)


def test_class_tables_and_headers_equal():
    assert adm.CLASS_RANK == jax_adm.CLASS_RANK
    assert adm.CLASS_FRACTION == jax_adm.CLASS_FRACTION
    assert adm.CLASS_FRACTION == {"critical": 1.0, "default": 0.85,
                                  "sheddable": 0.6}
    for name in ("CRITICALITY_HEADER", "TENANT_HEADER", "SHED_HEADER",
                 "DEFAULT", "CRITICAL", "SHEDDABLE"):
        assert getattr(adm, name) == getattr(jax_adm, name)
    assert adm.SHED_HEADER == "X-PIO-Shed"


def test_contextvars_scope_and_reset():
    with adm.criticality("critical"), adm.tenant("t1"):
        assert (adm.get_criticality(), adm.get_tenant()) == (
            "critical", "t1")
    assert (adm.get_criticality(), adm.get_tenant()) == ("default", "")


def _limiter_script(seed: int):
    """(kind, value, clock step) triples: latency samples around a
    moving capacity, with sheds and a window rotation."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(400):
        base = 0.004 if i < 150 else 0.02 if i < 300 else 0.006
        if rng.random() < 0.08:
            steps.append(("drop", 0.0, float(rng.uniform(0.0, 0.2))))
        else:
            steps.append(("sample", float(base * rng.lognormal(0, 0.4)),
                          float(rng.uniform(0.0, 0.3))))
    steps.insert(200, ("sample", float("nan"), 0.0))
    steps.insert(250, ("sample", -1.0, 0.0))
    return steps


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("initial", [4.0, 32.0, 500.0])
def test_gradient_limiter_same_trajectory(seed, initial):
    cfg = dict(initial_limit=initial, min_limit=4.0, max_limit=1024.0,
               baseline_window_s=5.0)
    clocks = (_Clock(), _Clock())
    ours = adm.GradientLimiter(adm.AdmissionConfig(**cfg), clock=clocks[0])
    theirs = jax_adm.GradientLimiter(jax_adm.AdmissionConfig(**cfg),
                                     clock=clocks[1])
    limits = []
    for kind, value, dt in _limiter_script(seed):
        for c in clocks:
            c.t += dt
        for lim in (ours, theirs):
            lim.on_sample(value) if kind == "sample" else lim.on_drop()
        assert ours.limit == theirs.limit
        assert ours.latency_ewma_s == theirs.latency_ewma_s
        assert ours.baseline_s() == theirs.baseline_s()
        limits.append(ours.limit)
    assert (ours.samples, ours.drops) == (theirs.samples, theirs.drops)
    # the script moves the limit both ways
    assert max(limits) > min(limits)


def _controller_script(seed: int):
    rng = np.random.default_rng(seed)
    classes = ["critical", "default", "sheddable", "bogus"]
    tenants = ["", "a", "b", "c", "d", "e", "hot"]
    script = []
    for _ in range(600):
        if rng.random() < 0.55:
            script.append(("acquire", classes[rng.choice(4, p=[.2, .45, .3,
                                                               .05])],
                           tenants[rng.choice(7, p=[.1, .08, .08, .08, .08,
                                                    .08, .5])],
                           0.0))
        else:
            script.append(("release",
                           ["ok", "ok", "ok", "ok", "ok", "ok", "drop",
                            "ignore"][rng.integers(0, 8)],
                           int(rng.integers(0, 1 << 30)),
                           float(0.003 * rng.lognormal(0, 0.6))))
    return script


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_controller_same_decisions(seed):
    cfg = dict(initial_limit=12.0, min_limit=10.0, max_limit=16.0,
               fair_pressure=0.5)
    clocks = (_Clock(), _Clock())
    regs = (MetricRegistry(), JaxRegistry())
    ours = adm.AdmissionController(
        "engine", registry=regs[0], config=adm.AdmissionConfig(**cfg),
        clock=clocks[0])
    theirs = jax_adm.AdmissionController(
        "engine", registry=regs[1], config=jax_adm.AdmissionConfig(**cfg),
        clock=clocks[1])
    held = []  # tenants admitted and not yet released
    outcomes = {"admit": 0, 503: 0, 429: 0}
    for op, a, b, latency in _controller_script(seed):
        for c in clocks:
            c.t += 0.01
        if op == "acquire":
            got = []
            for ctl, mod in ((ours, adm), (theirs, jax_adm)):
                try:
                    ctl.try_acquire(a, b)
                    got.append(("admit",))
                except mod.AdmissionRejected as rej:
                    got.append((rej.status, rej.reason, rej.criticality,
                                rej.retry_after_s,
                                mod.format_retry_after(rej.retry_after_s)))
            assert got[0] == got[1]
            outcomes[got[0][0]] += 1
            if got[0][0] == "admit":
                held.append(b)
        elif held:
            # a seeded pick among the requests in flight
            tenant = held.pop(b % len(held))
            ours.release(latency, a, tenant)
            theirs.release(latency, a, tenant)
        assert ours.inflight == theirs.inflight
        assert ours.limiter.limit == theirs.limiter.limit
        assert ours.retry_after_s() == theirs.retry_after_s()
        assert ours.retry_after_header() == theirs.retry_after_header()
    # the script reaches every verdict
    assert outcomes["admit"] and outcomes[503] and outcomes[429]
    for reg in regs:
        text = reg.render_prometheus()
        assert "pio_admission_shed_total" in text
    shed = [
        sorted((k, v.value) for k, v in
               reg.counter("pio_admission_shed_total", "",
                           ("service", "class", "reason"))._children.items())
        for reg in regs
    ]
    assert shed[0] == shed[1]


def test_class_fractions_shed_sheddable_first():
    """At a limit of 20: sheddable is refused past 12 in flight, default
    past 17, critical only past 20, in both packages."""
    for mod in (adm, jax_adm):
        ctl = mod.AdmissionController(
            "engine", registry=(MetricRegistry() if mod is adm
                                else JaxRegistry()),
            config=mod.AdmissionConfig(initial_limit=20.0, min_limit=20.0,
                                       max_limit=20.0))
        admitted = {}
        for cls in ("sheddable", "default", "critical"):
            n = 0
            while True:
                try:
                    ctl.try_acquire(cls)
                    n += 1
                except mod.AdmissionRejected as rej:
                    assert rej.status == 503 and rej.reason == "limit"
                    break
            admitted[cls] = n
        assert admitted == {"sheddable": 12, "default": 5, "critical": 3}


@pytest.mark.parametrize("env", [
    {},
    {"PIO_ADMISSION": "0"},
    {"PIO_ADMISSION": "off"},
    {"PIO_ADMISSION_INITIAL": "8", "PIO_ADMISSION_MIN": "2",
     "PIO_ADMISSION_MAX": "99", "PIO_ADMISSION_TOLERANCE": "0.5",
     "PIO_ADMISSION_SMOOTHING": "5", "PIO_ADMISSION_DECREASE": "0.01",
     "PIO_ADMISSION_WINDOW_S": "bad", "PIO_ADMISSION_FAIR_PRESSURE": "0.3"},
])
@pytest.mark.parametrize("floor", [None, 2.0, 192.0])
def test_from_env_same(monkeypatch, env, floor):
    for k in list(__import__("os").environ):
        if k.startswith("PIO_ADMISSION"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = adm.AdmissionController.from_env(
        "engine", registry=MetricRegistry(), min_limit=floor)
    theirs = jax_adm.AdmissionController.from_env(
        "engine", registry=JaxRegistry(), min_limit=floor)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert vars(ours.config) == vars(theirs.config)
        assert ours.limiter.limit == theirs.limiter.limit
