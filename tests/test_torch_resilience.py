"""Resilience primitives: the port's copy of ``serving/resilience.py``
against the JAX package's, on the same inputs and the same clock.

* ``X-PIO-Deadline``: the same header values parse to the same budgets
  (``time.monotonic`` pinned), round-trip through ``to_header``, cap and
  reserve alike, and the contextvar scopes per context;
* ``RetryPolicy``: the same env gives the same policy, and one seed the
  same delays and the same sleep-or-stop decisions under a deadline;
* ``CircuitBreaker``: one script of allow / success / failure / release
  under one fake clock gives the same states, verdicts and transition
  counters;
* ``ChaosMiddleware``: one ``PIO_CHAOS`` spec and seed give the same
  injection sequence (kind per request), and bad specs fail alike;
* ``DrainState`` and ``drain_grace_s``.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np
import pytest

from predictionio_tpu.obs import MetricRegistry as JaxRegistry
from predictionio_tpu.serving import resilience as jax_res
from predictionio_tpu_torch.obs import MetricRegistry
from predictionio_tpu_torch.serving import resilience as res


@pytest.fixture()
def frozen_clock(monkeypatch):
    now = [5000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    return now


@pytest.mark.parametrize("raw", [None, "", "0", "-5", "1", "50", "250.5",
                                 "1e3", "99999999", "abc", "nan", "inf",
                                 "-inf", " 75 "])
def test_deadline_header_parses_alike(frozen_clock, raw):
    ours = res.Deadline.from_header(raw)
    theirs = jax_res.Deadline.from_header(raw)
    assert (ours is None) == (theirs is None)
    if ours is None:
        return
    assert ours.expires_mono == theirs.expires_mono
    assert ours.expired == theirs.expired
    assert ours.to_header() == theirs.to_header()
    # the budget left travels on to the next hop: parsing to_header()
    # gives the same budget in both packages, at most 1 ms less (whole
    # milliseconds, truncated)
    again = res.Deadline.from_header(ours.to_header())
    again_j = jax_res.Deadline.from_header(theirs.to_header())
    assert again.expires_mono == again_j.expires_mono
    assert 0 <= int(ours.to_header()) - int(again.to_header()) <= 1
    frozen_clock[0] += 0.02
    assert ours.to_header() == theirs.to_header()
    assert ours.expired == theirs.expired
    for timeout in (0.0005, 0.01, 5.0):
        assert ours.cap(timeout) == theirs.cap(timeout)
    for hold in (0.001, 0.01, 0.1):
        assert ours.reserved(hold).expires_mono == theirs.reserved(
            hold).expires_mono


def test_deadline_header_name_and_contextvar():
    assert res.DEADLINE_HEADER == jax_res.DEADLINE_HEADER == "X-PIO-Deadline"
    assert res.get_deadline() is None
    d = res.Deadline.after(1.0)
    res.set_deadline(d)
    try:
        seen = []
        t = threading.Thread(target=lambda: seen.append(res.get_deadline()))
        t.start()
        t.join()
        assert res.get_deadline() is d and seen == [None]
    finally:
        res.set_deadline(None)


@pytest.mark.parametrize("env", [
    {},
    {"PIO_RETRY_MAX_ATTEMPTS": "5", "PIO_RETRY_BASE_MS": "10",
     "PIO_RETRY_MULTIPLIER": "3", "PIO_RETRY_MAX_MS": "200",
     "PIO_RETRY_JITTER": "0.9"},
    {"PIO_RETRY_MAX_ATTEMPTS": "0", "PIO_RETRY_JITTER": "7"},
])
@pytest.mark.parametrize("seed", [0, 7])
def test_retry_policy_same_delays(monkeypatch, env, seed):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, theirs = res.RetryPolicy.from_env(), jax_res.RetryPolicy.from_env()
    assert vars(ours) == vars(theirs)
    r1, r2 = random.Random(seed), random.Random(seed)
    assert [ours.backoff_s(a, r1) for a in range(8)] == [
        theirs.backoff_s(a, r2) for a in range(8)]


def test_retry_sleep_decisions_alike(frozen_clock, monkeypatch):
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    policy = dict(max_attempts=4, base_backoff_s=0.1, multiplier=2.0,
                  max_backoff_s=1.0, jitter=0.5)
    ours, theirs = res.RetryPolicy(**policy), jax_res.RetryPolicy(**policy)
    for budget in (None, 0.05, 0.2, 10.0):
        got, sleeps = [], []
        for mod, pol in ((res, ours), (jax_res, theirs)):
            rng = random.Random(3)
            d = None if budget is None else mod.Deadline.after(budget)
            got.append([pol.sleep_before_retry(a, d, rng) for a in range(5)])
            sleeps.append(list(slept))
            slept.clear()
        assert got[0] == got[1] and sleeps[0] == sleeps[1]


def _breaker_script(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(300):
        ops.append((["allow", "success", "failure", "release", "tick"][
            rng.choice(5, p=[.35, .15, .3, .05, .15])],
            float(rng.uniform(0.0, 4.0))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg", [(3, 5.0, 1), (1, 0.0, 2), (5, 2.0, 1)])
def test_breaker_transitions_alike(seed, cfg):
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    regs = (MetricRegistry(), JaxRegistry())
    failures, reset_s, half = cfg
    ours = res.CircuitBreaker(
        "store:1", res.BreakerConfig(failures, reset_s, half),
        registry=regs[0], clock=clock)
    theirs = jax_res.CircuitBreaker(
        "store:1", jax_res.BreakerConfig(failures, reset_s, half),
        registry=regs[1], clock=clock)
    states = set()
    for op, dt in _breaker_script(seed):
        if op == "tick":
            now[0] += dt
            continue
        outs = [getattr(b, {"allow": "allow", "success": "record_success",
                            "failure": "record_failure",
                            "release": "release"}[op])()
                for b in (ours, theirs)]
        assert outs[0] == outs[1]
        assert ours.state == theirs.state
        states.add(ours.state)
    assert states == {"closed", "open", "half_open"} or cfg[1] == 0.0
    trans = [
        sorted((k, c.value) for k, c in reg.counter(
            "pio_breaker_transitions_total", "", ("target", "to")
        )._children.items())
        for reg in regs
    ]
    assert trans[0] == trans[1]


def test_get_breaker_is_per_target():
    res.reset_breakers()
    try:
        a = res.get_breaker("h:1", registry=MetricRegistry())
        assert res.get_breaker("h:1") is a
        assert res.get_breaker("h:2", registry=MetricRegistry()) is not a
    finally:
        res.reset_breakers()


@pytest.mark.parametrize("spec", [
    "latency:p=0.3,ms=0;error:p=0.2;reset:p=0.1",
    "error:p=0.5,status=502;partition:p=0.25,ms=0",
    "latency:p=1,ms=0;error:p=0.05",
    "reset:p=0",
])
@pytest.mark.parametrize("seed", [0, 11, 12345])
def test_chaos_same_injection_sequence(monkeypatch, spec, seed):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    monkeypatch.setenv("PIO_CHAOS", spec)
    monkeypatch.setenv("PIO_CHAOS_SEED", str(seed))
    regs = (MetricRegistry(), JaxRegistry())
    ours = res.ChaosMiddleware.from_env(regs[0])
    theirs = jax_res.ChaosMiddleware.from_env(regs[1])
    assert ours.rules == [res._ChaosRule(**vars(r)) for r in theirs.rules]

    def run(mw, mod):
        seq = []
        for i in range(200):
            try:
                mw.apply(f"/queries.json?{i}")
                seq.append("pass")
            except mod.ChaosError as e:
                seq.append(f"error:{e.status}")
            except mod.ChaosPartition:
                seq.append("partition")
            except mod.ChaosReset:
                seq.append("reset")
        return seq

    assert run(ours, res) == run(theirs, jax_res)
    injected = [
        sorted((k, c.value) for k, c in reg.counter(
            "pio_chaos_injected_total", "", ("fault",))._children.items())
        for reg in regs
    ]
    assert injected[0] == injected[1]


@pytest.mark.parametrize("spec", ["", "boom:p=1", "error:p=2",
                                  "error:ms=3", "latency:p=0.1,x=1",
                                  "error:p=abc", ";;"])
def test_chaos_bad_specs_fail_alike(spec):
    outcomes = []
    for mod in (res, jax_res):
        try:
            outcomes.append(("ok", len(mod.ChaosMiddleware.parse(spec))))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1] and outcomes[0][0] == "error"


def test_chaos_off_without_env(monkeypatch):
    monkeypatch.delenv("PIO_CHAOS", raising=False)
    assert res.ChaosMiddleware.from_env(MetricRegistry()) is None


@pytest.mark.parametrize("raw", [None, "2.5", "0", "bad"])
def test_drain_grace_and_state(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("PIO_DRAIN_GRACE_S", raising=False)
    else:
        monkeypatch.setenv("PIO_DRAIN_GRACE_S", raw)
    assert res.drain_grace_s() == jax_res.drain_grace_s()
    state = res.DrainState()
    state.begin_request()
    state.begin_request()
    state.end_request()
    assert state.inflight == 1 and not state.draining.is_set()
