"""Canary promotion: the port's copy of ``serving/canary.py`` against the
JAX package's.

* ``divergence``, ``contains_nan`` and ``strip_volatile`` agree on
  seeded recommendation-shaped predictions (equal, re-ranked, rescored,
  truncated, NaN, wrong types) and on hypothesis-made JSON values;
* ``CanaryConfig.from_env`` reads the same ``PIO_CANARY_*`` knobs;
* the gate: the same observations and the same shadow answers give the
  same verdict (promote, reject on divergence, on NaN, on a model
  exception; no verdict on dropped shadows), the same reason and the
  same counts in ``to_dict``;
* the watch after promotion: the same served requests give the same
  verdict (stable, rollback on errors, rollback on latency);
* the engine servers' ``/canary`` state names are the same.
"""

from __future__ import annotations

import math
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from predictionio_tpu.obs import MetricRegistry as JaxRegistry
from predictionio_tpu.serving import canary as jax_canary
from predictionio_tpu_torch.obs import MetricRegistry
from predictionio_tpu_torch.serving import canary


def _prediction(rng, n=10, items=200):
    idx = rng.choice(items, size=n, replace=False)
    scores = np.sort(rng.normal(3.0, 1.0, n))[::-1]
    return {"itemScores": [{"item": f"i{int(i)}", "score": float(s)}
                           for i, s in zip(idx, scores)]}


def _variants(seed):
    rng = np.random.default_rng(seed)
    base = _prediction(rng)
    scores = base["itemScores"]
    yield base, base
    yield base, {"itemScores": [
        {**e, "score": e["score"] * (1 + 1e-3 * rng.normal())}
        for e in scores]}
    yield base, {"itemScores": scores[1:] + scores[:1]}
    yield base, {"itemScores": scores[:5]}
    yield base, {"itemScores": [{**scores[0], "score": float("nan")}]
                 + scores[1:]}
    yield base, {"itemScores": [{**e, "score": float("-inf")}
                                for e in scores]}
    yield base, {"itemScores": scores, "prId": "abc", "generation": 7}
    yield base, {"other": 1}
    yield base, [1, 2, 3]
    yield 3.5, 3.0
    yield "a", "a"
    yield None, {"itemScores": []}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_divergence_nan_and_strip_alike(seed):
    for old, new in _variants(seed):
        assert canary.divergence(old, new) == jax_canary.divergence(old, new)
        assert canary.contains_nan(new) == jax_canary.contains_nan(new)
        assert canary.strip_volatile(new) == jax_canary.strip_volatile(new)
        d = canary.divergence(canary.strip_volatile(old),
                              canary.strip_volatile(new))
        assert 0.0 <= d <= 1.0


_json = st.recursive(
    st.none() | st.booleans() | st.integers(-1000, 1000)
    | st.floats(allow_nan=True, allow_infinity=True) | st.text(max_size=5),
    lambda kids: st.lists(kids, max_size=4)
    | st.dictionaries(st.text(max_size=5), kids, max_size=4),
    max_leaves=16,
)


@settings(max_examples=300, deadline=None)
@given(old=_json, new=_json)
def test_divergence_of_any_json_alike(old, new):
    ours, theirs = canary.divergence(old, new), jax_canary.divergence(old, new)
    assert ours == theirs or (math.isnan(ours) and math.isnan(theirs))
    assert canary.contains_nan(new) == jax_canary.contains_nan(new)


@pytest.mark.parametrize("env", [
    {},
    {"PIO_CANARY_SAMPLE": "1", "PIO_CANARY_MIN_SHADOW": "5",
     "PIO_CANARY_MAX_DIVERGENCE": "0.2", "PIO_CANARY_WATCH_MIN_REQUESTS": "3",
     "PIO_CANARY_WATCH_S": "0", "PIO_CANARY_LATENCY_FACTOR": "1.5",
     "PIO_CANARY_ERROR_RATE": "0.5", "PIO_CANARY_SHADOW_TIMEOUT_S": "2"},
    {"PIO_CANARY_SAMPLE": "x", "PIO_CANARY_MIN_SHADOW": ""},
])
def test_config_from_env_alike(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert vars(canary.CanaryConfig.from_env()) == vars(
        jax_canary.CanaryConfig.from_env())
    assert (canary.IDLE, canary.SHADOWING, canary.WATCHING, canary.STABLE,
            canary.REJECTED, canary.ROLLED_BACK) == (
        jax_canary.IDLE, jax_canary.SHADOWING, jax_canary.WATCHING,
        jax_canary.STABLE, jax_canary.REJECTED, jax_canary.ROLLED_BACK)


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


def _gate(mod, registry, kind, seed):
    """Run one canary through its gate. ``kind`` picks what the shadow
    path answers. Returns (verdict, reason, to_dict)."""
    rng = np.random.default_rng(seed)
    cfg = mod.CanaryConfig(shadow_sample=1.0, min_shadow=12,
                           max_divergence=0.05, watch_min_requests=5,
                           watch_s=0.0)
    olds = [_prediction(rng) for _ in range(12)]
    news = {}
    for i, old in enumerate(olds):
        scores = old["itemScores"]
        if kind == "same":
            news[i] = old
        elif kind == "noise":
            news[i] = {"itemScores": [
                {**e, "score": e["score"] * (1 + 1e-3 * rng.normal())}
                for e in scores]}
        elif kind == "diverged":
            news[i] = {"itemScores": scores[::-1]}
        elif kind == "nan":
            news[i] = ({"itemScores": [{**scores[0], "score": float("nan")}]
                        + scores[1:]} if i == 7 else old)
        else:
            news[i] = old
    calls = []

    def shadow_fn(q):
        calls.append(q["i"])
        if kind == "exception" and q["i"] == 4:
            raise ValueError("bad row")
        if kind == "dropped":
            raise mod.ShadowDropped()
        return news[q["i"]]

    can = mod.ShadowCanary({"gen": 2}, config=cfg, registry=registry,
                           shadow_fn=shadow_fn)
    for i, old in enumerate(olds):
        can.observe({"i": i}, old, 0.01 + 0.001 * i, ok=True)
    _wait(lambda: len(calls) == len(olds))
    _wait(lambda: can.to_dict()["shadowSamples"]
          + can.to_dict()["shadowExceptions"] >= len(olds)
          or kind in ("dropped", "exception", "nan"))
    _wait(lambda: can._decision is not None or kind == "dropped", 2.0)
    decision = can.take_decision()
    out = can.to_dict()
    can.close()
    return decision, can.reason, out


@pytest.mark.parametrize("kind, verdict", [
    ("same", "promote"), ("noise", "promote"), ("diverged", "reject"),
    ("nan", "reject"), ("exception", "reject"), ("dropped", None)])
@pytest.mark.parametrize("seed", [0, 5])
def test_gate_verdicts_alike(kind, verdict, seed):
    ours = _gate(canary, MetricRegistry(), kind, seed)
    theirs = _gate(jax_canary, JaxRegistry(), kind, seed)
    assert ours == theirs
    assert ours[0] == verdict


def _watch(mod, registry, errors, slow):
    cfg = mod.CanaryConfig(shadow_sample=1.0, min_shadow=3,
                           watch_min_requests=20, watch_s=0.0,
                           latency_factor=3.0, error_rate_limit=0.02)
    can = mod.ShadowCanary({"gen": 2}, config=cfg, registry=registry,
                           shadow_fn=lambda q: {"x": 1})
    for i in range(3):
        can.observe({"i": i}, {"x": 1}, 0.01, ok=True)
    assert _wait(lambda: can._decision is not None)
    assert can.take_decision() == "promote"
    can.promoted({"gen": 1})
    verdicts = []
    for i in range(25):
        can.observe({"i": i}, {"x": 1}, 0.05 if slow else 0.011,
                    ok=i not in errors)
        d = can.take_decision()
        if d is not None:
            verdicts.append((i, d, can.reason))
    out = can.to_dict()
    can.close()
    return verdicts, out


@pytest.mark.parametrize("errors, slow, verdict", [
    ((), False, "stable"), ((3,), False, "rollback"),
    ((), True, "rollback"), ((22,), False, "stable")])
def test_watch_verdicts_alike(errors, slow, verdict):
    ours = _watch(canary, MetricRegistry(), errors, slow)
    theirs = _watch(jax_canary, JaxRegistry(), errors, slow)
    assert ours == theirs
    assert ours[0][0][1] == verdict and ours[0][0][0] == 19


def test_cancel_claims_the_verdict_slot():
    for mod, reg in ((canary, MetricRegistry()), (jax_canary, JaxRegistry())):
        can = mod.ShadowCanary({"gen": 2}, registry=reg,
                               shadow_fn=lambda q: q)
        assert can.cancel("superseded")
        assert can.take_decision() is None and not can.cancel("again")
        can.finished(mod.REJECTED)
        assert can.state == mod.REJECTED
        assert reg.gauge("pio_canary_state", "").value == 4.0
