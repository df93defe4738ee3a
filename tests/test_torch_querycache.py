"""The serving query cache: the port's copy of ``serving/querycache.py``
against the JAX package's.

* ``canonical_query_bytes`` is byte-equal to JAX's over
  hypothesis-generated JSON queries (nested, unicode, volatile keys),
  and key order on the wire does not change it;
* one seeded script of claims, fills, aborts and flushes against both
  caches, with one budget, shard count, TTL and clock, gives the same
  hit / leader / waiter states, the same values, the same eviction
  order (resident keys in LRU order after every step) and the same
  counters;
* single-flight: the waiters of one leader get its bytes, a leader's
  failure reaches every waiter as ``LeaderFailed`` with the real cause
  and clears the slot, a waiter's own timeout detaches it, and the
  coalesced class escalates to the highest waiting one, in both;
* the ``PIO_CACHE*`` settings read alike.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from predictionio_tpu.obs import MetricRegistry as JaxRegistry
from predictionio_tpu.serving import admission as jax_adm
from predictionio_tpu.serving import querycache as jax_qc
from predictionio_tpu_torch.obs import MetricRegistry
from predictionio_tpu_torch.serving import admission as adm
from predictionio_tpu_torch.serving import querycache as qc

_scalars = (st.none() | st.booleans() | st.integers(-10**12, 10**12)
            | st.floats(allow_nan=False, allow_infinity=False)
            | st.text(max_size=12))
_json = st.recursive(
    _scalars,
    lambda kids: st.lists(kids, max_size=4)
    | st.dictionaries(st.text(max_size=8), kids, max_size=4),
    max_leaves=20,
)
_queries = st.dictionaries(
    st.sampled_from(["user", "num", "items", "categories", "prId", "pid",
                     "generation", "whiteList", "ü", ""]) | st.text(max_size=6),
    _json, max_size=6,
)


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(query=_queries)
def test_canonical_query_bytes_byte_equal(query):
    ours = qc.canonical_query_bytes(query)
    assert ours == jax_qc.canonical_query_bytes(query)
    # key order on the wire does not matter
    reordered = dict(reversed(list(query.items())))
    assert qc.canonical_query_bytes(reordered) == ours
    assert not {"prId", "pid", "generation"} & set(json.loads(ours))


@settings(max_examples=100, deadline=None)
@given(value=_json)
def test_canonical_bytes_of_any_json_value(value):
    assert qc.canonical_query_bytes(value) == jax_qc.canonical_query_bytes(
        value)


@pytest.mark.parametrize("env", [
    {},
    {"PIO_CACHE": "1"},
    {"PIO_CACHE": "off", "PIO_CACHE_BUDGET_BYTES": "100"},
    {"PIO_CACHE_BUDGET_BYTES": "4096", "PIO_CACHE_TTL_S": "2.5",
     "PIO_CACHE_SHARDS": "3"},
    {"PIO_CACHE": "yes", "PIO_CACHE_BUDGET_BYTES": "-1",
     "PIO_CACHE_TTL_S": "x", "PIO_CACHE_SHARDS": "0"},
])
def test_settings_from_env_alike(monkeypatch, env):
    for k in ("PIO_CACHE", "PIO_CACHE_BUDGET_BYTES", "PIO_CACHE_TTL_S",
              "PIO_CACHE_SHARDS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert qc.cache_enabled_from_env() == jax_qc.cache_enabled_from_env()
    assert qc.default_budget_bytes() == jax_qc.default_budget_bytes()
    assert qc._ttl_from_env() == jax_qc._ttl_from_env()
    assert qc._shards_from_env() == jax_qc._shards_from_env()
    ours, theirs = qc.QueryCache(), jax_qc.QueryCache()
    assert (ours.budget_bytes, len(ours._shards), ours._ttl) == (
        theirs.budget_bytes, len(theirs._shards), theirs._ttl)
    assert qc.CACHE_HEADER == jax_qc.CACHE_HEADER == "X-PIO-Cache"


def _resident(cache):
    """Resident keys per shard, in LRU order (oldest first)."""
    return [list(shard.entries) for shard in cache._shards]


def _script(seed: int):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(700):
        r = rng.random()
        tenant = ["", "a", "b"][rng.integers(0, 3)]
        gen = f"g{rng.integers(0, 2)}"
        q = {"user": f"u{int(rng.zipf(1.3)) % 40}", "num": 10}
        size = int(rng.integers(10, 300))
        if r < 0.85:
            ops.append(("request", tenant, gen, q, size,
                        bool(rng.random() < 0.1), float(rng.random())))
        elif r < 0.95:
            ops.append(("tick", float(rng.uniform(0, 2))))
        else:
            ops.append(("flush", [None, "a", ""][rng.integers(0, 3)]))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("budget, shards, ttl", [
    (4096, 1, None), (3000, 4, 3.0), (64 << 20, 8, None)])
def test_same_states_and_eviction_order(seed, budget, shards, ttl):
    now = [10.0]
    clock = lambda: now[0]  # noqa: E731
    regs = (MetricRegistry(), JaxRegistry())
    caches = (
        qc.QueryCache(budget, shards=shards, ttl_s=ttl, registry=regs[0],
                      clock=clock),
        jax_qc.QueryCache(budget, shards=shards, ttl_s=ttl,
                          registry=regs[1], clock=clock),
    )
    seen = set()
    for op in _script(seed):
        if op[0] == "tick":
            now[0] += op[1]
            continue
        if op[0] == "flush":
            dropped = [c.flush(op[1], reason="reload") for c in caches]
            assert dropped[0] == dropped[1]
            continue
        _, tenant, gen, q, size, fail, _ = op
        key = (qc.canonical_query_bytes(q),
               jax_qc.canonical_query_bytes(q))
        claims = [c.claim(tenant, gen, k) for c, k in zip(caches, key)]
        states = [("hit", cl.value) if cl.hit else
                  ("leader",) if cl.leader else ("waiter",) for cl in claims]
        assert states[0] == states[1]
        seen.add(states[0][0])
        if claims[0].leader:
            if fail:
                for c, cl in zip(caches, claims):
                    c.abort(cl, RuntimeError("model blew up"))
            else:
                body = json.dumps({"q": q, "pad": "x" * size}).encode()
                for c, cl in zip(caches, claims):
                    c.fill(cl, body)
        assert _resident(caches[0]) == _resident(caches[1])
        assert caches[0].resident_bytes() == caches[1].resident_bytes()
        assert len(caches[0]) == len(caches[1])
    assert seen == {"hit", "leader"}
    assert caches[0].stats() == caches[1].stats()
    for name in ("pio_cache_hits_total", "pio_cache_misses_total",
                 "pio_cache_evictions_total"):
        got = [sorted((k, c.value) for k, c in reg.counter(
            name, "", ("tenant",))._children.items()) for reg in regs]
        assert got[0] == got[1], name
    if budget < 5000:
        # the budget forced evictions
        assert regs[0].counter("pio_cache_evictions_total", "",
                               ("tenant",))._children


def _single_flight(mod, admod, registry):
    """One leader, three waiters of rising class, then a failing leader
    and a waiter that times out. Returns what each party saw."""
    cache = mod.QueryCache(1 << 20, shards=2, registry=registry)
    key = mod.canonical_query_bytes({"user": "u1", "num": 5})
    leader = cache.claim("", "g1", key)
    assert leader.leader
    seen = {"classes": [leader.criticality()]}
    results, threads = [], []
    for cls in ("sheddable", "critical", "default"):
        with admod.criticality(cls):
            claim = cache.claim("", "g1", key)
        assert not claim.leader and not claim.hit
        seen["classes"].append(leader.criticality())
        t = threading.Thread(target=lambda c=claim: results.append(
            cache.join(c, 10.0)))
        t.start()
        threads.append(t)
    cache.fill(leader, b'{"itemScores": []}')
    for t in threads:
        t.join(10)
    seen["waiters"] = sorted(results)
    seen["hit"] = cache.claim("", "g1", key).value
    # a failing leader: every waiter sees its error, the slot clears
    key2 = mod.canonical_query_bytes({"user": "u2"})
    lead2 = cache.claim("", "g1", key2)
    wait2 = cache.claim("", "g1", key2)
    errors = []

    def waiter():
        try:
            cache.join(wait2, 10.0)
        except mod.LeaderFailed as e:
            errors.append(repr(e.__cause__))

    t = threading.Thread(target=waiter)
    t.start()
    cache.abort(lead2, ValueError("shadow boom"))
    t.join(10)
    seen["errors"] = errors
    seen["after_abort"] = cache.claim("", "g1", key2).leader
    # a waiter whose own budget ends first detaches
    key3 = mod.canonical_query_bytes({"user": "u3"})
    lead3 = cache.claim("", "g1", key3)
    wait3 = cache.claim("", "g1", key3)
    try:
        cache.join(wait3, 0.05)
        seen["timeout"] = False
    except mod.WaiterTimeout:
        seen["timeout"] = True
    cache.fill(lead3, b"3")
    seen["late_hit"] = cache.claim("", "g1", key3).value
    # a flush drops entries; a fill whose claim predates it is not kept
    lead4 = cache.claim("a", "g1", key)
    cache.flush("a", reason="promote")
    cache.fill(lead4, b"4")
    seen["after_flush"] = cache.claim("a", "g1", key).leader
    seen["stats"] = cache.stats()
    cache.close()
    return seen


def test_single_flight_alike():
    ours = _single_flight(qc, adm, MetricRegistry())
    theirs = _single_flight(jax_qc, jax_adm, JaxRegistry())
    assert ours == theirs
    assert ours["classes"] == ["default", "default", "critical", "critical"]
    assert ours["waiters"] == [b'{"itemScores": []}'] * 3
    assert ours["errors"] == ["ValueError('shadow boom')"]
    assert ours["after_abort"] and ours["timeout"]
    assert ours["late_hit"] == b"3" and ours["after_flush"]


def test_close_fails_stranded_waiters():
    cache = qc.QueryCache(1 << 20)
    lead = cache.claim("", "g", b"k")
    wait = cache.claim("", "g", b"k")
    cache.close()
    with pytest.raises(qc.LeaderFailed):
        cache.join(wait, 1.0)
    assert lead.leader
