"""The micro-batcher: the port's ``serving/batching.py`` against the JAX
package's ``MicroBatcher`` on the same items.

Each test holds the collector at the collector→launch handoff with an
event (its first ``dispatch`` waits on it), queues the same submissions
in both packages, then releases it, so what each batcher decides is
deterministic:

* deadline-aware selection: an over-full queue launches the nearest
  deadlines first, in arrival order within the batch;
* victim choice at the queue bound: a higher class evicts the lowest
  class, nearest deadline, latest arrival; an equal class is refused;
  the shed counters by class agree;
* the adaptive wait halves on full batches and is restored by the first
  non-full one;
* an expired slot and a cancelled slot are cut before the launch and
  counted;
* attribution: the device seconds apportioned to tenants equal the
  measured enqueue + sync seconds within 1 %, and the sync seconds are
  timed around ``collect`` (the wait for the copy back), not the launch;
* the reference's cancel race, held at the handoff: a won cancel never
  reaches a launch, every future ends in one state, 50 times over;
* the repair (ROADMAP.md §3): cancelled slots still queued no longer
  hold the queue bound, where the JAX batcher refuses a live submission.
"""

from __future__ import annotations

import threading
import time

import pytest

from predictionio_tpu.obs import MetricRegistry as JaxRegistry
from predictionio_tpu.serving import admission as jax_adm
from predictionio_tpu.serving import batching as jax_batching
from predictionio_tpu.serving import resilience as jax_res
from predictionio_tpu_torch.obs import MetricRegistry
from predictionio_tpu_torch.serving import admission as adm
from predictionio_tpu_torch.serving import batching
from predictionio_tpu_torch.serving import resilience as res

PKGS = {
    "torch": (batching, adm, res, MetricRegistry),
    "jax": (jax_batching, jax_adm, jax_res, JaxRegistry),
}


class _Held:
    """A two-phase batch_fn whose first launch waits on ``gate`` (the
    collector is held at the handoff) and which logs every launch."""

    def __init__(self, dispatch_s=0.0, collect_s=0.0):
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.launched: list[list] = []
        self.waits: list[float] = []
        self.batcher = None
        self.dispatch_s = dispatch_s
        self.collect_s = collect_s

    def dispatch(self, items):
        if not self.entered.is_set():
            self.entered.set()
            assert self.gate.wait(10)
        if self.batcher is not None:
            self.waits.append(self.batcher._current_wait)
        if self.dispatch_s:
            time.sleep(self.dispatch_s)
        self.launched.append(list(items))
        return list(items)

    def collect(self, handle):
        if self.collect_s:
            time.sleep(self.collect_s)
        return [f"R{x}" for x in handle]


def _held_batcher(pkg, fn, **kw):
    mod, _, _, reg_cls = PKGS[pkg]
    registry = reg_cls()
    b = mod.MicroBatcher(mod.TwoPhaseBatchFn(fn.dispatch, fn.collect),
                         registry=registry, name="b", **kw)
    fn.batcher = b
    first = b.submit("first")
    assert fn.entered.wait(10)
    return b, registry, first


def _submit(pkg, b, item, cls="default", budget=None, tenant=""):
    _, admod, resmod, _ = PKGS[pkg]
    resmod.set_deadline(
        None if budget is None else resmod.Deadline.after(budget))
    try:
        with admod.criticality(cls), admod.tenant(tenant):
            return b.submit(item)
    finally:
        resmod.set_deadline(None)


def _counter(registry, name, labels=("batcher",)):
    return {k: c.value for k, c in
            registry.counter(name, "", labels)._children.items()}


_SELECTION = [(f"q{i}", budget) for i, budget in enumerate(
    [None, 50.0, 20.0, None, 10.0, 30.0, 5.0, None, 40.0, 15.0, None,
     25.0])]


@pytest.mark.parametrize("max_batch", [3, 4, 5])
def test_deadline_aware_selection_alike(max_batch):
    got = {}
    for pkg in PKGS:
        fn = _Held()
        b, _, first = _held_batcher(pkg, fn, max_batch=max_batch,
                                    max_wait_ms=1.0)
        futures = [_submit(pkg, b, item, budget=budget)
                   for item, budget in _SELECTION]
        fn.gate.set()
        assert [f.result(10) for f in futures] == [
            f"R{item}" for item, _ in _SELECTION]
        b.close()
        got[pkg] = fn.launched
    assert got["torch"] == got["jax"]
    launched = got["torch"]
    assert launched[0] == ["first"]
    # the nearest deadlines went first, the batch in arrival order
    nearest = {item for item, _ in sorted(
        _SELECTION, key=lambda s: (s[1] if s[1] else 1e9,
                                   _SELECTION.index(s)))[:max_batch]}
    assert launched[1] == [item for item, _ in _SELECTION
                           if item in nearest]


_VICTIMS = [
    ("s0", "sheddable", 30.0), ("d0", "default", None),
    ("s1", "sheddable", 10.0), ("s2", "sheddable", None),
    # the queue (4) is full from here on
    ("c0", "critical", None),     # evicts s1 (sheddable, nearest deadline)
    ("s3", "sheddable", None),    # equal to the lowest: refused
    ("d1", "default", 5.0),       # evicts s0 (sheddable, deadline 30)
    ("d2", "default", None),      # evicts s2 (last sheddable)
    ("d3", "default", None),      # no lower class left: refused
    ("c1", "critical", None),     # evicts d1 (nearest deadline)
    ("c2", "critical", None),     # evicts d2 (latest arrival of the rest)
    ("c3", "critical", None),     # evicts d0
    ("c4", "critical", None),     # all critical: refused
]


def test_victim_choice_alike():
    got = {}
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        fn = _Held()
        b, registry, first = _held_batcher(pkg, fn, max_batch=8,
                                           max_wait_ms=1.0, max_queue=4)
        outcome, futures = [], {}
        for item, cls, budget in _VICTIMS:
            try:
                futures[item] = _submit(pkg, b, item, cls, budget)
                outcome.append((item, "queued"))
            except mod.BatcherOverloaded:
                outcome.append((item, "refused"))
            evicted = sorted(
                k for k, f in futures.items()
                if f.done() and isinstance(f.exception(0),
                                           mod.BatcherOverloaded))
            outcome.append(tuple(evicted))
        fn.gate.set()
        served = sorted(k for k, f in futures.items()
                        if f.exception(10) is None)
        b.close()
        shed = _counter(registry, "pio_shed_total", ("batcher", "class"))
        got[pkg] = (outcome, served, fn.launched, shed,
                    _counter(registry, "pio_batch_shed_total"))
    assert got["torch"] == got["jax"]
    outcome, served, launched, shed, _ = got["torch"]
    assert served == ["c0", "c1", "c2", "c3"]
    assert ("s3", "refused") in outcome and ("c4", "refused") in outcome
    assert shed == {("b", "sheddable"): 4.0, ("b", "default"): 4.0,
                    ("b", "critical"): 1.0}


def test_adaptive_wait_alike():
    got = {}
    for pkg in PKGS:
        fn = _Held()
        b, _, first = _held_batcher(pkg, fn, max_batch=2, max_wait_ms=40.0)
        futures = [_submit(pkg, b, f"q{i}") for i in range(8)]
        fn.gate.set()
        [f.result(10) for f in futures]
        # a lone query after the backlog: a non-full batch
        assert _submit(pkg, b, "late").result(10) == "Rlate"
        time.sleep(0.01)
        lone = _submit(pkg, b, "lone")
        assert lone.result(10) == "Rlone"
        b.close()
        got[pkg] = (fn.launched, fn.waits)
    assert got["torch"] == got["jax"]
    waits = got["torch"][1]
    # full batches halve the window (40 → 20 → 10 → 5 ms); the non-full
    # first batch and the lone late query restore the whole 40 ms
    assert waits[1:5] == [0.04, 0.02, 0.01, 0.005]
    assert waits[-1] == 0.04


def test_expired_and_cancelled_slots_cut_before_launch():
    got = {}
    for pkg in PKGS:
        fn = _Held()
        b, registry, first = _held_batcher(pkg, fn, max_batch=8,
                                           max_wait_ms=1.0)
        short = _submit(pkg, b, "short", budget=0.02)
        gone = _submit(pkg, b, "gone")
        keep = _submit(pkg, b, "keep", budget=60.0)
        assert gone.cancel()
        time.sleep(0.05)
        fn.gate.set()
        assert keep.result(10) == "Rkeep"
        mod, _, resmod, _ = PKGS[pkg]
        with pytest.raises(resmod.DeadlineExceeded):
            short.result(10)
        b.close()
        got[pkg] = (fn.launched,
                    _counter(registry, "pio_batch_deadline_expired_total"),
                    _counter(registry, "pio_batch_cancelled_total"),
                    _counter(registry, "pio_batches_total"))
    assert got["torch"] == got["jax"]
    assert got["torch"] == ([["first"], ["keep"]], {("b",): 1.0},
                            {("b",): 1.0}, {("b",): 2.0})


def test_submit_refuses_an_already_expired_budget():
    for pkg in PKGS:
        mod, _, resmod, reg_cls = PKGS[pkg]
        registry = reg_cls()
        b = mod.MicroBatcher(lambda items: items, registry=registry)
        with pytest.raises(resmod.DeadlineExceeded):
            _submit(pkg, b, "x", budget=0.0)
        b.close()
        assert _counter(registry, "pio_batch_deadline_expired_total") == {
            ("default",): 1.0}


@pytest.mark.parametrize("depth", [0, 2])
def test_attribution_conserves_measured_device_time(depth):
    """Per-tenant device seconds sum to the measured enqueue + sync
    seconds (within 1 %), and the sync seconds are the collect wait: a
    launch of ~2 ms and a copy back of ~8 ms give sync ≈ 4× enqueue."""
    got = {}
    for pkg in PKGS:
        fn = _Held(dispatch_s=0.002, collect_s=0.008)
        fn.entered.set()  # nothing held: run straight through
        mod, _, _, reg_cls = PKGS[pkg]
        registry = reg_cls()
        b = mod.MicroBatcher(mod.TwoPhaseBatchFn(fn.dispatch, fn.collect),
                             max_batch=4, max_wait_ms=1.0,
                             pipeline_depth=depth, registry=registry,
                             name="b")
        futures = [_submit(pkg, b, i, tenant=["a", "b", "c"][i % 3])
                   for i in range(30)]
        assert [f.result(10) for f in futures] == [f"R{i}"
                                                    for i in range(30)]
        b.close()

        def hist_sum(name):
            return registry.histogram(name, "", ("batcher",)).labels(
                "b").sum

        measured = hist_sum("pio_device_enqueue_seconds") + hist_sum(
            "pio_device_sync_seconds")
        attributed = sum(_counter(
            registry, "pio_tenant_device_seconds_total",
            ("tenant",)).values())
        assert attributed == pytest.approx(measured, rel=0.01)
        slots = _counter(registry, "pio_tenant_requests_total",
                         ("tenant", "status"))
        assert slots == {("a", "ok"): 10.0, ("b", "ok"): 10.0,
                         ("c", "ok"): 10.0}
        assert hist_sum("pio_device_sync_seconds") > 2.0 * hist_sum(
            "pio_device_enqueue_seconds")
        got[pkg] = slots
    assert got["torch"] == got["jax"]


def _cancel_race_once(pkg):
    """The reference's cancel race, deterministic: the collector is held
    at the handoff while 14 submissions queue (under the default bound of
    16) and every other one is cancelled; then it is released. Returns
    (outcome counts, launched items)."""
    mod = PKGS[pkg][0]
    fn = _Held()
    b, registry, first = _held_batcher(pkg, fn, max_batch=2,
                                       max_wait_ms=0.5, pipeline_depth=2)
    outcomes = {"cancelled": 0, "served": 0}
    pending = []
    try:
        for i in range(14):
            f = b.submit(f"r{i}")
            if i % 2 and f.cancel():
                outcomes["cancelled"] += 1
                assert f.cancelled()
            else:
                pending.append((i, f))
        fn.gate.set()
        assert first.result(5) == "Rfirst"
        for i, f in pending:
            assert f.result(5) == f"Rr{i}"
            outcomes["served"] += 1
    finally:
        fn.gate.set()
        b.close()
    launched = [x for batch in fn.launched[1:] for x in batch]
    # a won cancel is a promise that no launch saw the item
    assert len(launched) == outcomes["served"]
    assert not {f"r{i}" for i in range(1, 14, 2)} & set(launched)
    assert outcomes["cancelled"] + outcomes["served"] == 14
    return outcomes, sorted(launched)


def test_cancel_racing_the_handoff_held_by_an_event():
    want = _cancel_race_once("jax")
    for _ in range(50):
        assert _cancel_race_once("torch") == want
    assert want[0] == {"cancelled": 7, "served": 7}


def test_cancelled_slots_do_not_hold_the_queue_bound():
    """The reference's fault: with the collector held, 16 cancelled
    slots fill the default bound (8 × max_batch) and the JAX batcher
    refuses the next live submission. The port sweeps them out first,
    counts them as cancelled, and serves it."""
    outcomes = {}
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        fn = _Held()
        b, registry, first = _held_batcher(pkg, fn, max_batch=2,
                                           max_wait_ms=0.5)
        for i in range(16):
            assert b.submit(f"c{i}").cancel()
        try:
            live = b.submit("live")
            outcomes[pkg] = "accepted"
        except mod.BatcherOverloaded:
            live = None
            outcomes[pkg] = "refused"
        fn.gate.set()
        if live is not None:
            assert live.result(10) == "Rlive"
        b.close()
        if pkg == "torch":
            assert fn.launched == [["first"], ["live"]]
            assert _counter(registry, "pio_batch_cancelled_total") == {
                ("b",): 16.0}
            assert _counter(registry, "pio_batch_shed_total") == {("b",): 0.0}
    assert outcomes == {"torch": "accepted", "jax": "refused"}


def test_retry_after_hint_from_queue_state():
    for pkg in PKGS:
        fn = _Held()
        b, _, first = _held_batcher(pkg, fn, max_batch=4, max_wait_ms=1.0)
        assert b.retry_after_s() == 0.05  # no batch time observed yet
        for i in range(12):
            b.submit(i)
        fn.gate.set()
        b.close()
        hint = b.retry_after_s()
        assert 0.05 <= hint <= 5.0
