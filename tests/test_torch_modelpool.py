"""The port's model pool against the JAX package's, step by step.

Both ``ModelPool``s run the same sequences of operations with fake
loaders (a value, a byte count, a close that records itself): pin and
release, a pin held across later steps (so eviction has to pass it by),
an explicit evict, a ``replace`` (its close deferred until the last pin
drains), a loader that raises (``PoolLoadError``) and one that outlives
the caller's deadline (``PoolLoadTimeout``, then the load lands). Each
pool's module clock is pinned to one manual clock, and after every step
each pool's loader thread is drained through a no-op close job, so the
two runs are deterministic. After every step they must show the same
outcome, resident list, ``stats()``, ``pio_pool_*`` and residency
byte-seconds samples, closes in the same order and the same timeline
events. The sequences are a scripted one and hypothesis-drawn ones.

Then, with real threads and the real clock: concurrent misses for one
tenant share one load, and the budget resolves from the same
environment (and the same card limit) in both.
"""

from __future__ import annotations

import contextlib
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from predictionio_tpu.obs import timeline as jax_timeline
from predictionio_tpu.obs.registry import MetricRegistry as JaxRegistry
from predictionio_tpu.serving import modelpool as jax_pool
from predictionio_tpu_torch.obs import device as port_device
from predictionio_tpu_torch.obs import timeline as port_timeline
from predictionio_tpu_torch.obs.registry import MetricRegistry
from predictionio_tpu_torch.serving import modelpool as port_pool

BUDGET = 1000
TENANTS = ("a", "b", "c", "d")
SIZES = (100, 250, 400, 700)


class _Clock:
    """The pool modules' ``time``: monotonic reads a value the test
    advances."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


@contextlib.contextmanager
def _pinned_clocks():
    clock = _Clock()
    saved = (jax_pool.time, port_pool.time)
    jax_pool.time = port_pool.time = clock
    try:
        yield clock
    finally:
        jax_pool.time, port_pool.time = saved


class _Side:
    """One package's pool, its registry and timeline, and what its
    loaders and closes did."""

    def __init__(self, mod, registry_cls, timeline_mod, clock):
        self.mod = mod
        self.clock = clock
        self.registry = registry_cls()
        self.timeline = timeline_mod.Timeline()
        self.pool = mod.ModelPool(
            BUDGET, registry=self.registry, timeline=self.timeline
        )
        self.closed: list[str] = []
        self.loads: list[str] = []
        self.held: list = []
        self.versions: dict[str, int] = {}

    def loader(self, tenant, nbytes, gate=None, fail=False):
        def load():
            self.loads.append(tenant)
            if gate is not None:
                gate.wait(10)
            if fail:
                raise RuntimeError(f"corrupt model {tenant}")
            version = self.versions.get(tenant, 0) + 1
            self.versions[tenant] = version
            name = f"{tenant}@{version}"
            return name, nbytes, lambda: self.closed.append(name)

        return load

    def settle(self) -> None:
        """Wait until every job queued so far ran on the loader thread."""
        done = threading.Event()
        entry = self.mod._Entry("(barrier)", None, 0, done.set,
                                self.clock.now)
        self.pool._jobs.put(self.mod._Close(entry))
        assert done.wait(10), "loader thread stuck"

    def step(self, op) -> object:
        kind = op[0]
        pool = self.pool
        if kind == "pin":
            with pool.pin(op[1], self.loader(op[1], op[2])) as value:
                return value
        if kind == "hold":
            cm = pool.pin(op[1], self.loader(op[1], op[2]))
            value = cm.__enter__()
            self.held.append(cm)
            return value
        if kind == "release":
            if not self.held:
                return None
            self.held.pop(0).__exit__(None, None, None)
            return "released"
        if kind == "evict":
            return pool.evict(op[1])
        if kind == "replace":
            pool.replace(op[1], self.loader(op[1], op[2]))
            return "replaced"
        if kind == "fail":
            try:
                with pool.pin(op[1], self.loader(op[1], 1, fail=True)) as v:
                    return v
            except self.mod.PoolLoadError as e:
                return f"PoolLoadError: {e}"
        if kind == "timeout":
            gate = threading.Event()
            try:
                with pool.pin(op[1], self.loader(op[1], op[2], gate=gate),
                              timeout=0.02) as v:
                    return v
            except self.mod.PoolLoadTimeout as e:
                return f"PoolLoadTimeout: {e}"
            finally:
                gate.set()
        if kind == "tick":
            self.clock.now += op[1]
            return None
        raise AssertionError(op)

    def view(self) -> dict:
        text = self.registry.render_prometheus()
        return {
            "resident": self.pool.resident(),
            "stats": self.pool.stats(),
            "metrics": [
                line for line in text.splitlines()
                if "pio_pool_" in line
                or "pio_tenant_resident_byte_seconds" in line
            ],
            "closed": list(self.closed),
            "loads": list(self.loads),
            "events": [
                (e["kind"], e.get("tenant", ""), e["severity"],
                 e["message"])
                for e in self.timeline.to_dict()["events"]
            ],
        }

    def close(self) -> None:
        while self.held:
            self.held.pop().__exit__(None, None, None)
        self.pool.close()


def _run_both(ops) -> None:
    with _pinned_clocks() as clock:
        jax_side = _Side(jax_pool, JaxRegistry, jax_timeline, clock)
        port_side = _Side(port_pool, MetricRegistry, port_timeline, clock)
        try:
            for i, op in enumerate(ops):
                want = jax_side.step(op)
                got = port_side.step(op)
                if op[0] == "tick":
                    continue
                jax_side.settle()
                port_side.settle()
                assert got == want, (i, op)
                assert port_side.view() == jax_side.view(), (i, op)
        finally:
            jax_side.close()
            port_side.close()
        assert port_side.closed == jax_side.closed


_SCRIPT = [
    ("pin", "a", 400), ("tick", 2.0), ("pin", "b", 400), ("tick", 1.0),
    ("pin", "a", 400),                      # a hit
    ("pin", "c", 400),                      # evicts b, the LRU
    ("hold", "a", 400), ("tick", 3.0),
    ("pin", "d", 700),                      # must pass the held a by
    ("evict", "a"),                         # refused: a is pinned
    ("replace", "a", 250),                  # a@1 retired, closed later
    ("tick", 0.5), ("release",),            # a@1 closes now
    ("fail", "b"), ("pin", "b", 100),       # a failed load does not wedge
    ("timeout", "c", 100),                  # evicted earlier: cold again
    ("evict", "d"), ("evict", "zzz"),
    ("hold", "b", 100), ("hold", "a", 250), ("pin", "d", 700),
    ("tick", 7.0), ("release",), ("release",),
    ("replace", "c", 400), ("pin", "c", 400),
]


def test_scripted_sequence_matches_jax():
    _run_both(_SCRIPT)


_OPS = st.one_of(
    st.tuples(st.sampled_from(["pin", "hold", "replace", "timeout"]),
              st.sampled_from(TENANTS), st.sampled_from(SIZES)),
    st.tuples(st.sampled_from(["evict", "fail"]), st.sampled_from(TENANTS)),
    st.tuples(st.just("release")),
    st.tuples(st.just("tick"), st.sampled_from([0.25, 1.0, 4.0])),
)


@settings(max_examples=30, deadline=None)
@given(st.lists(_OPS, min_size=1, max_size=18))
def test_drawn_sequences_match_jax(ops):
    _run_both(ops)


@pytest.mark.parametrize("mod", [jax_pool, port_pool],
                         ids=["jax", "port"])
def test_concurrent_misses_share_one_load(mod):
    pool = mod.ModelPool(1000)
    calls = []

    def load():
        calls.append("a")
        time.sleep(0.2)
        return "model-a", 10, None

    held, out = [], []

    def request():
        cm = pool.pin("a", load, timeout=10)
        held.append(cm)
        out.append(cm.__enter__())

    try:
        threads = [threading.Thread(target=request) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert calls == ["a"] and out == ["model-a"] * 8
        assert pool.stats()["tenants"]["a"]["pins"] == 8
        for cm in held:
            cm.__exit__(None, None, None)
        assert pool.stats()["tenants"]["a"]["pins"] == 0
    finally:
        pool.close()


@pytest.mark.parametrize("env, limit", [
    ({}, None),
    ({"PIO_POOL_BUDGET_BYTES": "123456"}, None),
    ({"PIO_POOL_BUDGET_BYTES": "lots"}, None),
    ({}, 80e9),
    ({"PIO_POOL_HBM_FRACTION": "0.25"}, 80e9),
    ({"PIO_POOL_HBM_FRACTION": "7"}, 1e9),
    ({"PIO_POOL_BUDGET_BYTES": "999", "PIO_POOL_HBM_FRACTION": "0.1"},
     80e9),
])
def test_budget_resolves_alike(monkeypatch, env, limit):
    """The env wins; else a fraction of the smallest card's memory (a
    fake ``sample_devices`` stands in for the card in both packages);
    else 256 MiB."""
    import predictionio_tpu.obs.device as jax_device

    for name in ("PIO_POOL_BUDGET_BYTES", "PIO_POOL_HBM_FRACTION"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    sample = {"devices": {"d0": {"used": 1.0, "limit": limit},
                          "d1": {"used": 1.0, "limit": (limit or 0) * 2}}}
    monkeypatch.setattr(jax_device, "sample_devices",
                        lambda: sample if limit else {})
    monkeypatch.setattr(port_device, "sample_devices",
                        lambda: sample if limit else {})
    want = jax_pool.default_budget_bytes()
    assert port_pool.default_budget_bytes() == want
    if not env and limit is None:
        assert want == 256 * 1024 * 1024


def test_closed_entry_drops_its_value():
    """The port drops a closed entry's value, so the tensors it held
    are freed even while a stale reference to the entry remains."""
    pool = port_pool.ModelPool(100)
    try:
        with pool.pin("a", lambda: ("table-a", 80, None)):
            pass
        entry = pool._entries["a"]
        with pool.pin("b", lambda: ("table-b", 80, None)):
            pass
        assert pool.resident() == ["b"]
        assert entry.value is None and entry.retired
    finally:
        pool.close()
