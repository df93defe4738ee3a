"""The replica autoscaler: the port's ``serving/autoscaler.py`` against
the JAX package's.

* ``reconcile_once`` makes the same decisions (action, target, spawned
  and retired replicas, low ticks, retired slots) from the same scripted
  signals, with fake spawners (the cases of the JAX package's
  ``tests/test_autoscaler.py``), and from hypothesis-drawn signal runs;
* a swap spawning concurrently with shrink and prune leaves consistent
  books in both;
* ``AutoscalerConfig.from_env`` reads the same ``PIO_AUTOSCALE_*`` knobs
  with the same defaults and clamps;
* ``ReplicaSpawner`` substitutes ``{port}``/``{generation}``, parses the
  ``listening on`` banner, skips it for an explicit port, and raises
  ``SpawnError`` alike; both packages' spawners read the port of a real
  ``python -m predictionio_tpu_torch.cli.main deploy --device cpu``
  child from its banner, and that child answers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from predictionio_tpu.obs import MetricRegistry as JaxRegistry
from predictionio_tpu.serving import autoscaler as jax_autoscaler
from predictionio_tpu_torch.obs import MetricRegistry
from predictionio_tpu_torch.serving import autoscaler

PKGS = {
    "jax": SimpleNamespace(mod=jax_autoscaler, Registry=JaxRegistry),
    "port": SimpleNamespace(mod=autoscaler, Registry=MetricRegistry),
}


class _FakeProc:
    def __init__(self, pid):
        self.pid = pid
        self.terminated = False

    def poll(self):
        return None

    def terminate(self):
        self.terminated = True


class _FakeSpawner:
    """Records launches, never forks; pids and ports count up from fixed
    starts, so both packages see the same ones."""

    def __init__(self):
        self.launches: list = []
        self._port = 9000
        self._pid = 5000

    def launch(self, generation, port=0):
        self.launches.append((generation, port))
        if port == 0:
            self._port += 1
            port = self._port
        self._pid += 1
        return _FakeProc(self._pid), port


class _Entry:
    def __init__(self, replica_id, generation, staged):
        self.replica_id = replica_id
        self.generation = generation
        self.staged = staged


class _ScriptedRouter:
    """The router surface the autoscaler reconciles against."""

    def __init__(self):
        self.signals = {
            "healthy": 0, "warming": 0, "draining": 0, "unhealthy": 0,
            "inflight": 0, "saturated": 0, "shedTotal": 0,
            "swapActive": False, "servingGeneration": "g1",
        }
        self.states: dict = {}
        self.added: list = []
        self.retired: list = []
        self.spawner = None
        self.status_fn = None
        self.lock = threading.Lock()

    def attach_spawner(self, fn):
        self.spawner = fn

    def attach_autoscaler_status(self, fn):
        self.status_fn = fn

    def autoscaler_signals(self):
        return dict(self.signals)

    def replica_states(self):
        with self.lock:
            return dict(self.states)

    def add_replica(self, url, replica_id=None, generation="", pid=None,
                    staged=False):
        entry = _Entry(replica_id, generation, staged)
        with self.lock:
            self.added.append(entry)
            self.states[replica_id] = "healthy"
        return entry

    def retire(self, replica_id, wait=False):
        with self.lock:
            if replica_id not in self.states:
                return False
            self.states.pop(replica_id)
            self.retired.append(replica_id)
        return True

    def update_replica_pid(self, replica_id, pid):
        return replica_id in self.states


def _scaler(p, router=None, **config_kw):
    router = router or _ScriptedRouter()
    config_kw.setdefault("min_replicas", 1)
    config_kw.setdefault("max_replicas", 4)
    config_kw.setdefault("shrink_after_ticks", 2)
    scaler = p.mod.ReplicaAutoscaler(
        router, _FakeSpawner(), config=p.mod.AutoscalerConfig(**config_kw),
        registry=p.Registry())
    return router, scaler


def _book(router, scaler, action) -> dict:
    return {
        "action": action, "target": scaler.target,
        "low": scaler._low_ticks,
        "added": [(e.replica_id, e.generation, e.staged)
                  for e in router.added],
        "retired": list(router.retired),
        "owned": sorted(scaler._owned),
        "slots_retired": [s.retired for s in scaler._slots],
        "status": scaler.status(),
    }


#: scripted runs: (config, [(signal updates, target override, "tick" |
#: "spawn" | "pop:<id>")]); each step's book is compared
_SCRIPTS = {
    "shed_grows": ({}, [({"healthy": 1, "shedTotal": 3}, None, "tick")]),
    "saturation_majority": ({"saturation_fraction": 0.5}, [
        ({"healthy": 2, "saturated": 1}, None, "tick")]),
    "growth_gates_on_warmup": ({}, [
        ({"healthy": 1, "shedTotal": 1}, None, "tick"),
        ({"healthy": 1, "warming": 1, "shedTotal": 2}, 4, "tick")]),
    "generation_ambiguous": ({}, [
        ({"healthy": 1, "shedTotal": 3, "servingGeneration": "",
          "generationAmbiguous": True}, None, "tick"),
        ({"shedTotal": 4, "servingGeneration": "g2",
          "generationAmbiguous": False}, None, "tick")]),
    "shed_delta": ({}, [
        ({"healthy": 1, "shedTotal": 5}, None, "tick"),
        ({"healthy": 2, "warming": 0, "shedTotal": 5}, None, "tick")]),
    "low_utilization_shrinks": ({"low_inflight_per_replica": 0.5}, [
        ({"healthy": 1, "shedTotal": 1}, None, "tick"),
        ({"healthy": 2, "shedTotal": 1, "inflight": 0}, None, "tick"),
        ({}, None, "tick")]),
    "one_low_tick": ({"shrink_after_ticks": 3}, [
        ({"healthy": 1, "shedTotal": 1}, None, "tick"),
        ({"healthy": 2, "inflight": 0, "shedTotal": 1}, None, "tick"),
        ({"inflight": 4}, None, "tick")]),
    "swap_tops_up": ({}, [
        ({"healthy": 1, "swapActive": True, "shedTotal": 9,
          "inflight": 0}, 2, "tick"),
        ({"healthy": 2, "swapActive": True}, None, "tick")]),
    "prune_released": ({}, [
        ({"healthy": 1, "shedTotal": 1}, None, "tick"),
        ({"healthy": 1, "shedTotal": 1, "warming": 0}, None, "pop:as-1"),
        ({}, None, "tick")]),
    "burn_grows": ({"burn_threshold": 2.0}, [
        ({"healthy": 1, "burnRate": 2.5}, None, "tick"),
        ({"healthy": 2, "burnRate": 0.1, "inflight": 0}, None, "tick")]),
    "clamped": ({"min_replicas": 2, "max_replicas": 3}, [
        ({"healthy": 3, "saturated": 3, "shedTotal": 1}, None, "tick"),
        ({}, None, "tick")]),
    "swap_spawn": ({}, [({}, None, "spawn")]),
}


def _run_script(p, name):
    config, steps = _SCRIPTS[name]
    router, scaler = _scaler(p, **config)
    books = [_book(router, scaler, "start")]
    for updates, target, op in steps:
        router.signals.update(updates)
        if target is not None:
            scaler.target = target
        if op == "tick":
            action = scaler.reconcile_once()
        elif op == "spawn":
            replica = router.spawner("g2", True)
            action = (replica.replica_id, replica.generation,
                      replica.staged)
        else:
            router.states.pop(op.split(":", 1)[1])
            action = scaler.reconcile_once()
        books.append(_book(router, scaler, action))
    return books


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_scripted_decisions_alike(name):
    port = _run_script(PKGS["port"], name)
    assert port == _run_script(PKGS["jax"], name)
    if name == "shed_grows":
        assert port[-1]["action"] == "grow" and port[-1]["target"] == 2
    if name == "low_utilization_shrinks":
        assert port[-1]["action"] == "shrink"
        assert port[-1]["retired"] == ["as-1"]
        assert all(port[-1]["slots_retired"])
    if name == "generation_ambiguous":
        assert [b["action"] for b in port[1:]] == ["idle", "grow"]


def test_spawn_skips_ids_adopted_alike():
    def run(p):
        router = _ScriptedRouter()
        router.states.update({"as-1": "healthy", "as-2": "healthy"})
        router, scaler = _scaler(p, router)
        router.signals.update(healthy=2, shedTotal=3)
        return scaler.reconcile_once(), [e.replica_id for e in router.added]

    assert run(PKGS["port"]) == run(PKGS["jax"]) == ("grow", ["as-3"])


_SIGNALS = st.fixed_dictionaries({
    "healthy": st.integers(0, 4), "warming": st.integers(0, 1),
    "inflight": st.integers(0, 12), "saturated": st.integers(0, 4),
    "shedDelta": st.integers(0, 3), "swapActive": st.booleans(),
    "burnRate": st.sampled_from([0.0, 0.5, 2.5]),
})


@settings(max_examples=60, deadline=None)
@given(run=st.lists(_SIGNALS, min_size=1, max_size=14),
       shrink_ticks=st.integers(1, 3))
def test_drawn_signal_runs_decide_alike(run, shrink_ticks):
    def replay(p):
        router, scaler = _scaler(p, shrink_after_ticks=shrink_ticks)
        shed = 0
        books = []
        for sig in run:
            shed += sig["shedDelta"]
            router.signals.update(
                {k: v for k, v in sig.items() if k != "shedDelta"},
                saturated=min(sig["saturated"], sig["healthy"]),
                shedTotal=shed)
            books.append(_book(router, scaler, scaler.reconcile_once()))
        return books

    assert replay(PKGS["port"]) == replay(PKGS["jax"])


def test_concurrent_swap_spawn_and_shrink_keep_books():
    router, scaler = _scaler(PKGS["port"], max_replicas=64)
    errors: list = []
    stop = threading.Event()

    def spawner():
        try:
            while not stop.is_set():
                scaler.spawn_for_swap("g2", staged=False)
        except BaseException as e:  # noqa: BLE001 - fails the test
            errors.append(e)

    def reconciler():
        try:
            while not stop.is_set():
                scaler._shrink()
                scaler._prune_retired()
        except BaseException as e:  # noqa: BLE001 - fails the test
            errors.append(e)

    threads = [threading.Thread(target=f, daemon=True)
               for f in (spawner, reconciler)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    assert errors == []
    states = router.replica_states()
    assert all(rid in states or rid in router.retired
               for rid in scaler._owned)


# -- configuration -----------------------------------------------------------


@pytest.mark.parametrize("env", [
    {},
    {"PIO_AUTOSCALE_MIN": "2", "PIO_AUTOSCALE_MAX": "8",
     "PIO_AUTOSCALE_SHRINK_TICKS": "3"},
    {"PIO_AUTOSCALE_MIN": "0", "PIO_AUTOSCALE_INTERVAL_S": "0.001",
     "PIO_AUTOSCALE_SATURATION_FRACTION": "7",
     "PIO_AUTOSCALE_LOW_INFLIGHT": "-1", "PIO_AUTOSCALE_BURN_THRESHOLD": "0"},
    {"PIO_AUTOSCALE_MAX": "junk", "PIO_AUTOSCALE_SATURATION_FRACTION": "0.01"},
])
def test_config_from_env_alike(monkeypatch, env):
    for k in list(os.environ):
        if k.startswith("PIO_AUTOSCALE"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = autoscaler.AutoscalerConfig.from_env()
    jax = jax_autoscaler.AutoscalerConfig.from_env()
    assert port.__dict__ == jax.__dict__
    if not env:
        assert (port.min_replicas, port.max_replicas, port.interval_s) == (
            1, 4, 1.0)


# -- the spawner -------------------------------------------------------------


def _spawn_outcome(p, argv, port, timeout=30.0):
    spawner = p.mod.ReplicaSpawner(argv, spawn_timeout_s=timeout)
    try:
        proc, bound = spawner.launch("g1", port=port)
    except p.mod.SpawnError as e:
        return "SpawnError", str(e).split(" within")[0]
    try:
        return "ok", bound
    finally:
        proc.kill()
        proc.wait(timeout=10)


_SPAWNS = {
    "banner": ([sys.executable, "-c", textwrap.dedent("""
        import sys, time
        print("x listening on 127.0.0.1:4321 pid=9", flush=True)
        time.sleep(30)
        """)], 0, 30.0),
    "explicit_port": ([sys.executable, "-c", "import time; time.sleep(30)"],
                      7777, 30.0),
    "dead_child": ([sys.executable, "-c", "import sys; sys.exit(3)"], 0,
                   30.0),
    "no_banner": ([sys.executable, "-c",
                   "import time; print('no banner'); time.sleep(30)"], 0,
                  0.5),
}


@pytest.mark.parametrize("case", sorted(_SPAWNS))
def test_spawner_alike(case):
    argv, port, timeout = _SPAWNS[case]
    got = _spawn_outcome(PKGS["port"], argv, port, timeout)
    assert got == _spawn_outcome(PKGS["jax"], argv, port, timeout)
    assert got == {"banner": ("ok", 4321), "explicit_port": ("ok", 7777),
                   "dead_child": ("SpawnError",
                                  "replica process exited rc=3 before "
                                  "binding"),
                   "no_banner": ("SpawnError",
                                 "replica never printed its port")}[case]


def test_spawner_argv_alike():
    template = ["python", "child.py", "--port", "{port}", "--generation",
                "{generation}", "--out", "/x/{generation}-{port}.json"]
    got = autoscaler.ReplicaSpawner(template).argv("g7", 8123)
    assert got == jax_autoscaler.ReplicaSpawner(template).argv("g7", 8123)
    assert got[3] == "8123" and got[-1] == "/x/g7-8123.json"
    for mod in (autoscaler, jax_autoscaler):
        with pytest.raises(ValueError):
            mod.ReplicaSpawner([])


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_spawners_read_a_real_port_deploy_banner(tmp_path):
    """A port ``deploy --device cpu`` child, started by each package's
    spawner from one template: the port is read from its banner, and
    the replica answers a query."""
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import App, Storage, set_storage
    from predictionio_tpu_torch.models.recommendation import (
        recommendation_engine,
    )
    from predictionio_tpu_torch.parallel.mesh import ComputeContext

    env = {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(tmp_path / "pio.sqlite"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }
    storage = Storage(env=env)
    rng = np.random.default_rng(2)
    app_id = storage.get_meta_data_apps().insert(App(0, "shop"))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{i}",
              properties={"rating": int(v)})
        for u, i, v in zip(rng.integers(0, 20, 200), rng.integers(0, 15, 200),
                           rng.integers(1, 6, 200))], app_id)
    variant = {"id": "spawned", "engineFactory": "recommendation",
               "datasource": {"params": {"app_name": "shop"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 4, "num_iterations": 2}}]}
    (tmp_path / "engine.json").write_text(json.dumps(variant))
    engine = recommendation_engine()
    set_storage(storage)
    try:
        run_train(engine, engine.params_from_variant(variant), "spawned",
                  storage=storage, ctx=ComputeContext.create(device="cpu"))
    finally:
        set_storage(None)
    child_env = dict(os.environ, PYTHONPATH=ROOT,
                     PIO_FS_BASEDIR=str(tmp_path), **env)
    template = [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                "deploy", "--variant", str(tmp_path / "engine.json"),
                "--ip", "127.0.0.1", "--port", "{port}", "--device", "cpu"]
    for p in (PKGS["port"], PKGS["jax"]):
        spawner = p.mod.ReplicaSpawner(template, env=child_env,
                                       spawn_timeout_s=120.0)
        proc, port = spawner.launch("g1", port=0)
        try:
            assert port > 0
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/queries.json", method="POST",
                data=json.dumps({"user": "u1", "num": 3}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
                assert len(json.loads(resp.read())["itemScores"]) == 3
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
