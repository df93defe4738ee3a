"""The continuous trainer and ``POST /reload`` in the port against the
JAX package, on the CPU.

Each scenario runs once per package on the same inputs (events made
from a seed with numpy, with explicit event times so watermarks agree)
and the outcomes are compared:

* ``read_watermark`` on the memory store, sqlite and the native event
  log, per app and per channel, and across packages on one file;
* ``decide`` over a grid of configurations, trainer states and
  watermarks;
* the poll sequence full → idle → fold_in (new users) → fold_in (new
  items) → full (events for known pairs, and events outside the data
  source's filter, escalate) on the recommendation engine, and the
  state file's keys and counters after each transition, after a torn
  state file, after an interrupted publish and after a resume from a
  checkpoint;
* ``PIO_TRAIN_CHAOS`` parsing;
* fold-in from ONE JAX-trained generation: the JAX package trains and
  publishes it into sqlite + localfs, the store is copied, the same new
  events go into both copies, and each package's trainer folds them in.
  The child generations have equal maps, factors within rtol 1e-5 /
  atol 1e-6, and equal manifest ``parent`` and ``watermark``;
* promotion against a fake router (done, rolled back, unreachable, a
  409 retried, a respawn mid-promotion, a 401 refusal, a swap the
  router lost): outcomes, router calls and the state file equal;
* ``POST /reload`` on the port's engine server: it swaps the served
  instance (the JAX server answers the same on the same store), keeps
  the last good generation when the newest is corrupt, reloads as
  usual when a single-tenant server is named a tenant (the JAX server
  ignores it too), answers 200 "already serving" to a canary of the
  generation it serves, and queries racing a reload all succeed.

The trainer's ``ComputeContext`` takes the CUDA device without one
passed and raises without CUDA. The card-only checks (the device
sampler on CUDA, ``/reload`` through the kernel) are in
``test_torch_gpu.py``.
"""

import concurrent.futures
import dataclasses
import datetime as dt
import json
import os
import shutil
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import predictionio_tpu.core as jax_core
import predictionio_tpu.core.persistence as jax_persistence
import predictionio_tpu.data.event as jax_event
import predictionio_tpu.data.storage as jax_storage
import predictionio_tpu.models.recommendation as jax_rec
import predictionio_tpu.ops.als as jax_als
import predictionio_tpu.training as jax_training
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer

import predictionio_tpu_torch.core as core
import predictionio_tpu_torch.core.persistence as persistence
import predictionio_tpu_torch.data.event as event_mod
import predictionio_tpu_torch.data.storage as storage_mod
import predictionio_tpu_torch.models.recommendation as rec
import predictionio_tpu_torch.ops.als as als
import predictionio_tpu_torch.training as training
from predictionio_tpu_torch.convert import als_model_from_numpy
from predictionio_tpu_torch.obs import MetricRegistry
from predictionio_tpu_torch.parallel.mesh import ComputeContext
from predictionio_tpu_torch.serving.engine_server import create_engine_server
from predictionio_tpu_torch.serving.http import HTTPServer, Response, Router

FACTOR_TOL = dict(rtol=1e-5, atol=1e-6)
T0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)


def _pkg(name):
    if name == "jax":
        return types.SimpleNamespace(
            name=name, core=jax_core, storage=jax_storage, event=jax_event,
            training=jax_training, rec=jax_rec, als=jax_als,
            persistence=jax_persistence,
            ctx=lambda: JaxContext.create(batch="trainer-parity"),
        )
    return types.SimpleNamespace(
        name=name, core=core, storage=storage_mod, event=event_mod,
        training=training, rec=rec, als=als, persistence=persistence,
        ctx=lambda: ComputeContext.create(device="cpu"),
    )


PKGS = ("torch", "jax")


def _env(kind, root):
    env = {
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": os.path.join(root, "models"),
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": os.path.join(root, "pio.sqlite"),
        "PIO_STORAGE_SOURCES_LOG_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_LOG_PATH": os.path.join(root, "eventlog"),
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }
    meta, events = {"memory": ("MEM", "MEM"), "sqlite": ("SQL", "SQL"),
                    "eventlog": ("SQL", "LOG")}[kind]
    env["PIO_STORAGE_REPOSITORIES_METADATA_SOURCE"] = meta
    env["PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE"] = events
    return env


def _storage(pkg, kind, root, app="tapp"):
    os.makedirs(root, exist_ok=True)
    storage = pkg.storage.Storage(env=_env(kind, str(root)))
    apps = storage.get_meta_data_apps()
    existing = apps.get_by_name(app)
    if existing is None:
        app_id = apps.insert(pkg.storage.App(0, app))
        storage.get_events().init(app_id)
    return storage


def _app_id(storage, app="tapp"):
    return storage.get_meta_data_apps().get_by_name(app).id


def _rate(pkg, user, item, rating=1.0, minute=0, name="rate"):
    return pkg.event.Event(
        event=name, entity_type="user", entity_id=user,
        target_entity_type="item", target_entity_id=item,
        properties={"rating": float(rating)},
        event_time=T0 + dt.timedelta(minutes=minute),
    )


def _seed_events(pkg, seed=3, n=60, users=8, items=6):
    rng = np.random.default_rng(seed)
    return [
        _rate(pkg, f"u{u}", f"i{i}", float(r), minute=m)
        for m, (u, i, r) in enumerate(zip(
            rng.integers(0, users, n), rng.integers(0, items, n),
            rng.integers(1, 6, n)))
    ]


# -- a fake (not ALS-shaped) engine in either package ---------------------------


def _fake_engine(pkg):
    c = pkg.core

    @dataclasses.dataclass(frozen=True)
    class P(c.Params):
        id: int = 0

    class DS(c.DataSource):
        params_class = P

        def read_training(self, ctx):
            return {"td": self.params.id}

    class Prep(c.Preparator):
        params_class = P

        def prepare(self, ctx, td):
            return {**td, "pd": self.params.id}

    class Algo(c.Algorithm):
        params_class = P

        def train(self, ctx, pd):
            return {**pd, "algo": self.params.id}

        def predict(self, model, query):
            return {"result": model["algo"]}

    class Serv(c.Serving):
        params_class = P

        def serve(self, query, predictions):
            return predictions[0]

    engine = c.Engine(DS, Prep, Algo, Serv)
    params = c.EngineParams(
        data_source=("", P(1)), preparator=("", P(2)),
        algorithms=[("", P(3))], serving=("", P()),
    )
    return engine, params


def _fake_trainer(pkg, storage, root, **config_kw):
    engine, params = _fake_engine(pkg)
    config = pkg.training.TrainerConfig(
        app_name="tapp", checkpoint_dir=os.path.join(str(root), "ckpt"),
        poll_interval_s=0.01, **config_kw,
    )
    return pkg.training.ContinuousTrainer(
        engine, params, engine_id="tr", config=config, storage=storage,
        ctx=pkg.ctx(), registry=_registry(pkg),
    )


def _registry(pkg):
    if pkg.name == "jax":
        from predictionio_tpu.obs import MetricRegistry as JaxRegistry

        return JaxRegistry()
    return MetricRegistry()


def _als_params(pkg, app="tapp", rank=4, iterations=2):
    return pkg.core.EngineParams(
        data_source=("", pkg.rec.RecDataSourceParams(
            app_name=app, event_names=("rate",))),
        preparator=("", pkg.rec.RecPreparatorParams()),
        algorithms=[("als", pkg.rec.ALSParams(
            rank=rank, num_iterations=iterations))],
        serving=("", pkg.core.EmptyParams()),
    )


def _als_trainer(pkg, storage, root, **config_kw):
    config = pkg.training.TrainerConfig(
        app_name="tapp", checkpoint_dir=os.path.join(str(root), "ckpt"),
        min_new_events=1, **config_kw,
    )
    return pkg.training.ContinuousTrainer(
        pkg.rec.recommendation_engine(), _als_params(pkg), engine_id="rec",
        config=config, storage=storage, ctx=pkg.ctx(),
        registry=_registry(pkg),
    )


#: state keys whose values are times or fresh ids
_VOLATILE = {"lastFullTrainAt", "lastTrainAt", "lastInstanceId",
             "promoteToken"}


def _norm_state(state):
    out = {}
    for k, v in state.items():
        if k in _VOLATILE:
            out[k] = "<set>" if v else v
        elif k == "lastPromotion":
            out[k] = {**v, "generation": "<id>"}
        else:
            out[k] = v
    return out


# -- watermarks -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["memory", "sqlite", "eventlog"])
def test_read_watermark_equal(tmp_path, kind):
    marks = {}
    for name in PKGS:
        pkg = _pkg(name)
        storage = _storage(pkg, kind, tmp_path / name)
        app_id = _app_id(storage)
        events = storage.get_events()
        empty = pkg.training.read_watermark(events, app_id)
        ch_id = storage.get_meta_data_channels().insert(
            pkg.storage.Channel(0, "side", app_id))
        events.init(app_id, ch_id)
        evs = _seed_events(pkg)
        events.insert_batch(evs[:40], app_id)
        events.insert_batch(evs[40:], app_id, ch_id)
        marks[name] = (
            empty,
            pkg.training.read_watermark(events, app_id),
            pkg.training.read_watermark(events, app_id, ch_id),
        )
    got = [(m.count, m.latest_time) for m in marks["torch"]]
    want = [(m.count, m.latest_time) for m in marks["jax"]]
    assert got == want
    assert got[0] == (0, "") and got[1][0] == 40 and got[2][0] == 20
    assert got[2][1] == (T0 + dt.timedelta(minutes=59)).isoformat()


@pytest.mark.parametrize("kind", ["sqlite", "eventlog"])
def test_read_watermark_across_packages_on_one_store(tmp_path, kind):
    jax = _pkg("jax")
    storage = _storage(jax, kind, tmp_path)
    storage.get_events().insert_batch(_seed_events(jax), _app_id(storage))
    want = jax.training.read_watermark(storage.get_events(),
                                       _app_id(storage))
    port = _storage(_pkg("torch"), kind, tmp_path)
    got = training.read_watermark(port.get_events(), _app_id(port))
    assert (got.count, got.latest_time) == (want.count, want.latest_time)


def test_watermark_json_round_trip():
    wm = training.Watermark(count=5, latest_time="2026-08-03T00:00:00+00:00")
    assert training.Watermark.from_json(wm.to_json()) == wm
    assert wm.to_json() == jax_training.Watermark(
        count=5, latest_time="2026-08-03T00:00:00+00:00").to_json()
    assert training.Watermark.from_json(None) == training.Watermark()


# -- the trigger policy -------------------------------------------------------------

_CONFIGS = [
    dict(),
    dict(min_new_events=3),
    dict(min_new_events=0, full_every_events=5),
    dict(min_new_events=2, full_every_events=10, full_every_s=60.0),
    dict(min_new_events=1, full_every_s=1e9),
]
_STATES = [
    {},
    {"lastFullTrainAt": "2000-01-01T00:00:00+00:00",
     "trainedWatermark": {"count": 4, "latestTime": ""},
     "fullTrainedCount": 4},
    {"lastFullTrainAt": "2100-01-01T00:00:00+00:00",
     "trainedWatermark": {"count": 4, "latestTime": ""},
     "fullTrainedCount": 0},
    {"lastFullTrainAt": "not a time",
     "trainedWatermark": {"count": 9, "latestTime": "x"},
     "fullTrainedCount": 2},
    {"lastFullTrainAt": "2000-01-01T00:00:00+00:00"},
]


@pytest.mark.parametrize("config", _CONFIGS, ids=range(len(_CONFIGS)))
def test_decide_equal_over_a_grid(tmp_path, config):
    decisions = {}
    for name in PKGS:
        pkg = _pkg(name)
        trainer = _fake_trainer(pkg, _storage(pkg, "memory", tmp_path / name),
                                tmp_path / name, **config)
        out = []
        for state in _STATES:
            trainer._state = dict(state)
            for count in (0, 1, 3, 4, 5, 6, 9, 10, 14, 20):
                out.append(trainer.decide(pkg.training.Watermark(count=count)))
        decisions[name] = out
    assert decisions["torch"] == decisions["jax"]
    assert {"full", "fold_in", "idle"} >= set(decisions["torch"])


# -- the poll sequence on the recommendation engine ----------------------------------


def _poll_script(pkg, trainer, storage):
    """Actions and normalized states along one script of events."""
    app_id = _app_id(storage)
    events = storage.get_events()
    steps = []

    def poll(label):
        action = trainer.poll_once()
        steps.append((label, action, _norm_state(trainer.state)))

    events.insert_batch(_seed_events(pkg), app_id)
    poll("first")
    poll("nothing new")
    events.insert_batch([
        _rate(pkg, "u_new1", "i0", 4, minute=100),
        _rate(pkg, "u_new1", "i2", 2, minute=101),
        _rate(pkg, "u_new2", "i1", 5, minute=102),
    ], app_id)
    poll("new users")
    events.insert_batch([
        _rate(pkg, "u0", "i_new", 3, minute=103),
        _rate(pkg, "u_new1", "i_new", 1, minute=104),
    ], app_id)
    poll("new item")
    events.insert(_rate(pkg, "u1", "i1", 2, minute=105), app_id)
    poll("known pair")
    events.insert(_rate(pkg, "u_viewer", "i0", 1, minute=106, name="view"),
                  app_id)
    poll("filtered event")
    return steps


def test_poll_sequence_and_state_equal(tmp_path):
    runs = {}
    for name in PKGS:
        pkg = _pkg(name)
        storage = _storage(pkg, "memory", tmp_path / name)
        pkg.storage.set_storage(storage)
        try:
            trainer = _als_trainer(pkg, storage, tmp_path / name)
            runs[name] = _poll_script(pkg, trainer, storage)
        finally:
            pkg.storage.set_storage(None)
    assert runs["torch"] == runs["jax"]
    actions = [a for _, a, _ in runs["torch"]]
    assert actions == ["full", "idle", "fold_in", "fold_in", "full", "full"]


def test_fold_in_generation_serves_new_users_alike(tmp_path):
    """The child generations of the same events have the same maps, and
    the new users' factors solve their normal equations in both."""
    children = {}
    for name in PKGS:
        pkg = _pkg(name)
        storage = _storage(pkg, "memory", tmp_path / name)
        pkg.storage.set_storage(storage)
        try:
            trainer = _als_trainer(pkg, storage, tmp_path / name)
            _poll_script(pkg, trainer, storage)
        finally:
            pkg.storage.set_storage(None)
        backend = storage.get_model_data_models()
        instances = storage.get_meta_data_engine_instances()
        fold = [i for i in instances.get_all() if i.batch == "fold-in"]
        children[name] = [
            (i.env["foldIn"], pkg.persistence.deserialize_models(
                pkg.persistence.load_generation(backend, i.id))[0][1])
            for i in sorted(fold, key=lambda i: i.env["foldIn"])
        ]
    for (env_t, m_t), (env_j, m_j) in zip(children["torch"],
                                          children["jax"]):
        assert env_t == env_j
        assert list(m_t.user_map.keys()) == list(m_j.user_map.keys())
        assert list(m_t.item_map.keys()) == list(m_j.item_map.keys())


def test_torn_state_file_and_interrupted_publish_equal(tmp_path):
    out = {}
    for name in PKGS:
        pkg = _pkg(name)
        storage = _storage(pkg, "memory", tmp_path / name)
        trainer = _fake_trainer(pkg, storage, tmp_path / name)
        path = trainer._config.resolved_state_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("{torn")
        torn = _fake_trainer(pkg, storage, tmp_path / name)
        row = [_norm_state(torn.state),
               torn.decide(pkg.training.Watermark(count=1))]
        ckpt = pkg.als.checkpoint_path(trainer._config.checkpoint_dir)
        np.savez(ckpt, iteration=9, user_factors=np.zeros(1),
                 item_factors=np.zeros(1))
        torn._state.update(
            phase="publishing", lastInstanceId="ghost",
            pendingWatermark={"count": 11, "latestTime": "t"}, fullTrains=1,
        )
        torn._save_state()
        reborn = _fake_trainer(pkg, storage, tmp_path / name)
        row += [_norm_state(reborn.state), os.path.exists(ckpt)]
        with open(path) as f:
            row.append(sorted(json.load(f)))
        out[name] = row
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == {} and out["torch"][1] == "full"
    assert out["torch"][2]["phase"] == "idle"
    assert out["torch"][2]["trainedWatermark"]["count"] == 11
    assert out["torch"][3] is False


def test_resume_provenance_equal(tmp_path):
    """A checkpoint left by a killed run: both record the iteration it
    resumed from, run the full train and delete the checkpoint."""
    out = {}
    for name in PKGS:
        pkg = _pkg(name)
        storage = _storage(pkg, "memory", tmp_path / name)
        trainer = _fake_trainer(pkg, storage, tmp_path / name)
        storage.get_events().insert(_rate(pkg, "u0", "i0"),
                                    _app_id(storage))
        ckpt_dir = trainer._config.checkpoint_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        np.savez(pkg.als.checkpoint_path(ckpt_dir), iteration=3,
                 user_factors=np.zeros((1, 2), np.float32),
                 item_factors=np.zeros((1, 2), np.float32))
        assert pkg.als.peek_checkpoint_iteration(ckpt_dir) == 3
        action = trainer.poll_once()
        out[name] = (action, _norm_state(trainer.state),
                     os.path.exists(pkg.als.checkpoint_path(ckpt_dir)),
                     trainer._registry.to_dict()["pio_trainer_runs_total"])
    assert out["torch"] == out["jax"]
    assert out["torch"][1]["resumedFromIteration"] == 3


def test_failed_full_train_equal(tmp_path):
    out = {}
    for name in PKGS:
        pkg = _pkg(name)
        storage = _storage(pkg, "memory", tmp_path / name)
        pkg.storage.set_storage(storage)
        try:
            trainer = _als_trainer(pkg, storage, tmp_path / name)
            # a "rate" event without a rating: the preparator has no
            # interactions, so the train fails
            storage.get_events().insert(
                _rate(pkg, "u0", "i0", name="view"), _app_id(storage))
            with pytest.raises(Exception):
                trainer.poll_once()
        finally:
            pkg.storage.set_storage(None)
        out[name] = (_norm_state(trainer.state),
                     trainer._registry.to_dict()["pio_trainer_runs_total"])
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["phase"] == "failed"


@pytest.mark.parametrize("raw", [
    None, "", "epoch_sleep:0.25", "epoch_sleep:2", " epoch_sleep : 1.5 ",
    "epoch_sleep:-3", "epoch_sleep:abc", "other:1;epoch_sleep:0.5",
    "epoch_sleep:0.1;epoch_sleep:9", "epoch_sleep", "garbage",
])
def test_train_chaos_parses_alike(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("PIO_TRAIN_CHAOS", raising=False)
    else:
        monkeypatch.setenv("PIO_TRAIN_CHAOS", raw)
    assert als._train_chaos_sleep_s() == jax_als._train_chaos_sleep_s()


def test_train_chaos_sleeps_between_epochs(monkeypatch, tmp_path):
    slept = []
    monkeypatch.setenv("PIO_TRAIN_CHAOS", "epoch_sleep:0.001")
    monkeypatch.setattr(als.time, "sleep", slept.append)
    rng = np.random.default_rng(0)
    als.train_als(ComputeContext.create(device="cpu"),
                  rng.integers(0, 5, 30), rng.integers(0, 4, 30),
                  np.ones(30, np.float32), 5, 4, rank=2, iterations=4)
    assert slept == [0.001]  # one fused dispatch without checkpoints
    slept.clear()
    # a timer times the same loop: one dispatch, one sleep
    als.train_als(ComputeContext.create(device="cpu"),
                  rng.integers(0, 5, 30), rng.integers(0, 4, 30),
                  np.ones(30, np.float32), 5, 4, rank=2, iterations=4,
                  checkpoint_dir=None, checkpoint_every=0,
                  timer=__import__(
                      "predictionio_tpu_torch.utils.profiling",
                      fromlist=["StepTimer"]).StepTimer())
    assert slept == [0.001]
    slept.clear()
    als.train_als(ComputeContext.create(device="cpu"),
                  rng.integers(0, 5, 30), rng.integers(0, 4, 30),
                  np.ones(30, np.float32), 5, 4, rank=2, iterations=4,
                  checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert slept == [0.001] * 4  # one per checkpointed epoch


def test_trainer_refuses_to_fall_back(tmp_path, monkeypatch):
    storage = _storage(_pkg("torch"), "memory", tmp_path)
    engine, params = _fake_engine(_pkg("torch"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.ContinuousTrainer(
            engine, params, "tr",
            training.TrainerConfig(app_name="tapp",
                                   checkpoint_dir=str(tmp_path / "c")),
            storage=storage,
        )


def test_unknown_app_and_channel_refused_alike(tmp_path):
    for name in PKGS:
        pkg = _pkg(name)
        storage = _storage(pkg, "memory", tmp_path / name)
        engine, params = _fake_engine(pkg)
        for cfg, match in ((dict(app_name="nope"), "does not exist"),
                           (dict(app_name="tapp", channel_name="nope"),
                            "not found")):
            with pytest.raises(ValueError, match=match):
                pkg.training.ContinuousTrainer(
                    engine, params, "tr", pkg.training.TrainerConfig(
                        checkpoint_dir=str(tmp_path / name / "c"), **cfg),
                    storage=storage, ctx=pkg.ctx())
        with pytest.raises(ValueError, match="checkpoint_dir or state_path"):
            pkg.training.TrainerConfig(app_name="x").resolved_state_path()


# -- fold-in from one JAX-trained generation -------------------------------------------


def test_fold_in_from_one_jax_generation(tmp_path):
    jax = _pkg("jax")
    base = tmp_path / "a"
    storage = _storage(jax, "sqlite", base)
    app_id = _app_id(storage)
    storage.get_events().insert_batch(_seed_events(jax, seed=8, n=120,
                                                   users=12, items=9),
                                      app_id)
    jax.storage.set_storage(storage)
    try:
        trainer = _als_trainer(jax, storage, base)
        assert trainer.poll_once() == "full"
    finally:
        jax.storage.set_storage(None)
    parent = trainer.state["lastInstanceId"]
    shutil.copytree(base, tmp_path / "b")

    new = [("u_new1", "i0", 4), ("u_new1", "i3", 2), ("u_new2", "i1", 5),
           ("u_new2", "i_new", 3), ("u2", "i_new", 1), ("u5", "i_new2", 2)]
    children = {}
    for name, root in (("jax", base), ("torch", tmp_path / "b")):
        pkg = _pkg(name)
        st = storage if name == "jax" else _storage(pkg, "sqlite", root)
        st.get_events().insert_batch(
            [_rate(pkg, u, i, r, minute=500 + m)
             for m, (u, i, r) in enumerate(new)], _app_id(st))
        pkg.storage.set_storage(st)
        try:
            tr = _als_trainer(pkg, st, root)
            assert tr.state["lastInstanceId"] == parent
            assert tr.poll_once() == "fold_in"
        finally:
            pkg.storage.set_storage(None)
        child = tr.state["lastInstanceId"]
        backend = st.get_model_data_models()
        manifest = pkg.persistence.load_manifest(backend, child)
        model = pkg.persistence.deserialize_models(
            pkg.persistence.load_generation(backend, child))[0][1]
        children[name] = (manifest, model, tr.state)
    (m_t, got, s_t), (m_j, want, s_j) = children["torch"], children["jax"]
    assert m_t["parent"] == m_j["parent"] == parent
    assert m_t["watermark"] == m_j["watermark"]
    assert m_t["watermark"]["count"] == 126
    assert list(got.user_map.keys()) == list(want.user_map.keys())
    assert list(got.item_map.keys()) == list(want.item_map.keys())
    np.testing.assert_allclose(got.user_factors,
                               np.asarray(want.user_factors), **FACTOR_TOL)
    np.testing.assert_allclose(got.item_factors,
                               np.asarray(want.item_factors), **FACTOR_TOL)
    assert _norm_state(s_t) == _norm_state(s_j)


def test_fold_in_model_takes_cuda_like_tensors_to_host():
    """A generation holding torch tensors (as a staged model does) is
    copied to the host; the child's factors are numpy."""
    rng = np.random.default_rng(1)
    model = als_model_from_numpy(
        rng.normal(size=(2, 3)), rng.normal(size=(2, 3)),
        np.array(["u0", "u1"]), np.array(["i0", "i1"]))
    staged = dataclasses.replace(
        model, user_factors=torch.as_tensor(model.user_factors),
        item_factors=torch.as_tensor(model.item_factors))
    from predictionio_tpu_torch.data.eventframe import Interactions
    from predictionio_tpu_torch.utils.bimap import BiMap

    inter = Interactions(
        entity_map=BiMap(np.array(["u0", "u2"])),
        target_map=BiMap(np.array(["i0", "i1", "i9"])),
        rows=np.array([1, 1, 0], np.int32), cols=np.array([0, 2, 2],
                                                          np.int32),
        values=np.array([4.0, 1.0, 2.0], np.float32),
        times=np.zeros(3, np.int64),
    )
    a, n_u, n_i = training.ContinuousTrainer._fold_in_model(staged, inter)
    b, _, _ = training.ContinuousTrainer._fold_in_model(model, inter)
    assert (n_u, n_i) == (1, 1)
    assert isinstance(a.user_factors, np.ndarray)
    assert isinstance(a.item_factors, np.ndarray)
    np.testing.assert_array_equal(a.user_factors, b.user_factors)
    np.testing.assert_array_equal(a.item_factors, b.item_factors)


# -- promotion against a fake router ------------------------------------------------------


class FakeFleetRouter:
    """A router-shaped HTTP server: ONE swap record per token; the first
    status poll flips it to ``final_phase``; ``busy`` 409s come first;
    ``refuse`` answers every swap with that status; ``forget`` drops the
    record right after opening it (a router restarted without its state
    file)."""

    def __init__(self, final_phase="done", busy=0, refuse=None,
                 forget=False):
        self.final_phase = final_phase
        self.busy = busy
        self.refuse = refuse
        self.forget = forget
        self.tokens, self.keys, self.swaps = [], [], {}
        router = Router()
        router.route("POST", "/admin/swap", self._swap)
        router.route("GET", "/admin/swap/<sid>", self._get)
        self.http = HTTPServer(router, host="127.0.0.1", port=0)
        self.http.start()
        self.url = f"http://127.0.0.1:{self.http.port}"

    def _swap(self, request):
        body = request.json()
        token = body.get("token", "")
        self.tokens.append(token)
        self.keys.append(request.headers.get("X-PIO-Server-Key"))
        if self.refuse:
            return Response(self.refuse, {"message": "server key required"})
        if self.busy:
            self.busy -= 1
            return Response(409, {"message": "gate held"})
        record = self.swaps.get(token)
        if record is None:
            record = {"id": f"swap-{len(self.swaps) + 1}", "token": token,
                      "phase": "warming",
                      "generation": body.get("generation")}
            if not self.forget:
                self.swaps[token] = record
            return Response(202, record)
        return Response(200, record)

    def _get(self, request):
        for record in self.swaps.values():
            if record["id"] == request.path_params["sid"]:
                record["phase"] = self.final_phase
                return Response(200, record)
        return Response(404, {"message": "unknown swap"})

    def close(self):
        self.http.shutdown()


def _promotion_run(pkg, root, scenario):
    storage = _storage(pkg, "memory", root)
    fleet = None
    if scenario == "unreachable":
        import socket

        with socket.socket() as s:  # a port nothing listens on
            s.bind(("127.0.0.1", 0))
            url = f"http://127.0.0.1:{s.getsockname()[1]}"
    else:
        fleet = FakeFleetRouter(
            final_phase="rolled_back" if scenario == "rolled_back"
            else "done",
            busy=2 if scenario == "busy" else 0,
            refuse=401 if scenario == "refused" else None,
            forget=scenario == "lost")
        url = fleet.url
    try:
        trainer = _fake_trainer(pkg, storage, root, router_url=url,
                                router_key="sekrit", promote_timeout_s=20)
        storage.get_events().insert(_rate(pkg, "u0", "i0"),
                                    _app_id(storage))
        if scenario == "respawn":
            wm = pkg.training.read_watermark(
                storage.get_events(), trainer._app_id)
            generation = trainer.full_train(wm)  # killed before promote()
            mid = _norm_state(trainer.state)
            reborn = _fake_trainer(pkg, storage, root, router_url=url,
                                   router_key="sekrit")
            action = reborn.poll_once()
            trainer = reborn
        else:
            mid = None
            action = trainer.poll_once()
            generation = trainer.state["lastInstanceId"]
        calls = None
        if fleet is not None:
            calls = ([t == generation for t in fleet.tokens], fleet.keys,
                     len(fleet.swaps))
        return (action, mid, _norm_state(trainer.state), calls,
                trainer._registry.to_dict()["pio_trainer_promotions_total"])
    finally:
        if fleet is not None:
            fleet.close()


@pytest.mark.parametrize("scenario", [
    "done", "rolled_back", "unreachable", "busy", "respawn", "refused",
    "lost",
])
def test_promotion_outcomes_equal(tmp_path, scenario):
    got = _promotion_run(_pkg("torch"), tmp_path / "t", scenario)
    want = _promotion_run(_pkg("jax"), tmp_path / "j", scenario)
    assert got == want
    outcome = got[2]["lastPromotion"]["outcome"]
    assert outcome == {"done": "done", "rolled_back": "rolled_back",
                       "unreachable": "unreachable", "busy": "done",
                       "respawn": "done", "refused": "refused",
                       "lost": "lost"}[scenario]
    assert got[2]["phase"] == "idle" and "promoteToken" not in got[2]
    if scenario == "respawn":
        assert got[1]["phase"] == "promoting"


def test_no_router_means_publish_only(tmp_path):
    pkg = _pkg("torch")
    storage = _storage(pkg, "memory", tmp_path)
    trainer = _fake_trainer(pkg, storage, tmp_path)
    assert trainer.promote("any") is None
    trainer._state.update(phase="promoting", promoteToken="g")
    trainer._save_state()
    reborn = _fake_trainer(pkg, storage, tmp_path)
    reborn.poll_once()
    assert reborn.state["phase"] == "idle"
    assert "promoteToken" not in reborn.state


def test_run_forever_polls_until_stopped(tmp_path):
    import threading

    pkg = _pkg("torch")
    storage = _storage(pkg, "memory", tmp_path)
    trainer = _fake_trainer(pkg, storage, tmp_path)
    storage.get_events().insert(_rate(pkg, "u0", "i0"), _app_id(storage))
    stop = threading.Event()
    thread = threading.Thread(target=trainer.run_forever, args=(stop,))
    thread.start()
    try:
        for _ in range(500):
            if trainer.state.get("fullTrains"):
                break
            stop.wait(0.01)
    finally:
        stop.set()
        thread.join(10)
    assert not thread.is_alive()
    assert trainer.state["fullTrains"] == 1
    runs = trainer._registry.to_dict()["pio_trainer_runs_total"]
    assert runs["samples"] == [
        {"labels": {"kind": "full", "outcome": "completed"}, "value": 1.0}]


# -- POST /reload -------------------------------------------------------------------------


def _post(base, path, body=None, raw=None):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else b"")
    req = urllib.request.Request(base + path, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _publish(pkg, storage, seed, n_users=10, n_items=12, k=4):
    """One COMPLETED ALS generation of random factors; returns its id
    and the factors."""
    rng = np.random.default_rng(seed)
    users = rng.normal(size=(n_users, k)).astype(np.float32)
    items = rng.normal(size=(n_items, k)).astype(np.float32)
    model = als_model_from_numpy(
        users, items, np.char.add("u", np.arange(n_users).astype(str)),
        np.char.add("i", np.arange(n_items).astype(str)))
    now = dt.datetime.now(dt.timezone.utc)
    instances = storage.get_meta_data_engine_instances()
    iid = instances.insert(pkg.storage.EngineInstance(
        id="", status="INIT", start_time=now, end_time=now,
        engine_id="rec", engine_version="1", engine_variant="default",
        engine_factory="recommendation"))
    blob = persistence.serialize_models(iid, [rec.ALSAlgorithm()], [model])
    persistence.publish_generation(storage.get_model_data_models(), iid,
                                   blob)
    instance = instances.get(iid)
    instances.update(dataclasses.replace(instance, status="COMPLETED"))
    return iid, users, items


def _top(users, items, u, num):
    scores = items @ users[u]
    order = np.lexsort((np.arange(len(scores)), -scores))[:num]
    return [f"i{j}" for j in order]


@pytest.fixture()
def served(tmp_path):
    pkg = _pkg("torch")
    storage = _storage(pkg, "memory", tmp_path)
    g1 = _publish(pkg, storage, seed=1)
    engine = rec.recommendation_engine()
    es, http = create_engine_server(
        engine, engine.params_from_variant({}), "rec", host="127.0.0.1",
        port=0, storage=storage, ctx=ComputeContext.create(device="cpu"),
        max_batch=8,
    )
    http.start()
    base = f"http://127.0.0.1:{http.port}"
    yield types.SimpleNamespace(storage=storage, base=base, g1=g1, es=es,
                                pkg=pkg)
    es.close()


def _answer_items(base, user, num=5):
    status, body = _post(base, "/queries.json", {"user": user, "num": num})
    assert status == 200, body
    return [e["item"] for e in body["itemScores"]]


def test_reload_swaps_the_served_instance(served):
    iid1, u1, i1 = served.g1
    assert _answer_items(served.base, "u3") == _top(u1, i1, 3, 5)
    iid2, u2, i2 = _publish(served.pkg, served.storage, seed=2, n_items=15)
    status, body = _post(served.base, "/reload")
    assert (status, body) == (200, {"message": "reloaded",
                                    "engineInstanceId": iid2})
    assert _answer_items(served.base, "u3") == _top(u2, i2, 3, 5)
    with urllib.request.urlopen(served.base + "/", timeout=10) as resp:
        info = json.loads(resp.read())
    assert info["engineInstanceId"] == iid2 and info["generation"] == 2
    # the batch route is served by the new generation too
    status, out = _post(served.base, "/batch/queries.json",
                        [{"user": "u1", "num": 3}])
    assert [e["item"] for e in out[0]["prediction"]["itemScores"]] == (
        _top(u2, i2, 1, 3))


def test_reload_keeps_the_last_good_generation(served):
    iid2, u2, i2 = _publish(served.pkg, served.storage, seed=2)
    assert _post(served.base, "/reload")[1]["engineInstanceId"] == iid2
    iid3, _, _ = _publish(served.pkg, served.storage, seed=3)
    backend = served.storage.get_model_data_models()
    blob = bytearray(backend.get(iid3).models)
    blob[len(blob) // 2] ^= 0xFF
    backend.insert(storage_mod.Model(id=iid3, models=bytes(blob)))
    status, body = _post(served.base, "/reload")
    assert (status, body["engineInstanceId"]) == (200, iid2)
    assert backend.get(iid3) is None  # quarantined
    assert _answer_items(served.base, "u4") == _top(u2, i2, 4, 5)


@pytest.mark.parametrize("body, raw, status, needle", [
    ({"canary": True}, None, 200, "already serving"),
    ({"tenant": "acme"}, None, 200, "reloaded"),  # one tenant: ignored
    (None, b"{not json", 400, "JSON"),
    ([1, 2], None, 400, "JSON object"),
    ({"canary": False}, None, 200, "reloaded"),
    ({}, None, 200, "reloaded"),
])
def test_reload_refusals(served, body, raw, status, needle):
    got_status, got = _post(served.base, "/reload", body=body, raw=raw)
    assert got_status == status
    assert needle in got["message"]


def test_queries_racing_reload_all_succeed(served):
    _publish(served.pkg, served.storage, seed=2)

    def query(i):
        return _post(served.base, "/queries.json",
                     {"user": f"u{i % 10}", "num": 3})[0]

    def batch(i):
        return _post(served.base, "/batch/queries.json",
                     [{"user": f"u{j}", "num": 2} for j in range(4)])

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        singles = [pool.submit(query, i) for i in range(120)]
        batches = [pool.submit(batch, i) for i in range(20)]
        reloads = [_post(served.base, "/reload")[0] for _ in range(6)]
        statuses = [f.result() for f in singles]
        batch_out = [f.result() for f in batches]
    assert reloads == [200] * 6
    assert statuses == [200] * 120
    for status, out in batch_out:
        assert status == 200
        assert all(r["status"] in (200, 503) for r in out), out
        if any(r["status"] == 503 for r in out):
            assert all(r["message"] == "server is reloading; retry"
                       for r in out if r["status"] == 503)


def test_reload_answers_like_the_jax_server(tmp_path):
    """Both servers on one sqlite + localfs store: after a new
    generation each /reload names the same instance."""
    jax = _pkg("jax")
    port = _pkg("torch")
    storage = _storage(port, "sqlite", tmp_path)
    _publish(port, storage, seed=1)
    jax_storage_ = _storage(jax, "sqlite", tmp_path)
    engine = rec.recommendation_engine()
    es, http = create_engine_server(
        engine, engine.params_from_variant({}), "rec", host="127.0.0.1",
        port=0, storage=storage, ctx=ComputeContext.create(device="cpu"),
        max_batch=4)
    jengine = jax_rec.recommendation_engine()
    jes = JaxServer(jengine, jengine.params_from_variant({}), "rec",
                    storage=jax_storage_, max_batch=4, admission=False)
    jhttp = jes.serve(host="127.0.0.1", port=0)
    http.start()
    jhttp.start()
    try:
        iid2, _, _ = _publish(port, storage, seed=2)
        got = _post(f"http://127.0.0.1:{http.port}", "/reload")
        want = _post(f"http://127.0.0.1:{jhttp.port}", "/reload",
                     body={"canary": False})
        assert got == want == (200, {"message": "reloaded",
                                     "engineInstanceId": iid2})
    finally:
        es.close()
        jes.close()
