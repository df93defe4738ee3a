"""Evaluation and tuning: the port against the JAX package.

* ``kfold_indices`` and ``split_data`` give equal folds exactly.
* ``RecDataSource.read_eval`` gives equal folds (training interactions,
  queries in the same order, equal actuals) from the same events in both
  packages' memory stores and from one sqlite file both read.
* Every metric class, ``MetricEvaluator``'s pick and the three
  renderings of ``MetricEvaluatorResult`` are equal on one set of eval
  data (fake engines whose predictions encode the pipeline).
* ``Engine.eval`` and ``run_evaluation`` over the recommendation example's
  grid shape (eval_k 3, ranks 8 and 16, 2 iterations, small sizes), each
  rank starting both packages from one shared iteration-0 checkpoint
  (``jax.random`` cannot be reproduced). ``checkpoint_every=0`` with
  ``resume=True`` only reads the checkpoint in both packages, so every
  fold and candidate of a rank starts from the same file, and every fold
  trains factors of one shape (the folds keep the full entity maps).
  Scores agree within rtol 1e-3 / atol 1e-4 (``test_torch_als.py``'s
  epoch tolerance); predicted lists are equal except where the JAX
  model's plain scores of two swapped items tie within
  1e-4 + 1e-5·|s|; the metric values agree within 1e-6 where the lists
  are equal; the best index and the best.json written are the same.
* ``FastEvalEngine`` counts the same cache hits as the JAX package's,
  reads the data source once per distinct params and single-flights
  under 4 threads; ``run_evaluation``'s instance goes INIT →
  EVALCOMPLETED or FAILED, and with no ctx it raises without CUDA.
* The flow of ``examples/recommendation/evaluation.py`` (its
  ``PrecisionAtK`` and grid) runs on the port.
* A ``DataView`` npz written by either package is read by the other.
"""

import dataclasses
import datetime as dt
import importlib.util
import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from predictionio_tpu.core import Engine as JaxEngine
from predictionio_tpu.core import EngineParams as JaxEngineParams
from predictionio_tpu.core.crossvalidation import split_data as jax_split
from predictionio_tpu.core.evaluation import (
    AverageMetric as JaxAverage,
    Evaluation as JaxEvaluation,
    MetricEvaluator as JaxMetricEvaluator,
    OptionAverageMetric as JaxOptionAverage,
    OptionStdevMetric as JaxOptionStdev,
    StdevMetric as JaxStdev,
    SumMetric as JaxSum,
    ZeroMetric as JaxZero,
    kfold_indices as jax_kfold,
)
from predictionio_tpu.core.fasteval import FastEvalEngine as JaxFastEval
from predictionio_tpu.core.workflow import run_evaluation as jax_run_eval
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import (
    App as JaxApp,
    Storage as JaxStorage,
    set_storage as jax_set_storage,
)
from predictionio_tpu.data.store import EventStore as JaxEventStore
from predictionio_tpu.data.view import DataView as JaxDataView
from predictionio_tpu.models import recommendation as jax_rec
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu_torch.core import (
    Algorithm,
    DataSource,
    Engine,
    EngineParams,
    Params,
    Preparator,
    Serving,
)
from predictionio_tpu_torch.core.controller import params_from_json
from predictionio_tpu_torch.core.crossvalidation import split_data
from predictionio_tpu_torch.core.evaluation import (
    AverageMetric,
    Evaluation,
    MetricEvaluator,
    OptionAverageMetric,
    OptionStdevMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
    kfold_indices,
)
from predictionio_tpu_torch.core.fasteval import FastEvalEngine
from predictionio_tpu_torch.core.workflow import run_evaluation
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage, set_storage
from predictionio_tpu_torch.data.store import EventStore
from predictionio_tpu_torch.data.view import DataView
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.ops.als import _write_checkpoint, checkpoint_path
from predictionio_tpu_torch.parallel.mesh import ComputeContext

ROOT = pathlib.Path(__file__).resolve().parents[1]
APP = "evalapp"
N_USERS, N_ITEMS, N_EVENTS = 50, 40, 900
EPOCHS = dict(rtol=1e-3, atol=1e-4)
T0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)


@pytest.fixture()
def cpu():
    return ComputeContext.create(device="cpu")


# -- folds ---------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(0, 2), (1, 3), (10, 3), (11, 2), (97, 5)])
def test_kfold_indices_match_jax(n, k):
    got = list(kfold_indices(n, k))
    want = list(jax_kfold(n, k))
    assert len(got) == len(want) == k
    for (gf, gtr, gte), (wf, wtr, wte) in zip(got, want):
        assert gf == wf
        np.testing.assert_array_equal(gtr, wtr)
        np.testing.assert_array_equal(gte, wte)
    with pytest.raises(ValueError):
        next(kfold_indices(n, 1))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_split_data_matches_jax(k):
    data = [f"d{i}" for i in range(13)]

    def run(split):
        return split(k, data, lambda tr: tuple(tr),
                     lambda d: ({"q": d}, d.upper()))

    assert run(split_data) == run(jax_split)
    with pytest.raises(ValueError):
        split_data(1, data, list, lambda d: (d, d))


# -- read_eval -----------------------------------------------------------------


def _rate_events(event_cls, seed=11):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, N_USERS, N_EVENTS)
    items = rng.zipf(1.3, N_EVENTS) % N_ITEMS
    ratings = rng.integers(1, 6, N_EVENTS)
    return [
        event_cls(event="rate", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{i}",
                  properties={"rating": int(r)},
                  event_time=T0 + dt.timedelta(seconds=j))
        for j, (u, i, r) in enumerate(zip(users, items, ratings))
    ]


def _memory(storage_cls, app_cls, event_cls):
    env = {
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
    }
    storage = storage_cls(env=env)
    app_id = storage.get_meta_data_apps().insert(app_cls(0, APP))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(_rate_events(event_cls), app_id)
    return storage


def _sqlite_env(path):
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(path),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


@pytest.fixture(scope="module")
def storages():
    return (_memory(JaxStorage, JaxApp, JaxEvent),
            _memory(Storage, App, Event))


def _read_eval(kind, storages, tmp_path, eval_k):
    if kind == "memory":
        jax_storage, storage = storages
    else:  # one sqlite file: the JAX package writes it, both read it
        env = _sqlite_env(tmp_path / "pio.sqlite")
        jax_storage = JaxStorage(env=env)
        app_id = jax_storage.get_meta_data_apps().insert(JaxApp(0, APP))
        jax_storage.get_events().init(app_id)
        jax_storage.get_events().insert_batch(_rate_events(JaxEvent), app_id)
        storage = Storage(env=env)
    jax_set_storage(jax_storage)
    try:
        want = jax_rec.RecDataSource(jax_rec.RecDataSourceParams(
            app_name=APP, eval_k=eval_k)).read_eval(JaxContext.create())
    finally:
        jax_set_storage(None)
    set_storage(storage)
    try:
        got = rec.RecDataSource(rec.RecDataSourceParams(
            app_name=APP, eval_k=eval_k)).read_eval(
                ComputeContext.create(device="cpu"))
    finally:
        set_storage(None)
    return got, want


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
@pytest.mark.parametrize("eval_k", [2, 3])
def test_read_eval_matches_jax(kind, eval_k, storages, tmp_path):
    got, want = _read_eval(kind, storages, tmp_path, eval_k)
    assert len(got) == len(want) == eval_k
    held_out = 0
    for (g_td, g_info, g_qa), (w_td, w_info, w_qa) in zip(got, want):
        assert g_info == w_info
        gi, wi = g_td.interactions, w_td.interactions
        # the full maps: every fold trains factors of one shape
        assert gi.entity_map.keys().tolist() == wi.entity_map.keys().tolist()
        assert gi.target_map.keys().tolist() == wi.target_map.keys().tolist()
        assert (gi.n_rows, gi.n_cols) == (len(set(
            e.entity_id for e in _rate_events(Event))), len(set(
                e.target_entity_id for e in _rate_events(Event))))
        for col in ("rows", "cols", "values", "times"):
            np.testing.assert_array_equal(getattr(gi, col), getattr(wi, col))
        assert g_qa == w_qa  # same queries, same order, equal actuals
        for q, actual in g_qa:
            assert q["num"] == max(10, len(actual))
        held_out += sum(len(a) for _q, a in g_qa)
    assert held_out == N_EVENTS


def test_read_eval_needs_two_folds(storages, cpu):
    set_storage(storages[1])
    try:
        with pytest.raises(ValueError):
            rec.RecDataSource(rec.RecDataSourceParams(
                app_name=APP, eval_k=0)).read_eval(cpu)
    finally:
        set_storage(None)


# -- metrics and the evaluator on fake engines ---------------------------------------


def _fakes(base):
    """Fake DASE components over ``base`` (either package's core), whose
    predictions encode the pipeline (1000·ds + 100·prep + 10·algo + q)."""
    Params_, DS, Prep, Algo, Serv = base

    @dataclasses.dataclass(frozen=True)
    class FakeParams(Params_):
        id: int = 0
        error: bool = False

    class FakeDataSource(DS):
        params_class = FakeParams
        reads = 0
        delay = 0.0
        lock = threading.Lock()

        def read_training(self, ctx):
            return self.params.id

        def read_eval(self, ctx):
            with type(self).lock:
                type(self).reads += 1
            time.sleep(type(self).delay)
            if self.params.error:
                raise ValueError("data source eval error")
            return [(self.params.id, {"fold": k},
                     [(q, q * 10) for q in range(3)]) for k in range(2)]

    class FakePreparator(Prep):
        params_class = FakeParams

        def prepare(self, ctx, td):
            return (td, self.params.id)

    class FakeAlgorithm(Algo):
        params_class = FakeParams

        def train(self, ctx, pd):
            return (*pd, self.params.id)

        def predict(self, model, query):
            ds, prep, algo = model
            return ds * 1000 + prep * 100 + algo * 10 + query

    class FakeServing(Serv):
        params_class = FakeParams

        def serve(self, query, predictions):
            return sum(predictions)

    return FakeParams, FakeDataSource, FakePreparator, FakeAlgorithm, \
        FakeServing


from predictionio_tpu.core import (  # noqa: E402
    Algorithm as JaxAlgorithm,
    DataSource as JaxDataSource,
    Params as JaxParams,
    Preparator as JaxPreparator,
    Serving as JaxServing,
)

PORT_FAKES = _fakes((Params, DataSource, Preparator, Algorithm, Serving))
JAX_FAKES = _fakes((JaxParams, JaxDataSource, JaxPreparator, JaxAlgorithm,
                    JaxServing))


def _fake_engine(fakes, cls):
    return cls(*fakes[1:])


def _fake_grid(fakes, params_cls, ids=((1, 4), (3, 9), (2, 5))):
    p = fakes[0]
    return [params_cls(data_source=("", p(id=1)), preparator=("", p(id=prep)),
                       algorithms=[("", p(id=algo))], serving=("", p()))
            for prep, algo in ids]


def _metric_classes(avg, opt_avg, total, stdev, opt_stdev):
    """One subclass of each point metric: the point is the prediction
    (None for odd queries in the Option ones)."""
    def point(self, ei, q, p, a):
        return float(p) / 1000.0

    def option_point(self, ei, q, p, a):
        return None if q % 2 else float(p) / 1000.0

    return [type(base.__name__, (base,), {"calculate_point": fn})
            for base, fn in ((avg, point), (opt_avg, option_point),
                             (total, point), (stdev, point),
                             (opt_stdev, option_point))]


def _port_echo():
    """The port's AverageMetric of the prediction itself (over 1000)."""
    return _metric_classes(AverageMetric, OptionAverageMetric, SumMetric,
                           StdevMetric, OptionStdevMetric)[0]()


EVAL_DATA = [({"fold": 0}, [(0, 1234.0, 0), (1, 1500.0, 10),
                            (2, 987.5, 20)]),
             ({"fold": 1}, [(3, 42.0, 30), (4, 7.25, 40)])]


@pytest.mark.parametrize("i", range(6))
def test_every_metric_class_matches_jax(i):
    got = _metric_classes(AverageMetric, OptionAverageMetric, SumMetric,
                          StdevMetric, OptionStdevMetric) + [ZeroMetric]
    want = _metric_classes(JaxAverage, JaxOptionAverage, JaxSum, JaxStdev,
                           JaxOptionStdev) + [JaxZero]
    g, w = got[i](), want[i]()
    assert g.header == w.header
    assert g.higher_is_better == w.higher_is_better
    assert g.calculate(EVAL_DATA) == w.calculate(EVAL_DATA)
    assert g.calculate([]) == w.calculate([])
    assert g.compare(1.0, 2.0) == w.compare(1.0, 2.0)


def _fake_results(tmp_path):
    """The same three-candidate sweep through both packages'
    MetricEvaluator with an other-metric; returns (port, jax) results."""
    port_metrics = _metric_classes(AverageMetric, OptionAverageMetric,
                                   SumMetric, StdevMetric, OptionStdevMetric)
    jax_metrics = _metric_classes(JaxAverage, JaxOptionAverage, JaxSum,
                                  JaxStdev, JaxOptionStdev)
    cpu = ComputeContext.create(device="cpu")
    got = MetricEvaluator(
        port_metrics[0](), [port_metrics[3](), ZeroMetric()],
        output_path=str(tmp_path / "port.json"),
    ).evaluate(cpu, _fake_engine(PORT_FAKES, Engine),
               _fake_grid(PORT_FAKES, EngineParams))
    want = JaxMetricEvaluator(
        jax_metrics[0](), [jax_metrics[3](), JaxZero()],
        output_path=str(tmp_path / "jax.json"),
    ).evaluate(JaxContext.create(), _fake_engine(JAX_FAKES, JaxEngine),
               _fake_grid(JAX_FAKES, JaxEngineParams))
    return got, want


def test_metric_evaluator_result_renders_as_jax(tmp_path):
    got, want = _fake_results(tmp_path)
    assert got.best_idx == want.best_idx == 1
    assert got.to_one_liner() == want.to_one_liner()
    assert got.to_json() == want.to_json()
    assert got.to_html() == want.to_html()
    assert [s.other_scores for _p, s in got.engine_params_scores] == [
        s.other_scores for _p, s in want.engine_params_scores]
    assert (tmp_path / "port.json").read_bytes() == (
        tmp_path / "jax.json").read_bytes()
    assert json.loads((tmp_path / "port.json").read_text())[
        "algorithms"][0]["params"]["id"] == 9


def test_metric_evaluator_refuses_an_empty_grid(cpu):
    with pytest.raises(ValueError):
        MetricEvaluator(ZeroMetric()).evaluate(
            cpu, _fake_engine(PORT_FAKES, Engine), [])


@pytest.mark.parametrize("parallelism", [1, 4])
def test_fast_eval_cache_hits_match_jax(parallelism, cpu):
    grid = _fake_grid(PORT_FAKES, EngineParams, ((1, 3), (1, 5), (1, 7)))
    engine = _fake_engine(PORT_FAKES, FastEvalEngine)
    MetricEvaluator(ZeroMetric(), parallelism=parallelism).evaluate(
        cpu, engine, grid)
    jax_engine = _fake_engine(JAX_FAKES, JaxFastEval)
    JaxMetricEvaluator(JaxZero(), parallelism=parallelism).evaluate(
        JaxContext.create(), jax_engine,
        _fake_grid(JAX_FAKES, JaxEngineParams, ((1, 3), (1, 5), (1, 7))))
    assert engine.cache_hits == jax_engine.cache_hits == {
        "data_source": 4, "preparator": 4, "algorithms": 0, "predict": 0}
    assert len(engine._data_source_cache) == 1
    assert len(engine._algorithms_cache) == 3 * 2


def test_fast_eval_single_flights_under_four_threads(cpu):
    fake_ds = PORT_FAKES[1]
    fake_ds.reads, fake_ds.delay = 0, 0.1
    try:
        p = PORT_FAKES[0]
        grid = [EngineParams(data_source=("", p(id=1)),
                             preparator=("", p(id=prep)),
                             algorithms=[("", p(id=algo))],
                             serving=("", p()))
                for prep in (1, 2, 3) for algo in (4, 5, 6)]
        engine = _fake_engine(PORT_FAKES, FastEvalEngine)
        result = MetricEvaluator(_port_echo(), parallelism=4).evaluate(
            cpu, engine, grid)
        assert fake_ds.reads == 1
        assert engine.cache_hits["data_source"] >= 8
        assert result.best_engine_params.preparator[1].id == 3
        assert result.best_engine_params.algorithms[0][1].id == 6
        # the same sweep without memoization reads once a candidate
        fake_ds.reads, fake_ds.delay = 0, 0.0
        seq = MetricEvaluator(ZeroMetric(), parallelism=1).evaluate(
            cpu, _fake_engine(PORT_FAKES, Engine), grid[:3])
        assert fake_ds.reads == 3 and seq.best_idx == 0
    finally:
        fake_ds.reads, fake_ds.delay = 0, 0.0


def test_fast_eval_matches_the_plain_engine(cpu):
    grid = _fake_grid(PORT_FAKES, EngineParams)
    plain = _fake_engine(PORT_FAKES, Engine).eval(cpu, grid[1])
    fast = _fake_engine(PORT_FAKES, FastEvalEngine).eval(cpu, grid[1])
    assert plain == fast == [
        ({"fold": k}, [(q, 1000 + 300 + 90 + q, q * 10) for q in range(3)])
        for k in range(2)]


def test_run_evaluation_lifecycle(cpu, tmp_path):
    storage = Storage(env=_sqlite_env(tmp_path / "meta.sqlite"))
    evaluation = Evaluation(
        engine=_fake_engine(PORT_FAKES, Engine),
        metric=_port_echo(),
        engine_params_list=_fake_grid(PORT_FAKES, EngineParams),
        other_metrics=[ZeroMetric()],
    )
    iid, result = run_evaluation(evaluation, ctx=cpu, storage=storage)
    inst = storage.get_meta_data_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED"
    assert inst.evaluation_class == "Evaluation"
    assert inst.evaluator_results == result.to_one_liner()
    assert inst.evaluator_results_html == result.to_html()
    assert json.loads(inst.evaluator_results_json)["bestIdx"] == 1

    p = PORT_FAKES[0]
    bad = Evaluation(
        engine=_fake_engine(PORT_FAKES, Engine), metric=ZeroMetric(),
        engine_params_list=[EngineParams(
            data_source=("", p(id=1, error=True)),
            algorithms=[("", p(id=3))])])
    with pytest.raises(ValueError):
        run_evaluation(bad, ctx=cpu, storage=storage)
    statuses = sorted(i.status for i in
                      storage.get_meta_data_evaluation_instances().get_all())
    assert statuses == ["EVALCOMPLETED", "FAILED"]


def test_run_evaluation_without_ctx_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    storage = Storage(env=_sqlite_env(tmp_path / "meta.sqlite"))
    evaluation = Evaluation(
        engine=_fake_engine(PORT_FAKES, Engine), metric=ZeroMetric(),
        engine_params_list=_fake_grid(PORT_FAKES, EngineParams))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_evaluation(evaluation, storage=storage)
    assert storage.get_meta_data_evaluation_instances().get_all() == []


# -- the recommendation grid from a shared checkpoint --------------------------------


class _Precision:
    """PrecisionAtK(10) (the example's metric), recording the eval data
    of every candidate it scores, in candidate order."""

    k = 10

    def calculate_point(self, eval_info, query, prediction, actual):
        top = [s["item"] for s in prediction.get("itemScores", [])[:self.k]]
        if not top:
            return 0.0
        return len(set(top) & set(actual)) / float(self.k)

    def calculate(self, eval_data):
        self.seen.append(eval_data)
        return super().calculate(eval_data)


class PortPrecision(_Precision, AverageMetric):
    def __init__(self):
        self.seen = []


class JaxPrecision(_Precision, JaxAverage):
    def __init__(self):
        self.seen = []


RANKS = (8, 16)


def _write_start(ckpt_dir, rank):
    """One iteration-0 checkpoint per rank, at the full maps' shape."""
    n_users = len({e.entity_id for e in _rate_events(Event)})
    n_items = len({e.target_entity_id for e in _rate_events(Event)})
    rng = np.random.default_rng(100 + rank)
    _write_checkpoint(
        checkpoint_path(str(ckpt_dir)), iteration=0,
        item_factors=(rng.standard_normal((n_items, rank)) / 3).astype(
            np.float32),
        user_factors=np.zeros((n_users, rank), np.float32),
    )


def _grid(mod, params_cls, ckpt):
    return [
        params_cls(
            data_source=("", mod.RecDataSourceParams(app_name=APP, eval_k=3)),
            preparator=("", mod.RecPreparatorParams()),
            algorithms=[("als", mod.ALSParams(
                rank=rank, num_iterations=2,
                checkpoint_dir=str(ckpt / f"rank{rank}"), resume=True))],
        )
        for rank in RANKS
    ]


@pytest.fixture(scope="module")
def grid_runs(storages, tmp_path_factory):
    """``run_evaluation`` over the grid in both packages (each wrapping
    its engine in FastEvalEngine, so the trained fold models stay
    readable); returns per package (metric, engine, result, instance
    id, best.json path, storage)."""
    base = tmp_path_factory.mktemp("grid")
    ckpt = base / "ckpt"
    for rank in RANKS:
        _write_start(ckpt / f"rank{rank}", rank)
    jax_storage, storage = storages
    out = {}

    metric = JaxPrecision()
    engine = JaxFastEval.from_engine(jax_rec.recommendation_engine())
    evaluation = JaxEvaluation(
        engine=engine, metric=metric,
        engine_params_list=_grid(jax_rec, JaxEngineParams, ckpt),
        output_path=str(base / "jax_best.json"))
    jax_set_storage(jax_storage)
    try:
        iid, result = jax_run_eval(evaluation, storage=jax_storage)
    finally:
        jax_set_storage(None)
    out["jax"] = (metric, engine, result, iid, base / "jax_best.json",
                  jax_storage)

    metric = PortPrecision()
    engine = FastEvalEngine.from_engine(rec.recommendation_engine())
    evaluation = Evaluation(
        engine=engine, metric=metric,
        engine_params_list=_grid(rec, EngineParams, ckpt),
        output_path=str(base / "port_best.json"))
    set_storage(storage)
    try:
        iid, result = run_evaluation(
            evaluation, ctx=ComputeContext.create(device="cpu"),
            storage=storage)
    finally:
        set_storage(None)
    out["port"] = (metric, engine, result, iid, base / "port_best.json",
                   storage)
    # the checkpoints were only read
    for rank in RANKS:
        with np.load(checkpoint_path(str(ckpt / f"rank{rank}"))) as z:
            assert int(z["iteration"]) == 0
    return out


def _jax_fold_model(jax_engine, params, fold):
    key = ("algo", params.data_source, params.preparator,
           tuple(params.algorithms)[0], fold)
    return jax_engine._algorithms_cache[key].result()[1]


def _assert_lists_alike(got, want, plain_row, item_map):
    """Equal item lists and scores within EPOCHS; a swap is allowed only
    where the two items' plain scores tie within 1e-4 + 1e-5·|s|."""
    g_items = [e["item"] for e in got["itemScores"]]
    w_items = [e["item"] for e in want["itemScores"]]
    assert len(g_items) == len(w_items)
    np.testing.assert_allclose([e["score"] for e in got["itemScores"]],
                               [e["score"] for e in want["itemScores"]],
                               **EPOCHS)
    swaps = 0
    for gi, wi in zip(g_items, w_items):
        if gi != wi:
            swaps += 1
            a, b = plain_row[item_map(gi)], plain_row[item_map(wi)]
            assert abs(a - b) <= 1e-4 + 1e-5 * abs(b), (gi, wi, a, b)
    return swaps


@pytest.mark.parametrize("candidate", range(len(RANKS)))
def test_grid_predictions_match_jax(grid_runs, candidate):
    p_metric, _pe, p_result, *_ = grid_runs["port"]
    j_metric, j_engine, j_result, *_ = grid_runs["jax"]
    got, want = p_metric.seen[candidate], j_metric.seen[candidate]
    params = j_result.engine_params_scores[candidate][0]
    assert len(got) == len(want) == 3
    swaps = checked = 0
    lists_equal = True
    for fold, ((g_info, g_qpa), (w_info, w_qpa)) in enumerate(
            zip(got, want)):
        assert g_info == w_info
        model = _jax_fold_model(j_engine, params, fold)
        plain = np.asarray(model.user_factors, np.float64) @ np.asarray(
            model.item_factors, np.float64).T
        assert [q for q, _p, _a in g_qpa] == [q for q, _p, _a in w_qpa]
        for (q, gp, ga), (_q, wp, wa) in zip(g_qpa, w_qpa):
            assert ga == wa
            assert len(gp["itemScores"]) == min(q["num"], len(model.item_map))
            n = _assert_lists_alike(gp, wp, plain[model.user_map(q["user"])],
                                    model.item_map)
            swaps += n
            lists_equal &= n == 0
            checked += 1
    assert checked > 100 and swaps <= checked // 5  # ties are rare
    g_score = p_result.engine_params_scores[candidate][1].score
    w_score = j_result.engine_params_scores[candidate][1].score
    if lists_equal:
        assert abs(g_score - w_score) <= 1e-6


def test_grid_best_and_best_json_match_jax(grid_runs):
    _pm, p_engine, p_result, p_iid, p_best, p_storage = grid_runs["port"]
    _jm, j_engine, j_result, _ji, j_best, _js = grid_runs["jax"]
    assert p_result.best_idx == j_result.best_idx
    assert p_best.read_bytes() == j_best.read_bytes()
    assert json.loads(p_best.read_text())["algorithms"][0]["params"][
        "rank"] == RANKS[p_result.best_idx]
    inst = p_storage.get_meta_data_evaluation_instances().get(p_iid)
    assert inst.status == "EVALCOMPLETED"
    assert json.loads(inst.evaluator_results_json)["bestIdx"] == (
        p_result.best_idx)
    # the event store was read once for the whole grid, in both packages
    assert p_engine.cache_hits == j_engine.cache_hits
    # 2 eval calls + 3 shared fold preparations look it up, 1 reads
    assert p_engine.cache_hits["data_source"] == 4
    assert len(p_engine._data_source_cache) == 1
    # every fold model was staged on the context's device
    for fut in p_engine._algorithms_cache.values():
        _algo, model = fut.result()
        assert isinstance(model.item_factors, torch.Tensor)
        assert model.item_factors.device.type == "cpu"


def test_plain_engine_eval_matches_fast_eval_and_jax(grid_runs, storages,
                                                    cpu, tmp_path):
    """``Engine.eval`` of the rank-8 candidate (no memoization) gives the
    FastEvalEngine run's answers, and the JAX ``Engine.eval``'s."""
    ckpt = tmp_path / "ckpt"
    _write_start(ckpt / "rank8", 8)
    jax_storage, storage = storages
    set_storage(storage)
    try:
        got = rec.recommendation_engine().eval(
            cpu, _grid(rec, EngineParams, ckpt)[0])
    finally:
        set_storage(None)
    jax_set_storage(jax_storage)
    try:
        want = jax_rec.recommendation_engine().eval(
            JaxContext.create(), _grid(jax_rec, JaxEngineParams, ckpt)[0])
    finally:
        jax_set_storage(None)
    fast = grid_runs["port"][0].seen[0]
    j_engine, j_result = grid_runs["jax"][1], grid_runs["jax"][2]
    params = j_result.engine_params_scores[0][0]
    for fold, ((_gi, g_qpa), (_wi, w_qpa), (_fi, f_qpa)) in enumerate(
            zip(got, want, fast)):
        model = _jax_fold_model(j_engine, params, fold)
        plain = np.asarray(model.user_factors, np.float64) @ np.asarray(
            model.item_factors, np.float64).T
        for (q, gp, ga), (_q, wp, wa), (_f, fp, _fa) in zip(g_qpa, w_qpa,
                                                           f_qpa):
            assert gp == fp  # the same arithmetic on the same device
            _assert_lists_alike(gp, wp, plain[model.user_map(q["user"])],
                                model.item_map)


# -- the example's evaluation flow ------------------------------------------------


def _load_example():
    path = ROOT / "examples" / "recommendation" / "evaluation.py"
    spec = importlib.util.spec_from_file_location("rec_evaluation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _to_port(engine, jax_params):
    """The example's grid as the port's params: each (name, params)
    through its JSON form into the port's params class of that name."""
    def one(classes, pair):
        name, p = pair
        cls = engine._one(classes, name, "component")
        return name, params_from_json(cls.params_class,
                                      dataclasses.asdict(p))

    return EngineParams(
        data_source=one(engine.data_source_classes, jax_params.data_source),
        preparator=one(engine.preparator_classes, jax_params.preparator),
        algorithms=[one(engine.algorithm_classes, a)
                    for a in jax_params.algorithms],
    )


def test_example_evaluation_flow_runs_on_the_port(storages, cpu, tmp_path):
    example = _load_example()
    jax_evaluation = example.evaluation(app_name=APP)
    engine = rec.recommendation_engine()
    grid = [_to_port(engine, p) for p in jax_evaluation.engine_params_list]
    assert [p.algorithms[0][1].rank for p in grid] == [8, 16, 32]
    assert all(p.data_source[1].eval_k == 3 for p in grid)
    evaluation = Evaluation(
        engine=engine, metric=jax_evaluation.metric,  # its PrecisionAtK
        engine_params_list=grid, output_path=str(tmp_path / "best.json"))
    storage = storages[1]
    set_storage(storage)
    try:
        iid, result = run_evaluation(evaluation, ctx=cpu, storage=storage)
    finally:
        set_storage(None)
    inst = storage.get_meta_data_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED"
    scores = [s.score for _p, s in result.engine_params_scores]
    assert len(scores) == 3 and all(0.0 <= s <= 1.0 for s in scores)
    assert max(scores) > 0.0  # held-out items are found at all
    assert result.best_score.score == max(scores)
    best = json.loads((tmp_path / "best.json").read_text())
    assert best["algorithms"][0]["params"]["rank"] == [8, 16, 32][
        result.best_idx]


# -- DataView ---------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_data_view_reads_across_packages(writer, storages, tmp_path):
    """The writer materializes the view from its events; the reader's
    store holds the app with no events, so what it returns can only come
    from the writer's npz."""
    empty = {"jax": JaxStorage(env=_sqlite_env(tmp_path / "j.sqlite")),
             "port": Storage(env=_sqlite_env(tmp_path / "p.sqlite"))}
    empty["jax"].get_meta_data_apps().insert(JaxApp(0, APP))
    empty["port"].get_meta_data_apps().insert(App(0, APP))
    full = {"jax": storages[0], "port": storages[1]}
    reader = "port" if writer == "jax" else "jax"
    views = {}
    for name, view_cls, store_cls in (("jax", JaxDataView, JaxEventStore),
                                      ("port", DataView, EventStore)):
        source = full[name] if name == writer else empty[name]
        views[name] = view_cls(store_cls(source), str(tmp_path / "base"))
    kw = dict(app_name=APP, event_names=["rate"], version="v1",
              until_time=T0 + dt.timedelta(seconds=500))
    assert views["jax"].path_for(**kw) == views["port"].path_for(**kw)
    written = views[writer].create(**kw)
    assert len(written) == 500
    read = views[reader].create(**kw)
    for col in ("event", "entity_type", "entity_id", "target_entity_type",
                "target_entity_id", "event_time"):
        np.testing.assert_array_equal(getattr(read, col),
                                      getattr(written, col))
    assert read.properties == written.properties
    assert views["port"].clear() == 1
    assert not pathlib.Path(views["port"].path_for(**kw)).exists()
    assert len(views["port"].create(**kw, refresh=True)) == (
        500 if writer == "port" else 0)
