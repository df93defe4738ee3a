"""The helloworld, regression and leadscoring templates: the port against
the JAX package, each package reading its own memory store filled with
the same events (the shapes of the examples' ``import_eventserver.py``).

* helloworld: per-day means within 1e-6 relative, from events and from
  a CSV; unknown days answer ``None``.
* regression: full-batch gradient descent (200 steps) and the normal
  equations, each within rtol 1e-4 / atol 1e-5 of the JAX weights (float32
  steps summed in other orders); ``read_eval`` folds equal; the
  example's three "SGD" algorithms averaged by ``AverageServing`` alike.
* leadscoring: 500 Adam steps (``torch.optim.Adam`` against optax) give
  weights within rtol 1e-4 / atol 1e-5 and a final loss within 1e-5; the
  standardization moments equal; scores and the deploy-time threshold
  alike; ``read_eval`` folds equal.
* A generation the JAX package published for each loads in the port and
  answers alike.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from predictionio_tpu.core.persistence import serialize_models as jax_serialize
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import (
    App as JaxApp,
    Storage as JaxStorage,
    set_storage as jax_set_storage,
)
from predictionio_tpu.models import helloworld as jhello
from predictionio_tpu.models import leadscoring as jlead
from predictionio_tpu.models import regression as jreg
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu_torch.core.persistence import deserialize_models
from predictionio_tpu_torch.core.registry import resolve_engine_factory
from predictionio_tpu_torch.core.workflow import load_deployment, run_train
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage, set_storage
from predictionio_tpu_torch.models import helloworld as hello
from predictionio_tpu_torch.models import leadscoring as lead
from predictionio_tpu_torch.models import regression as reg
from predictionio_tpu_torch.parallel.mesh import ComputeContext

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIT_TOL = dict(rtol=1e-4, atol=1e-5)


def _engine_json(name):
    return json.loads(
        (ROOT / "examples" / name / "engine.json").read_text())


def _memory(storage_cls, app_cls, event_cls, app_name, events):
    storage = storage_cls(env={
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    app_id = storage.get_meta_data_apps().insert(app_cls(0, app_name))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch(events(event_cls), app_id)
    return storage


class _Both:
    """Each package's store with the same events, each set as its
    process default while a block reads."""

    def __init__(self, app_name, events):
        self.jax = _memory(JaxStorage, JaxApp, JaxEvent, app_name, events)
        self.port = _memory(Storage, App, Event, app_name, events)

    def __enter__(self):
        jax_set_storage(self.jax)
        set_storage(self.port)
        return self

    def __exit__(self, *exc):
        jax_set_storage(None)
        set_storage(None)


def _contexts():
    return JaxContext.create(), ComputeContext.create(device="cpu")


@pytest.fixture()
def cpu():
    return ComputeContext.create(device="cpu")


# -- helloworld ------------------------------------------------------------------------

HELLO_JSON = _engine_json("helloworld")
HELLO_APP = HELLO_JSON["datasource"]["params"]["app_name"]
DAYS = {"Mon": 75, "Tue": 80, "Wed": 70, "Thu": 65, "Fri": 68}


def _reports(event_cls):
    rng = np.random.default_rng(1)
    return [
        event_cls(event="report", entity_type="day", entity_id=day,
                  properties={"temperature": float(t + rng.uniform(-3, 3))})
        for _week in range(4) for day, t in DAYS.items()
    ]


HELLO_QUERIES = [{"day": d} for d in DAYS] + [{"day": "Sun"}, {}]


def _hello_both(jds_params, pds_params):
    jctx, pctx = _contexts()
    jtd = jhello.HelloDataSource(jds_params).read_training(jctx)
    ptd = hello.HelloDataSource(pds_params).read_training(pctx)
    np.testing.assert_array_equal(ptd.days, jtd.days)
    np.testing.assert_array_equal(ptd.temperatures, jtd.temperatures)
    return (jhello.HelloAlgorithm().train(jctx, jtd),
            hello.HelloAlgorithm().train(pctx, ptd))


def _assert_hello_alike(jm, pm):
    assert pm.day_map.keys().tolist() == jm.day_map.keys().tolist()
    np.testing.assert_allclose(pm.means, jm.means, rtol=1e-6)
    assert pm.means.dtype == np.float32
    for q in HELLO_QUERIES:
        g = hello.HelloAlgorithm().predict(pm, q)
        w = jhello.HelloAlgorithm().predict(jm, q)
        if w["temperature"] is None:
            assert g == w
        else:
            assert g["temperature"] == pytest.approx(w["temperature"],
                                                     rel=1e-6)


def test_helloworld_from_events_matches_jax():
    with _Both(HELLO_APP, _reports):
        jm, pm = _hello_both(
            jhello.HelloDataSourceParams(app_name=HELLO_APP),
            hello.HelloDataSourceParams(app_name=HELLO_APP))
    _assert_hello_alike(jm, pm)


def test_helloworld_from_csv_matches_jax(tmp_path):
    path = tmp_path / "data.csv"
    path.write_text("".join(
        f"{e.entity_id}, {e.properties['temperature']}\n\n"
        for e in _reports(Event)))
    jm, pm = _hello_both(jhello.HelloDataSourceParams(filepath=str(path)),
                         hello.HelloDataSourceParams(filepath=str(path)))
    _assert_hello_alike(jm, pm)


def test_segment_mean_leaves_empty_segments_zero():
    got = hello.segment_mean(torch.tensor([0, 2, 2]),
                             torch.tensor([1.0, 2.0, 4.0]), 4)
    assert got.tolist() == [1.0, 0.0, 3.0, 0.0]


def test_helloworld_engine_json_trains_and_serves(cpu):
    with _Both(HELLO_APP, _reports) as both:
        engine = resolve_engine_factory("helloworld")()
        params = engine.params_from_variant(HELLO_JSON)
        run_train(engine, params, "hello", ctx=cpu, storage=both.port)
        _, algos, models, serving = load_deployment(
            engine, params, engine_id="hello", ctx=cpu, storage=both.port)
        jm = jhello.HelloAlgorithm().train(
            JaxContext.create(), jhello.HelloDataSource(
                jhello.HelloDataSourceParams(app_name=HELLO_APP)
            ).read_training(JaxContext.create()))
    _assert_hello_alike(jm, models[0])
    (_, loaded), = deserialize_models(
        jax_serialize("g", [jhello.HelloAlgorithm()], [jm]))
    _assert_hello_alike(jm, loaded)


# -- regression ------------------------------------------------------------------------

REG_JSON = _engine_json("regression")
REG_APP = REG_JSON["datasource"]["params"]["app_name"]


def _points(event_cls, n=200, d=3, seed=3):
    rng = np.random.default_rng(seed)
    true_w = rng.standard_normal(d)
    x = rng.uniform(-1, 1, (n, d))
    y = x @ true_w + 3.0 + rng.normal(0, 0.05, n)
    return [
        event_cls(event="point", entity_type="point", entity_id=f"p{i}",
                  properties={"label": float(y[i]),
                              "features": x[i].tolist()})
        for i in range(n)
    ]


def _reg_data(jds=None, pds=None):
    jctx, pctx = _contexts()
    jtd = jreg.RegressionDataSource(
        jds or jreg.RegressionDataSourceParams(app_name=REG_APP)
    ).read_training(jctx)
    ptd = reg.RegressionDataSource(
        pds or reg.RegressionDataSourceParams(app_name=REG_APP)
    ).read_training(pctx)
    np.testing.assert_array_equal(ptd.features, jtd.features)
    np.testing.assert_array_equal(ptd.labels, jtd.labels)
    return jtd, ptd


@pytest.mark.parametrize("params", [
    dict(),
    dict(step_size=0.4, num_iterations=50, l2=0.01),
    dict(fit_intercept=False),
    dict(solver="normal"),
    dict(solver="normal", l2=0.5, fit_intercept=False),
])
def test_regression_fit_matches_jax(params):
    with _Both(REG_APP, lambda cls: _points(cls, d=10)):
        jtd, ptd = _reg_data()
    jctx, pctx = _contexts()
    jm = jreg.RegressionAlgorithm(
        jreg.RegressionAlgorithmParams(**params)).train(jctx, jtd)
    pm = reg.RegressionAlgorithm(
        reg.RegressionAlgorithmParams(**params)).train(pctx, ptd)
    np.testing.assert_allclose(pm.weights, jm.weights, **FIT_TOL)
    assert pm.intercept == pytest.approx(jm.intercept, rel=1e-4, abs=1e-5)
    queries = [{"features": f.tolist()} for f in ptd.features[:8]]
    np.testing.assert_allclose(
        reg.RegressionAlgorithm().batch_predict(pm, queries),
        jreg.RegressionAlgorithm().batch_predict(jm, queries), **FIT_TOL)
    assert reg.RegressionAlgorithm().predict(pm, queries[0]) == pytest.approx(
        jreg.RegressionAlgorithm().predict(jm, queries[0]), rel=1e-4)


def test_regression_reads_a_file_alike(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "lr_data.txt"
    path.write_text("".join(
        " ".join(f"{v:.6f}" for v in row) + "\n\n"
        for row in rng.standard_normal((30, 4))))
    _reg_data(jreg.RegressionDataSourceParams(filepath=str(path)),
              reg.RegressionDataSourceParams(filepath=str(path)))


def test_regression_read_eval_folds_match_jax():
    with _Both(REG_APP, _points):
        jfolds = jreg.RegressionDataSource(jreg.RegressionDataSourceParams(
            app_name=REG_APP, eval_k=3)).read_eval(JaxContext.create())
        pfolds = reg.RegressionDataSource(reg.RegressionDataSourceParams(
            app_name=REG_APP, eval_k=3)).read_eval(
                ComputeContext.create(device="cpu"))
    assert len(pfolds) == 3
    for (ptd, pinfo, pqa), (jtd, jinfo, jqa) in zip(pfolds, jfolds):
        np.testing.assert_array_equal(ptd.features, jtd.features)
        assert (pinfo, pqa) == (jinfo, jqa)
    with pytest.raises(ValueError, match="eval_k"):
        reg.RegressionDataSource(reg.RegressionDataSourceParams(
            app_name=REG_APP)).read_eval(None)


def test_regression_engine_json_averages_three_sgd(cpu):
    assert REG_JSON["engineFactory"] == "regression"
    queries = [{"features": [0.1, -0.2, 0.3]}, {"features": [1.0, 1.0, -1.0]}]
    with _Both(REG_APP, _points) as both:
        engine = resolve_engine_factory("regression")()
        params = engine.params_from_variant(REG_JSON)
        assert [p.step_size for _n, p in params.algorithms] == [0.1, 0.2, 0.4]
        run_train(engine, params, "reg", ctx=cpu, storage=both.port)
        _, algos, models, serving = load_deployment(
            engine, params, engine_id="reg", ctx=cpu, storage=both.port)
        jctx = JaxContext.create()
        jtd = jreg.RegressionDataSource(jreg.RegressionDataSourceParams(
            app_name=REG_APP)).read_training(jctx)
        jalgos = [jreg.RegressionAlgorithm(jreg.RegressionAlgorithmParams(
            num_iterations=200, step_size=s)) for s in (0.1, 0.2, 0.4)]
        jmodels = [a.train(jctx, jtd) for a in jalgos]
    from predictionio_tpu.core import AverageServing as JaxAverage

    for q in queries:
        got = serving.serve(q, [a.predict(m, q) for a, m in zip(algos,
                                                               models)])
        want = JaxAverage().serve(q, [a.predict(m, q) for a, m in zip(
            jalgos, jmodels)])
        assert got == pytest.approx(want, rel=1e-4, abs=1e-5)
    (_, loaded), = deserialize_models(
        jax_serialize("g", jalgos[:1], jmodels[:1]))
    assert type(loaded) is reg.RegressionModel
    np.testing.assert_array_equal(loaded.weights, jmodels[0].weights)


# -- leadscoring ------------------------------------------------------------------------

LEAD_JSON = _engine_json("leadscoring")
LEAD_APP = LEAD_JSON["datasource"]["params"]["app_name"]


def _leads(event_cls, n=80, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        converted = bool(rng.random() < 0.45)
        base = 8.0 if converted else 2.0
        out.append(event_cls(
            event="$set", entity_type="user", entity_id=f"u{i}",
            properties={
                "sessions": float(base + rng.normal(0, 2.0)),
                "pages": float(base * 3 + rng.normal(0, 6.0)),
                "minutes": float(base * 5 + rng.normal(0, 12.0)),
                "converted": converted}))
    return out


def _jax_loss(w, b, x, y, l2):
    logits = x @ w + b
    return float(optax.sigmoid_binary_cross_entropy(logits, y).mean()
                 + l2 * (w ** 2).sum())


def _lead_both(**params):
    jctx, pctx = _contexts()
    jtd = jlead.LeadDataSource(jlead.LeadDataSourceParams(
        app_name=LEAD_APP)).read_training(jctx)
    ptd = lead.LeadDataSource(lead.LeadDataSourceParams(
        app_name=LEAD_APP)).read_training(pctx)
    np.testing.assert_array_equal(ptd.x, jtd.x)
    np.testing.assert_array_equal(ptd.y, jtd.y)
    jprep = jlead.LeadPreparator().prepare(jctx, jtd)
    pprep = lead.LeadPreparator().prepare(pctx, ptd)
    np.testing.assert_array_equal(pprep.mean, jprep.mean)
    np.testing.assert_array_equal(pprep.std, jprep.std)
    jm = jlead.LeadScoringAlgorithm(
        jlead.LeadScoringParams(**params)).train(jctx, jprep)
    pm = lead.LeadScoringAlgorithm(
        lead.LeadScoringParams(**params)).train(pctx, pprep)
    return ptd, pprep, jm, pm


@pytest.mark.parametrize("params", [
    dict(learning_rate=0.1, steps=500, l2=0.001),
    dict(learning_rate=0.05, steps=120, l2=0.1),
])
def test_leadscoring_adam_matches_optax(params):
    with _Both(LEAD_APP, _leads):
        ptd, pprep, jm, pm = _lead_both(**params)
    np.testing.assert_allclose(pm.w, jm.w, **FIT_TOL)
    assert pm.b == pytest.approx(jm.b, rel=1e-4, abs=1e-5)
    x = pprep.x.numpy()
    got_loss = float(lead.lead_loss(
        torch.from_numpy(pm.w), torch.tensor(pm.b), pprep.x, pprep.y,
        pprep.mask, params["l2"]))
    want_loss = _jax_loss(jnp.asarray(jm.w), jm.b, jnp.asarray(x),
                          jnp.asarray(ptd.y), params["l2"])
    assert abs(got_loss - want_loss) <= 1e-5
    queries = [{"features": row.tolist()} for row in ptd.x[:10]]
    got = lead.LeadScoringAlgorithm().batch_predict(pm, queries)
    want = jlead.LeadScoringAlgorithm().batch_predict(jm, queries)
    assert [g["converted"] for g in got] == [w["converted"] for w in want]
    np.testing.assert_allclose([g["score"] for g in got],
                               [w["score"] for w in want], **FIT_TOL)


def test_lead_loss_equals_optax_at_one_point():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((20, 3)).astype(np.float32)
    y = (rng.random(20) < 0.5).astype(np.float32)
    w = rng.standard_normal(3).astype(np.float32)
    got = float(lead.lead_loss(torch.from_numpy(w), torch.tensor(0.3),
                               torch.from_numpy(x), torch.from_numpy(y),
                               torch.ones(20), 0.01))
    want = _jax_loss(jnp.asarray(w), 0.3, jnp.asarray(x), jnp.asarray(y),
                     0.01)
    assert got == pytest.approx(want, abs=1e-6)


def test_leadscoring_threshold_and_folds_match_jax(cpu):
    with _Both(LEAD_APP, _leads) as both:
        engine = resolve_engine_factory("leadscoring")()
        params = engine.params_from_variant(LEAD_JSON)
        run_train(engine, params, "lead", ctx=cpu, storage=both.port)
        _, algos, models, _ = load_deployment(
            engine, params, engine_id="lead", ctx=cpu, storage=both.port)
        jfolds = jlead.LeadDataSource(jlead.LeadDataSourceParams(
            app_name=LEAD_APP, eval_k=4)).read_eval(JaxContext.create())
        pfolds = lead.LeadDataSource(lead.LeadDataSourceParams(
            app_name=LEAD_APP, eval_k=4)).read_eval(cpu)
    for (ptd, pinfo, pqa), (jtd, jinfo, jqa) in zip(pfolds, jfolds):
        np.testing.assert_array_equal(ptd.x, jtd.x)
        assert (pinfo, pqa) == (jinfo, jqa)
    model = models[0]
    q = {"features": [5.0, 15.0, 25.0]}
    score = algos[0].predict(model, q)["score"]
    for threshold in (0.01, 0.99):
        algo = lead.LeadScoringAlgorithm(lead.LeadScoringParams(
            threshold=threshold))
        jalgo = jlead.LeadScoringAlgorithm(jlead.LeadScoringParams(
            threshold=threshold))
        assert algo.predict(model, q)["converted"] == (score >= threshold)
        (_, loaded), = deserialize_models(jax_serialize(
            "g", [jalgo], [jlead.LeadModel(
                w=model.w, b=model.b, mean=model.mean, std=model.std,
                threshold=0.5)]))
        assert type(loaded) is lead.LeadModel
        assert algo.predict(loaded, q) == jalgo.predict(loaded, q)
