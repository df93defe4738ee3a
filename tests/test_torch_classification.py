"""Naive Bayes and the two classification templates: the port against
the JAX package.

* ``ops/naive_bayes``: ``fit_multinomial`` (with a padding mask),
  ``log_scores``, ``predict_classes``, ``encode_categorical``,
  ``fit_categorical`` and ``categorical_log_scores`` on the same numpy
  inputs, within 1e-6 absolute + 1e-6 relative (XLA-CPU and torch-CPU
  add the products in other orders); classes and one-hot codes exactly.
* ``classification``: each package reads its own memory store filled
  with the same ``$set`` events: equal features, labels and ``read_eval``
  folds; the trained models' tables within 1e-6; ``predict`` (label and
  scores within 1e-5) and the two-phase batch path (labels) alike.
* ``textclassification``: ``tokenize`` and ``hash_counts`` (FNV-1a,
  64-bit) bit-equal on random text; the preparator's hashed matrix
  equal; folds, predict and the batch path alike.
* Generations the JAX package published for both templates load in the
  port (its arrays arrive as numpy, staged at deploy) and answer alike.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.core.persistence import serialize_models as jax_serialize
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import (
    App as JaxApp,
    Storage as JaxStorage,
    set_storage as jax_set_storage,
)
from predictionio_tpu.models import classification as jclf
from predictionio_tpu.models import textclassification as jtext
from predictionio_tpu.ops import naive_bayes as jnb
from predictionio_tpu.parallel.mesh import ComputeContext as JaxContext
from predictionio_tpu_torch.convert import from_jax_template_model
from predictionio_tpu_torch.core.persistence import deserialize_models
from predictionio_tpu_torch.core.registry import resolve_engine_factory
from predictionio_tpu_torch.core.workflow import load_deployment, run_train
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage, set_storage
from predictionio_tpu_torch.models import classification as clf
from predictionio_tpu_torch.models import textclassification as text
from predictionio_tpu_torch.ops import naive_bayes as nb
from predictionio_tpu_torch.parallel.mesh import ComputeContext

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-6, atol=1e-6)


def _engine_json(name):
    return json.loads(
        (ROOT / "examples" / name / "engine.json").read_text())


@pytest.fixture()
def cpu():
    return ComputeContext.create(device="cpu")


# -- ops/naive_bayes -----------------------------------------------------------


def _nb_inputs(seed, n=40, d=12, c=3):
    rng = np.random.default_rng(seed)
    x = rng.poisson(2.0, (n, d)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[-5:] = 0.0  # padding rows
    return x, y, mask


@pytest.mark.parametrize("alpha", [1.0, 0.25])
@pytest.mark.parametrize("masked", [False, True])
def test_fit_multinomial_matches_jax(alpha, masked):
    x, y, mask = _nb_inputs(1)
    jm = jnb.fit_multinomial(jnp.asarray(x), jnp.asarray(y), 3, alpha,
                             jnp.asarray(mask) if masked else None)
    pm = nb.fit_multinomial(torch.from_numpy(x), torch.from_numpy(y), 3,
                            alpha, torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(pm.pi.numpy(), np.asarray(jm.pi), **TOL)
    np.testing.assert_allclose(pm.theta.numpy(), np.asarray(jm.theta), **TOL)
    assert pm.n_classes == 3
    xq = torch.from_numpy(x[:9])
    np.testing.assert_allclose(
        nb.log_scores(pm, xq).numpy(),
        np.asarray(jnb.log_scores(jm, jnp.asarray(x[:9]))), rtol=1e-6,
        atol=1e-5)
    np.testing.assert_array_equal(
        nb.predict_classes(pm, xq).numpy(),
        np.asarray(jnb.predict_classes(jm, jnp.asarray(x[:9]))))


def test_padding_rows_change_nothing():
    x, y, _ = _nb_inputs(2)
    pad = np.concatenate([x, np.full((6, x.shape[1]), 9.0, np.float32)])
    ypad = np.concatenate([y, np.zeros(6, np.int32)])
    mask = np.concatenate([np.ones(len(x)), np.zeros(6)]).astype(np.float32)
    a = nb.fit_multinomial(torch.from_numpy(x), torch.from_numpy(y), 3)
    b = nb.fit_multinomial(torch.from_numpy(pad), torch.from_numpy(ypad), 3,
                           mask=torch.from_numpy(mask))
    np.testing.assert_allclose(a.pi.numpy(), b.pi.numpy(), rtol=1e-6)
    np.testing.assert_allclose(a.theta.numpy(), b.theta.numpy(), rtol=1e-6)


def test_categorical_nb_matches_jax():
    rng = np.random.default_rng(3)
    vocab = [3, 5, 2]
    codes = np.stack([rng.integers(-1, v, 30) for v in vocab], axis=1)
    y = rng.integers(0, 2, 30).astype(np.int32)
    onehot = nb.encode_categorical(codes, vocab)
    np.testing.assert_array_equal(onehot, jnb.encode_categorical(codes,
                                                                 vocab))
    jm = jnb.fit_categorical(jnp.asarray(onehot), jnp.asarray(y), 2,
                             tuple(vocab), 0.5)
    pm = nb.fit_categorical(torch.from_numpy(onehot), torch.from_numpy(y), 2,
                            tuple(vocab), 0.5)
    np.testing.assert_allclose(pm.pi.numpy(), np.asarray(jm.pi), **TOL)
    np.testing.assert_allclose(pm.theta.numpy(), np.asarray(jm.theta), **TOL)
    np.testing.assert_allclose(
        nb.categorical_log_scores(pm, torch.from_numpy(onehot)).numpy(),
        np.asarray(jnb.categorical_log_scores(jm, jnp.asarray(onehot))),
        **TOL)


# -- stores ----------------------------------------------------------------------------


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


# -- classification ------------------------------------------------------------------------

CLF_JSON = _engine_json("classification")
CLF_APP = CLF_JSON["datasource"]["params"]["app_name"]


def _clf_events(event_cls):
    """The example's shape: three attributes around a per-plan base,
    here four plans over 120 users."""
    rng = np.random.default_rng(7)
    bases = np.asarray([[8, 1, 1], [1, 1, 8], [1, 8, 1], [4, 4, 4]], float)
    out = []
    for i in range(120):
        label = i % 4
        feats = bases[label] + rng.random(3) * 2
        out.append(event_cls(
            event="$set", entity_type="user", entity_id=f"u{i}",
            properties={"attr0": float(feats[0]), "attr1": float(feats[1]),
                        "attr2": float(feats[2]), "plan": f"p{label}"}))
    return out


CLF_QUERIES = [{"features": [8.0, 1.0, 1.0]}, {"features": [1.0, 1.5, 7.0]},
               {"features": [1.0, 9.0, 1.0]}, {"features": [4.0, 4.0, 4.5]},
               {"features": [0.0, 0.0, 0.0]}, {"features": [3.0, 0.5, 2.0]}]


def _clf_train_both(eval_k=0):
    jctx, pctx = JaxContext.create(), ComputeContext.create(device="cpu")
    dsp = dict(app_name=CLF_APP, eval_k=eval_k)
    jtd = jclf.ClassificationDataSource(
        jclf.ClassificationDataSourceParams(**dsp)).read_training(jctx)
    ptd = clf.ClassificationDataSource(
        clf.ClassificationDataSourceParams(**dsp)).read_training(pctx)
    jm = jclf.NaiveBayesAlgorithm().train(
        jctx, jclf.ClassificationPreparator().prepare(jctx, jtd))
    pm = clf.NaiveBayesAlgorithm().train(
        pctx, clf.ClassificationPreparator().prepare(pctx, ptd))
    return jtd, ptd, jm, pm


def test_classification_engine_json_resolves_to_the_port_template():
    assert CLF_JSON["engineFactory"] == "classification"
    params = resolve_engine_factory("classification")().params_from_variant(
        CLF_JSON)
    assert list(params.data_source[1].attributes) == ["attr0", "attr1",
                                                      "attr2"]
    (name, p), = params.algorithms
    assert name == "naive" and isinstance(p, clf.NaiveBayesParams)


def test_classification_train_and_predict_match_jax():
    with _Both(CLF_APP, _clf_events):
        jtd, ptd, jm, pm = _clf_train_both()
    np.testing.assert_array_equal(ptd.x, jtd.x)
    np.testing.assert_array_equal(ptd.y, jtd.y)
    assert ptd.label_map.keys().tolist() == jtd.label_map.keys().tolist()
    np.testing.assert_allclose(pm.nb.pi.numpy(), np.asarray(jm.nb.pi), **TOL)
    np.testing.assert_allclose(pm.nb.theta.numpy(), np.asarray(jm.nb.theta),
                               **TOL)
    for q in CLF_QUERIES:
        g = clf.NaiveBayesAlgorithm().predict(pm, q)
        w = jclf.NaiveBayesAlgorithm().predict(jm, q)
        assert g["label"] == w["label"]
        assert sorted(g["scores"]) == sorted(w["scores"])
        for k, v in w["scores"].items():
            assert g["scores"][k] == pytest.approx(v, rel=1e-5, abs=1e-5)
    assert ({g["label"] for g in clf.NaiveBayesAlgorithm().batch_predict(
        pm, CLF_QUERIES)} == {"p0", "p1", "p2", "p3"})
    assert clf.NaiveBayesAlgorithm().batch_predict(
        pm, CLF_QUERIES) == jclf.NaiveBayesAlgorithm().batch_predict(
        jm, CLF_QUERIES)
    assert clf.NaiveBayesAlgorithm().batch_predict(pm, []) == []


def test_classification_read_eval_folds_match_jax():
    with _Both(CLF_APP, _clf_events):
        jfolds = jclf.ClassificationDataSource(
            jclf.ClassificationDataSourceParams(app_name=CLF_APP, eval_k=3)
        ).read_eval(JaxContext.create())
        pfolds = clf.ClassificationDataSource(
            clf.ClassificationDataSourceParams(app_name=CLF_APP, eval_k=3)
        ).read_eval(ComputeContext.create(device="cpu"))
    assert len(pfolds) == len(jfolds) == 3
    for (ptd, pinfo, pqa), (jtd, jinfo, jqa) in zip(pfolds, jfolds):
        assert pinfo == jinfo
        np.testing.assert_array_equal(ptd.x, jtd.x)
        np.testing.assert_array_equal(ptd.y, jtd.y)
        assert pqa == jqa


def test_classification_jax_generation_loads_and_answers_alike(cpu):
    with _Both(CLF_APP, _clf_events):
        _, _, jm, _ = _clf_train_both()
    blob = jax_serialize("g1", [jclf.NaiveBayesAlgorithm()], [jm])
    (_, loaded), = deserialize_models(blob)
    assert type(loaded) is clf.NaiveBayesModel
    assert isinstance(loaded.nb.theta, np.ndarray)
    staged = clf.NaiveBayesAlgorithm().stage_model(cpu, loaded)
    carried = clf.NaiveBayesAlgorithm().stage_model(
        cpu, from_jax_template_model(jm))
    for model in (staged, carried):
        assert isinstance(model.nb.theta, torch.Tensor)
        for q in CLF_QUERIES:
            g = clf.NaiveBayesAlgorithm().predict(model, q)
            w = jclf.NaiveBayesAlgorithm().predict(jm, q)
            assert g["label"] == w["label"]


def test_classification_run_train_and_deploy(cpu):
    with _Both(CLF_APP, _clf_events) as both:
        engine = resolve_engine_factory("classification")()
        params = engine.params_from_variant(CLF_JSON)
        iid = run_train(engine, params, "clf", ctx=cpu, storage=both.port)
        _, algos, models, serving = load_deployment(
            engine, params, engine_id="clf", ctx=cpu, storage=both.port)
    assert isinstance(models[0].nb.pi, torch.Tensor)
    out = serving.serve(CLF_QUERIES[0],
                        [algos[0].predict(models[0], CLF_QUERIES[0])])
    assert out["label"] == "p0"
    assert iid


# -- textclassification -------------------------------------------------------------------------

TEXT_JSON = _engine_json("textclassification")
TEXT_APP = TEXT_JSON["datasource"]["params"]["app_name"]
WORDS = ["win", "free", "prize", "money", "claim", "meeting", "agenda",
         "review", "report", "tuesday", "goal", "match", "team", "score",
         "recipe", "bake", "flour", "oven", "don't", "it's", "2024", "ü"]


def _doc(rng, label):
    lo = (label * 5) % len(WORDS)
    topic = WORDS[lo:lo + 6] or WORDS[:6]
    n = int(rng.integers(4, 12))
    words = [topic[int(rng.integers(0, len(topic)))] if rng.random() < 0.7
             else WORDS[int(rng.integers(0, len(WORDS)))] for _ in range(n)]
    return " ".join(w.upper() if rng.random() < 0.2 else w for w in words)


def _text_events(event_cls):
    rng = np.random.default_rng(9)
    return [
        event_cls(event="$set", entity_type="document", entity_id=f"d{i}",
                  properties={"text": _doc(rng, i % 4) + "!? ",
                              "label": f"t{i % 4}"})
        for i in range(80)
    ]


def test_tokenize_and_hash_counts_are_bit_equal():
    rng = np.random.default_rng(4)
    for _ in range(50):
        s = "".join(chr(int(c)) for c in rng.integers(32, 0x24F, 60))
        s += " " + _doc(rng, int(rng.integers(0, 4)))
        assert text.tokenize(s) == jtext.tokenize(s)
        for n, seed in ((4096, 0), (97, 3)):
            got = text.hash_counts(text.tokenize(s), n, seed)
            want = jtext.hash_counts(jtext.tokenize(s), n, seed)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


TEXT_QUERIES = [{"text": "win free money now"}, {"text": "MEETING agenda"},
                {"text": "team score goal"}, {"text": "bake the recipe"},
                {"text": ""}, {"text": "unseen words only"}]


def _text_train_both(n_features):
    jctx, pctx = JaxContext.create(), ComputeContext.create(device="cpu")
    jtd = jtext.TextDataSource(jtext.TextDataSourceParams(
        app_name=TEXT_APP)).read_training(jctx)
    ptd = text.TextDataSource(text.TextDataSourceParams(
        app_name=TEXT_APP)).read_training(pctx)
    jprep = jtext.TextPreparator(jtext.TextPreparatorParams(
        n_features=n_features)).prepare(jctx, jtd)
    pprep = text.TextPreparator(text.TextPreparatorParams(
        n_features=n_features)).prepare(pctx, ptd)
    jm = jtext.TextNBAlgorithm().train(jctx, jprep)
    pm = text.TextNBAlgorithm().train(pctx, pprep)
    return (jtd, ptd), (jprep, pprep), jm, pm


@pytest.mark.parametrize("n_features", [4096, 64])
def test_text_train_and_batch_match_jax(n_features):
    with _Both(TEXT_APP, _text_events):
        (jtd, ptd), (jprep, pprep), jm, pm = _text_train_both(n_features)
    assert ptd.texts == jtd.texts and ptd.labels == jtd.labels
    n = len(ptd.texts)
    np.testing.assert_array_equal(pprep.x.numpy()[:n],
                                  np.asarray(jprep.x)[:n])
    np.testing.assert_allclose(pm.nb_model.theta.numpy(),
                               np.asarray(jm.nb_model.theta), **TOL)
    got = text.TextNBAlgorithm().batch_predict(pm, TEXT_QUERIES)
    want = jtext.TextNBAlgorithm().batch_predict(jm, TEXT_QUERIES)
    assert [g["label"] for g in got] == [w["label"] for w in want]
    for g, w in zip(got, want):
        for k, v in w["scores"].items():
            assert g["scores"][k] == pytest.approx(v, rel=1e-5, abs=1e-5)
    # the two-phase path equals one query at a time
    algo = text.TextNBAlgorithm()
    handle = algo.batch_predict_launch(pm, TEXT_QUERIES[:3])
    assert handle.shape[0] == 4  # the batch pads to a power of two
    batch = algo.batch_predict_collect(pm, handle, TEXT_QUERIES[:3])
    for b, one in zip(batch, [algo.predict(pm, q) for q in TEXT_QUERIES[:3]]):
        assert b["label"] == one["label"]
        for k, v in one["scores"].items():
            assert b["scores"][k] == pytest.approx(v, rel=1e-6)


def test_text_read_eval_folds_match_jax():
    with _Both(TEXT_APP, _text_events):
        jfolds = jtext.TextDataSource(jtext.TextDataSourceParams(
            app_name=TEXT_APP, eval_k=4)).read_eval(JaxContext.create())
        pfolds = text.TextDataSource(text.TextDataSourceParams(
            app_name=TEXT_APP, eval_k=4)).read_eval(
                ComputeContext.create(device="cpu"))
    assert len(pfolds) == 4
    for (ptd, pinfo, pqa), (jtd, jinfo, jqa) in zip(pfolds, jfolds):
        assert (ptd.texts, ptd.labels, pinfo, pqa) == (
            jtd.texts, jtd.labels, jinfo, jqa)


def test_text_engine_json_and_jax_generation(cpu):
    assert TEXT_JSON["engineFactory"] == "textclassification"
    params = resolve_engine_factory("textclassification")(
        ).params_from_variant(TEXT_JSON)
    assert params.preparator[1].n_features == 4096
    with _Both(TEXT_APP, _text_events):
        _, _, jm, _ = _text_train_both(4096)
    blob = jax_serialize("g1", [jtext.TextNBAlgorithm()], [jm])
    (_, loaded), = deserialize_models(blob)
    assert type(loaded) is text.TextNBModel and loaded.n_features == 4096
    staged = text.TextNBAlgorithm().stage_model(cpu, loaded)
    got = text.TextNBAlgorithm().batch_predict(staged, TEXT_QUERIES)
    want = jtext.TextNBAlgorithm().batch_predict(jm, TEXT_QUERIES)
    assert [g["label"] for g in got] == [w["label"] for w in want]
