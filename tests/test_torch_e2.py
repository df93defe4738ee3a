"""The e2 helpers: the port's Markov chain and binary vectorizer against
the JAX package's, mirroring ``tests/test_e2.py``.

* ``train_markov_chain`` / ``predict_next``: the cases of
  ``tests/test_e2.py`` (row-normalized top-N, truncation, weights,
  fractional weights), then random transition counts with many planted
  ties, where both list equal probabilities lower state first: indices
  exactly, probabilities within 1e-7 (one float32 division each).
* ``BinaryVectorizer``: the same features, index order and vectors.
"""

import jax.numpy as jnp  # noqa: F401 - the JAX package runs on its CPU backend
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import markov as jmarkov
from predictionio_tpu.ops.vectorizer import BinaryVectorizer as JaxVectorizer
from predictionio_tpu_torch.ops import markov
from predictionio_tpu_torch.ops.vectorizer import BinaryVectorizer

CPU = torch.device("cpu")


def _both(frm, to, n_states, top_n, weights=None):
    args = (np.asarray(frm), np.asarray(to), n_states, top_n,
            None if weights is None else np.asarray(weights))
    return (jmarkov.train_markov_chain(*args),
            markov.train_markov_chain(*args, device=CPU))


def _assert_alike(jm, pm):
    np.testing.assert_array_equal(pm.indices.numpy(), np.asarray(jm.indices))
    np.testing.assert_allclose(pm.probs.numpy(), np.asarray(jm.probs),
                               rtol=1e-7, atol=0)
    assert pm.n_states == jm.n_states
    for s in range(pm.n_states):
        got = markov.predict_next(pm, s)
        want = jmarkov.predict_next(jm, s)
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([p for _, p in got],
                                   [p for _, p in want], rtol=1e-7)


class TestMarkovChain:
    def test_row_normalized_topn(self):
        jm, pm = _both([0, 0, 0, 0, 1, 1], [1, 1, 1, 2, 0, 0], 3, 2)
        _assert_alike(jm, pm)
        nxt = markov.predict_next(pm, 0)
        assert nxt[0] == (1, pytest.approx(0.75))
        assert nxt[1] == (2, pytest.approx(0.25))
        assert markov.predict_next(pm, 1) == [(0, pytest.approx(1.0))]
        assert markov.predict_next(pm, 2) == []

    def test_topn_truncates(self):
        jm, pm = _both(np.zeros(6, np.int64), [1, 2, 3, 4, 5, 1], 6, 2)
        _assert_alike(jm, pm)
        assert markov.predict_next(pm, 0)[0][0] == 1

    def test_weighted(self):
        jm, pm = _both([0, 0], [1, 2], 3, 3, weights=[3.0, 1.0])
        _assert_alike(jm, pm)
        assert dict(markov.predict_next(pm, 0))[1] == pytest.approx(0.75)

    def test_fractional_weights_normalize(self):
        jm, pm = _both([0], [1], 2, 2, weights=[0.5])
        _assert_alike(jm, pm)
        assert markov.predict_next(pm, 0) == [(1, pytest.approx(1.0))]

    @pytest.mark.parametrize("seed,n_states,top_n",
                             [(0, 30, 10), (1, 64, 64), (2, 200, 5)])
    def test_ties_rank_lower_state_first(self, seed, n_states, top_n):
        # few transitions a state over few targets: counts tie often,
        # and the tail of each row is all zeros
        rng = np.random.default_rng(seed)
        n = 8 * n_states
        frm = rng.integers(0, n_states, n)
        to = rng.integers(0, min(n_states, 12), n)
        jm, pm = _both(frm, to, n_states, top_n)
        _assert_alike(jm, pm)
        assert pm.indices.dtype == torch.int32
        probs = pm.probs.numpy()
        assert (np.diff(probs, axis=1) <= 0).all()
        idx = pm.indices.numpy()
        tied = (probs[:, 1:] == probs[:, :-1])
        assert tied.any()
        assert (idx[:, 1:][tied] > idx[:, :-1][tied]).all()

    def test_top_n_clamps_to_states(self):
        jm, pm = _both([0, 1], [1, 0], 2, 10)
        _assert_alike(jm, pm)
        assert pm.indices.shape == (2, 2)


class TestBinaryVectorizer:
    def test_from_property_maps_and_transform(self):
        maps = [{"color": "red", "size": "L"}, {"color": "blue"}]
        v, jv = (BinaryVectorizer.from_property_maps(maps),
                 JaxVectorizer.from_property_maps(maps))
        assert v.n_features == jv.n_features == 3
        for pm in ({"color": "red", "size": "L"},
                   {"color": "blue", "size": "XL"}, {}):
            np.testing.assert_array_equal(v.transform(pm), jv.transform(pm))
        v2 = BinaryVectorizer([("a", "bc"), ("ab", "c")])
        assert v2.n_features == 2
        assert v2.transform({"a": "bc"}).sum() == 1.0

    def test_field_filter_and_batch(self):
        maps = [{"color": "red", "noise": "x", "n": 3},
                {"color": "green", "n": 3.0}]
        for fields in (["color"], None, ["n", "noise"]):
            v = BinaryVectorizer.from_property_maps(maps, fields=fields)
            jv = JaxVectorizer.from_property_maps(maps, fields=fields)
            batch = [{"color": "red"}, {"color": "green", "n": 3},
                     {"noise": "x"}]
            got = v.transform_batch(batch)
            np.testing.assert_array_equal(got, jv.transform_batch(batch))
            assert got.dtype == np.float32
            assert v.transform_batch([]).shape == (0, v.n_features)
