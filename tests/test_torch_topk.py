"""The port's fused top-k against the JAX package's.

On the CPU the port's ``fused_top_k_dot`` runs its plain version; it is
held against the Pallas kernel run by the interpreter
(``fused_top_k_dot(..., interpret=True)``) and against the XLA path, for
the three kernel forms (float32, bfloat16, int8 + scale), over every case
of ``tests/test_pallas_topk.py`` plus planted exact ties. Inputs come
from numpy with a seed and go to both packages.

Tolerance: scores within 1e-5 absolute + 1e-5 relative (XLA-CPU and
torch-CPU sum the k products in different orders); indices exactly
equal, since the drawn scores have no near-ties at that scale and the
planted ties are exact in both.

The kernel itself runs only on a CUDA card: ``test_torch_gpu.py`` holds
it against the plain version there.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from predictionio_tpu.ops import quantize as jq
from predictionio_tpu.ops.pallas_topk import fused_top_k_dot as jax_fused
from predictionio_tpu.ops.similarity import _top_k_dot_xla
from predictionio_tpu_torch.ops import fused_topk

FORMS = ("f32", "bf16", "int8")
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(form, b, n, k, seed, nan_rows=(), tie_rows=()):
    """numpy (queries, items data, scale) for one form. NaN rows are NaN
    factors (f32/bf16) or a NaN scale (int8, which cannot hold NaN); tie
    rows are exact copies of the first of them, scaled up so they rank."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, k)).astype(np.float32)
    items = rng.standard_normal((n, k)).astype(np.float32)
    if tie_rows:
        items[list(tie_rows)] = items[tie_rows[0]] * 6.0
    if form == "int8":
        qf = jq.quantize_factors(items, "int8")
        data = np.asarray(qf.data)
        scale = np.asarray(qf.scale).copy()
        scale[list(nan_rows)] = np.nan
        return q, data, scale
    items[list(nan_rows)] = np.nan
    return q, items, None


def _jax_items(form, data):
    if form == "bf16":
        return jnp.asarray(data, jnp.bfloat16)
    return jnp.asarray(data)


def _torch_items(form, data):
    t = torch.from_numpy(np.array(data))
    return t.to(torch.bfloat16) if form == "bf16" else t


def _both(form, q, data, scale, num, mask=None, block=1024):
    """(port scores, port indices, jax scores, jax indices) as numpy;
    an [I] mask goes to the port as it is and widened to the JAX kernel,
    which takes [B, I] only."""
    jmask = None
    if mask is not None:
        jmask = np.broadcast_to(mask, (q.shape[0], data.shape[0]))
        jmask = jnp.asarray(jmask)
    js, ji = jax_fused(
        jnp.asarray(q), _jax_items(form, data), num, mask=jmask,
        block=block, interpret=True,
        scale=None if scale is None else jnp.asarray(scale),
    )
    ps, pi = fused_topk.fused_top_k_dot(
        torch.from_numpy(q), _torch_items(form, data), num,
        None if mask is None else torch.from_numpy(np.asarray(mask)),
        None if scale is None else torch.from_numpy(scale),
    )
    assert ps.dtype == torch.float32 and pi.dtype == torch.int32
    return ps.numpy(), pi.numpy(), np.asarray(js), np.asarray(ji)


def _check(form, q, data, scale, num, mask=None, block=1024):
    ps, pi, js, ji = _both(form, q, data, scale, num, mask, block)
    np.testing.assert_allclose(ps, js, **TOL)
    np.testing.assert_array_equal(pi, ji)
    return ps, pi


def _check_unfilled(form, q, data, scale, num, mask=None, block=1024):
    """Scores against the Pallas interpreter, every index (the -inf
    slots' included) against the XLA path's ``lax.top_k``."""
    ps, pi, js, _ = _both(form, q, data, scale, num, mask, block)
    np.testing.assert_allclose(ps, js, **TOL)
    _, xi = _xla_reference(form, q, data, scale, num, mask)
    np.testing.assert_array_equal(pi, np.asarray(xi))
    return ps, pi


def _xla_reference(form, q, data, scale, num, mask=None):
    """The JAX package's XLA path for the same form."""
    if form == "f32":
        return _top_k_dot_xla(
            jnp.asarray(q), jnp.asarray(data), num,
            None if mask is None else jnp.asarray(mask),
        )
    return jq._top_k_dot_quant_xla(
        jnp.asarray(q), _jax_items(form, data),
        None if scale is None else jnp.asarray(scale), num,
        None if mask is None else jnp.asarray(mask),
    )


@pytest.mark.parametrize("form", FORMS)
class TestAgainstPallasInterpreter:
    def test_single_block(self, form):
        q, d, s = _inputs(form, 8, 100, 16, seed=0)
        _check(form, q, d, s, 10)

    def test_multi_block(self, form):
        q, d, s = _inputs(form, 4, 1000, 8, seed=1)
        _check(form, q, d, s, 7, block=256)

    def test_padding_never_selected(self, form):
        q, d, s = _inputs(form, 3, 130, 4, seed=2)
        _, pi = _check(form, q, d, s, 130, block=256)
        assert pi.min() >= 0 and pi.max() < 130

    def test_batch_mask_excludes(self, form):
        q, d, s = _inputs(form, 5, 300, 8, seed=3)
        mask = np.zeros((5, 300), dtype=bool)
        mask[:, :250] = True
        _, pi = _check(form, q, d, s, 5, mask=mask, block=128)
        assert (pi >= 250).all()

    def test_item_mask_taken_unwidened(self, form):
        q, d, s = _inputs(form, 5, 300, 8, seed=4)
        mask = np.random.default_rng(4).random(300) < 0.3
        _, pi = _check(form, q, d, s, 6, mask=mask, block=128)
        assert not mask[pi].any()

    def test_num_larger_than_items(self, form):
        q, d, s = _inputs(form, 2, 6, 4, seed=5)
        ps, pi = _check(form, q, d, s, 10)
        assert ps.shape == pi.shape == (2, 6)
        assert len(set(pi[0].tolist())) == 6

    def test_single_query_row(self, form):
        q, d, s = _inputs(form, 1, 400, 8, seed=6)
        _check(form, q, d, s, 3, block=128)

    def test_ragged_tail(self, form):
        # 1000 items, block 256: three whole blocks + a 232-item tail
        q, d, s = _inputs(form, 4, 1000, 8, seed=7)
        _check(form, q, d, s, 9, block=256)

    def test_nan_rows_excluded(self, form):
        q, d, s = _inputs(form, 3, 600, 8, seed=8, nan_rows=(100, 500))
        ps, pi = _check(form, q, d, s, 5, block=256)
        assert not np.isin(pi, [100, 500]).any()
        assert np.isfinite(ps).all()

    def test_overmasked_row(self, form):
        # scores against the Pallas interpreter; the -inf slots' indices
        # against lax.top_k (the XLA path the JAX dispatcher takes at
        # these shapes), which lists the masked items ascending: the
        # Pallas kernel leaves index 0 there, an index JAX calls arbitrary
        q, d, s = _inputs(form, 2, 40, 4, seed=9)
        mask = np.ones((2, 40), dtype=bool)
        mask[:, :3] = False
        ps, pi = _check_unfilled(form, q, d, s, 5, mask=mask, block=128)
        assert np.isneginf(ps[:, 3:]).all()
        np.testing.assert_array_equal(pi[:, 3:], [[3, 4]] * 2)
        assert (pi[:, :3] < 3).all()

    def test_nan_query_row(self, form):
        # a NaN user row scores NaN everywhere: every slot -inf, items
        # 0, 1, 2, ... as lax.top_k lists them
        q, d, s = _inputs(form, 3, 300, 8, seed=11)
        q[1] = np.nan
        ps, pi = _check_unfilled(form, q, d, s, 6, block=128)
        assert np.isneginf(ps[1]).all() and np.isfinite(ps[[0, 2]]).all()
        np.testing.assert_array_equal(pi[1], np.arange(6))

    def test_num_above_rankable(self, form):
        # NaN rows and an item mask leave fewer rankable items than num;
        # the unrankable ones fill the tail by index, skipping none twice
        q, d, s = _inputs(form, 4, 50, 8, seed=12, nan_rows=(0, 7, 31))
        mask = np.zeros(50, dtype=bool)
        mask[10:48] = True
        ps, pi = _check_unfilled(form, q, d, s, 20, mask=mask, block=128)
        assert np.isfinite(ps[:, :10]).all()
        assert np.isneginf(ps[:, 10:]).all()
        np.testing.assert_array_equal(
            pi[:, 10:], [[0, 7, 10, 11, 12, 13, 14, 15, 16, 17]] * 4)
        for row in pi:
            assert len(set(row.tolist())) == 20

    def test_planted_ties_lower_index_first(self, form):
        # equal rows in three different blocks rank by index, as
        # lax.top_k orders them
        ties = (650, 10, 300)
        q, d, s = _inputs(form, 4, 700, 8, seed=10, tie_rows=ties)
        q[:, :] = np.abs(q) * np.sign(d[10].astype(np.float32))
        ps, pi = _check(form, q, d, s, 5, block=256)
        np.testing.assert_array_equal(pi[:, :3], [[10, 300, 650]] * 4)
        assert (ps[:, 0] == ps[:, 1]).all() and (ps[:, 1] == ps[:, 2]).all()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize(
    "b,n,num,masked",
    [(8, 100, 10, False), (4, 1000, 9, False), (5, 300, 5, True)],
)
def test_against_xla_path(form, b, n, num, masked):
    q, d, s = _inputs(form, b, n, 8, seed=b + n)
    mask = None
    if masked:
        mask = np.zeros((b, n), dtype=bool)
        mask[:, ::3] = True
    ps, pi = fused_topk.fused_top_k_dot(
        torch.from_numpy(q), _torch_items(form, d), num,
        None if mask is None else torch.from_numpy(mask),
        None if s is None else torch.from_numpy(s),
    )
    xs, xi = _xla_reference(form, q, d, s, num, mask)
    np.testing.assert_allclose(ps.numpy(), np.asarray(xs), **TOL)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(xi))


def test_reference_is_a_stable_sort():
    # every score equal: the plain version must return indices in order
    q = torch.ones(2, 4)
    items = torch.ones(50, 4)
    s, i = fused_topk.fused_top_k_dot_reference(q, items, 20)
    assert (s == 4.0).all()
    assert i.tolist() == [list(range(20))] * 2
