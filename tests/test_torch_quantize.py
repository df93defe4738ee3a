"""The port's quantized factor tables against the JAX package's.

The same numpy factors go to ``predictionio_tpu.ops.quantize`` and
``predictionio_tpu_torch.ops.quantize``. The int8 data must be equal to
the bit (both divide by the scale and round half to even), the scale
within rtol 1e-6; dequantized values, gathered rows and norms within
1e-6; quantized top-k within the top-k tests' tolerance (1e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from predictionio_tpu.models.recommendation import ALSRecModel as JaxModel
from predictionio_tpu.ops import quantize as jq
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.convert import from_jax_model
from predictionio_tpu_torch.ops import quantize as tq


def _factors(n=300, k=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k)).astype(np.float32)
    x *= np.exp(rng.standard_normal((n, 1))).astype(np.float32)
    x[7] = 0.0  # a zero row keeps scale 1.0 and stays exactly zero
    # values whose quotient lands on .5 exercise round-half-to-even
    x[11] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -127.0]
    return x


class TestQuantizeMatchesJax:
    def test_int8_data_bit_equal_and_scale_close(self):
        x = _factors()
        j = jq.quantize_factors(x, "int8")
        t = tq.quantize_factors(torch.from_numpy(x), "int8")
        assert t.data.dtype == torch.int8
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_allclose(
            t.scale.numpy(), np.asarray(j.scale), rtol=1e-6
        )
        assert t.scale[7] == 1.0 and (t.data[7] == 0).all()

    def test_bf16_data_bit_equal(self):
        x = _factors(seed=1)
        j = jq.quantize_factors(x, "bf16")
        t = tq.quantize_factors(x, "bf16")
        assert t.scale is None and t.mode == "bf16"
        np.testing.assert_array_equal(
            t.data.view(torch.int16).numpy(),
            np.asarray(j.data).view(np.int16),
        )

    @pytest.mark.parametrize("mode", tq.MODES)
    def test_dequantize(self, mode):
        x = _factors(seed=2)
        j = np.asarray(jq.dequantize(jq.quantize_factors(x, mode)))
        t = tq.dequantize(tq.quantize_factors(x, mode)).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("mode", tq.MODES)
    def test_gather_rows(self, mode):
        x = _factors(seed=3)
        idx = np.array([0, 7, 11, 299, 5, 5], np.int32)
        j = np.asarray(jq.gather_rows(jq.quantize_factors(x, mode), idx))
        t = tq.gather_rows(tq.quantize_factors(x, mode), idx).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
        plain = tq.gather_rows(torch.from_numpy(x), idx).numpy()
        np.testing.assert_array_equal(plain, x[idx])

    @pytest.mark.parametrize("mode", tq.MODES)
    def test_normalized(self, mode):
        x = _factors(seed=4)
        j = jq.normalized(jq.quantize_factors(x, mode))
        t = tq.normalized(tq.quantize_factors(x, mode))
        np.testing.assert_allclose(
            t.scale.numpy(), np.asarray(j.scale), rtol=1e-6
        )

    @pytest.mark.parametrize("mode", tq.MODES)
    def test_top_k_dot_quantized(self, mode):
        x = _factors(seed=5)
        q = np.random.default_rng(5).standard_normal((4, 8)).astype(
            np.float32
        )
        js, ji = jq.top_k_dot_quantized(
            jnp.asarray(q), jq.quantize_factors(x, mode), 12
        )
        ts, ti = tq.top_k_dot_quantized(
            torch.from_numpy(q), tq.quantize_factors(x, mode), 12
        )
        np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    def test_unknown_mode_and_shape_raise(self):
        with pytest.raises(ValueError):
            tq.quantize_factors(np.zeros((2, 2), np.float32), "int4")
        with pytest.raises(ValueError):
            tq.quantize_factors(np.zeros(3, np.float32), "int8")


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(6)
    ref = np.stack([rng.permutation(50)[:10] for _ in range(9)])
    got = ref.copy()
    got[::2, -3:] = 99
    assert tq.recall_at_k(ref, got) == jq.recall_at_k(ref, got)
    assert tq.recall_at_k(ref, ref) == 1.0
    with pytest.raises(ValueError):
        tq.recall_at_k(ref, got[:, :5])


def _jax_model():
    x = _factors(seed=7)
    users = np.random.default_rng(7).standard_normal((20, 8)).astype(
        np.float32
    )
    return JaxModel(
        user_factors=users,
        item_factors=x,
        user_map=JaxBiMap([f"u{i}" for i in range(20)]),
        item_map=JaxBiMap([f"i{i}" for i in range(300)]),
    )


@pytest.mark.parametrize("mode", tq.MODES)
def test_quantize_model_and_resident_bytes(mode):
    jm = _jax_model()
    tm = from_jax_model(jm)
    assert tq.model_resident_bytes(tm) == jq.model_resident_bytes(jm)
    jqm = jq.quantize_model_factors(jm, mode)
    tqm = tq.quantize_model_factors(tm, mode)
    assert isinstance(tqm.user_factors, tq.QuantizedFactors)
    assert isinstance(tqm.item_factors, tq.QuantizedFactors)
    assert tqm.user_map is tm.user_map
    assert tq.model_resident_bytes(tqm) == jq.model_resident_bytes(jqm)
    # already quantized fields, non-dataclasses and mode "" pass through
    assert tq.quantize_model_factors(tqm, mode).item_factors is (
        tqm.item_factors
    )
    assert tq.quantize_model_factors(tm, "") is tm
    assert tq.quantize_model_factors("x", mode) == "x"


def test_stage_quantized_keeps_table():
    qf = tq.quantize_factors(_factors(seed=8), "int8")
    staged = tq.stage_quantized(qf, "cpu")
    assert torch.equal(staged.data, qf.data)
    assert staged.nbytes == qf.nbytes == 300 * 8 + 300 * 4
    assert dataclasses.replace(staged).shape == (300, 8)
