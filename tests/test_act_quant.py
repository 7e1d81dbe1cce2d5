"""Dynamic activation quant (quant/qparams.py) vs an independent numpy
reference.

The grouped int8 kernel consumes these codes+scales; on the GPU XLA runs
them as one row-amax reduction plus one quantize pass (PERF.md "Act
quant"). Semantics:
  upper = 2^(min(bits,8)-1) - 1;  scale = max(amax(|x|), 1e-8)/upper
  q     = round_half_even(x/scale)  (int8; |x|/scale <= upper)
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mxmoe.quant.qparams import (quantize_act_per_row_bits,
                                 quantize_act_per_token)


def _np_quant(x, bits):
    xf = np.asarray(x, np.float32)
    upper = (np.exp2(np.minimum(np.asarray(bits, np.float32), 8.0) - 1.0)
             - 1.0).astype(np.float32)
    amax = np.max(np.abs(xf), axis=-1)
    scale = (np.maximum(amax, np.float32(1e-8)) / upper).astype(np.float32)
    q = np.round(xf / scale[:, None]).astype(np.int8)
    return q, scale[:, None]


def _bf16(rng, m, k):
    return jnp.asarray(rng.standard_normal((m, k)), jnp.float32).astype(
        jnp.bfloat16)


@pytest.mark.parametrize("m,k", [(37, 64), (256, 128), (300, 256)])
def test_quantize_rows_matches_reference(m, k):
    rng = np.random.default_rng(0)
    x = _bf16(rng, m, k)
    bits = rng.choice([4.0, 8.0, 16.0], m).astype(np.float32)
    q, s = quantize_act_per_row_bits(x, jnp.asarray(bits))
    q_ref, s_ref = _np_quant(x, np.broadcast_to(bits, (m,)))
    np.testing.assert_array_equal(np.asarray(q), q_ref)
    np.testing.assert_allclose(np.asarray(s), s_ref, rtol=1e-7)
    # codes stay inside each row's clip range
    upper = np.exp2(np.minimum(bits, 8.0) - 1.0) - 1.0
    assert np.all(np.abs(np.asarray(q, np.int32)) <= upper[:, None])


def test_quantize_rows_scale_equivariant():
    """Scaling a row by a power of two scales its scale and keeps its
    codes (the bench's chained-timing scale rides the activation read)."""
    rng = np.random.default_rng(1)
    x = _bf16(rng, 64, 128)
    bits = jnp.full((64,), 8.0, jnp.float32)
    q, s = quantize_act_per_row_bits(x, bits)
    q2, s2 = quantize_act_per_row_bits(x * 4, bits)
    np.testing.assert_array_equal(np.asarray(q2), np.asarray(q))
    np.testing.assert_array_equal(np.asarray(s2), np.asarray(s) * 4)


def test_quantize_rows_uniform_matches_per_token():
    rng = np.random.default_rng(2)
    x = _bf16(rng, 50, 96)
    q, s = quantize_act_per_row_bits(x, jnp.full((50,), 8.0))
    q_ref, s_ref = quantize_act_per_token(x, 8)
    np.testing.assert_array_equal(np.asarray(q), np.asarray(q_ref))
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref))


def test_quantize_rows_wide_k():
    rng = np.random.default_rng(3)
    x = _bf16(rng, 16, 8192)
    q, s = quantize_act_per_token(x, 8)
    q_ref, s_ref = _np_quant(x, np.full((16,), 8.0))
    np.testing.assert_array_equal(np.asarray(q), q_ref)
    np.testing.assert_allclose(np.asarray(s), s_ref, rtol=1e-7)


@pytest.mark.parametrize("m", [1, 2, 8, 31])
def test_quantize_rows_tiny_m(m):
    """Decode-size batches (m as small as top_k) quantize exactly."""
    rng = np.random.default_rng(4)
    x = _bf16(rng, m, 128)
    bits = rng.choice([4.0, 8.0], m).astype(np.float32)
    q, s = quantize_act_per_row_bits(x, jnp.asarray(bits))
    q_ref, s_ref = _np_quant(x, bits)
    np.testing.assert_array_equal(np.asarray(q), q_ref)
    np.testing.assert_allclose(np.asarray(s), s_ref, rtol=1e-7)
