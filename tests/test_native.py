"""Native C++ pack library vs JAX reference implementations."""

import numpy as np
import pytest

from mxmoe import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="libmxmoe_pack.so not built"
)


def test_rtn_quant_matches_jax_sym():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((32, 64)).astype(np.float32)
    codes, scales, zps = native.rtn_quant(w, gsize=-1, bits=8, sym=True)

    import jax.numpy as jnp
    from mxmoe.quant.packing import quantize_weight_kn
    from mxmoe.quant.schemes import QLinearConfig

    p = quantize_weight_kn(jnp.asarray(w).T, QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True))
    np.testing.assert_array_equal(codes, np.asarray(p.values, np.int8).T)
    np.testing.assert_allclose(scales, np.asarray(p.scale).T, rtol=1e-6)


def test_rtn_quant_matches_jax_asym_grouped():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((16, 128)).astype(np.float32)
    codes, scales, zps = native.rtn_quant(w, gsize=32, bits=4, sym=False)

    import jax.numpy as jnp
    from mxmoe.quant.packing import quantize_weight_kn
    from mxmoe.quant.schemes import QLinearConfig

    p = quantize_weight_kn(jnp.asarray(w).T, QLinearConfig(w_bits=4, w_gsize=32, w_sym=False))
    np.testing.assert_array_equal(codes, np.asarray(p.values, np.int8).T)
    np.testing.assert_allclose(scales, np.asarray(p.scale).T, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(zps, np.asarray(p.zp).T, rtol=1e-5, atol=1e-6)
    # dequant roundtrip error bounded by scale/2
    deq = codes.reshape(16, 4, 32).astype(np.float32) * scales[..., None] + zps[..., None]
    assert np.abs(deq.reshape(16, 128) - w).max() <= scales.max() * 0.51


def test_pack_int4_matches_jax():
    rng = np.random.default_rng(2)
    codes = rng.integers(-8, 8, size=(64, 32)).astype(np.int8)
    got = native.pack_int4(codes)

    import jax.numpy as jnp
    from mxmoe.quant.packing import pack_int4_rows

    want = np.asarray(pack_int4_rows(jnp.asarray(codes)))
    np.testing.assert_array_equal(got, want)


def test_transpose_and_bf16():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((100, 70)).astype(np.float32)
    np.testing.assert_array_equal(native.transpose_f32(a), a.T)

    f = rng.standard_normal(1000).astype(np.float32)
    bf_bits = (f.view(np.uint32) >> 16).astype(np.uint16)  # truncate to bf16
    back = native.bf16_to_f32(bf_bits)
    np.testing.assert_allclose(back, f, rtol=1e-2)
