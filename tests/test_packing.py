"""Packed integer storage round-trips vs fake-quant."""

import numpy as np
import jax.numpy as jnp
import pytest

from mxmoe.quant import (
    parse_scheme,
    quantize_act,
    quantize_weight_kn,
    dequantize_act,
    dequantize_weight_kn,
    fake_quant_act,
    fake_quant_weight,
)


@pytest.mark.parametrize("scheme", ["w8a8_g-1_sym", "w4a4_g-1_sym", "w4a4_g128_sym", "w4a16_g-1_asym", "w4a16_g128_asym", "w8a16_g-1_asym", "w2a16_g128_asym"])
def test_weight_pack_roundtrip(scheme):
    cfg = parse_scheme(scheme)
    rng = np.random.default_rng(0)
    w_kn = jnp.asarray(rng.standard_normal((256, 64)).astype(np.float32))  # [K, N]
    packed = quantize_weight_kn(w_kn, cfg)
    deq = np.asarray(dequantize_weight_kn(packed))
    # must equal fake-quant applied in the [N, K] orientation then transposed
    want = np.asarray(fake_quant_weight(w_kn.T, cfg)).T
    np.testing.assert_allclose(deq, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scheme", ["w8a8_g-1_sym", "w4a4_g-1_sym", "w4a4_g128_sym"])
def test_act_pack_roundtrip(scheme):
    cfg = parse_scheme(scheme)
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal((32, 256)).astype(np.float32))
    packed = quantize_act(a, cfg)
    deq = np.asarray(dequantize_act(packed))
    want = np.asarray(fake_quant_act(a, cfg))
    np.testing.assert_allclose(deq, want, rtol=1e-4, atol=1e-4)


def test_storage_dtypes():
    # sub-byte codes live in int8; true 4-bit density comes from explicit
    # nibble packing
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.standard_normal((128, 32)).astype(np.float32))
    assert quantize_weight_kn(w, parse_scheme("w4a4_g-1_sym")).values.dtype == jnp.int8
    assert quantize_weight_kn(w, parse_scheme("w8a8_g-1_sym")).values.dtype == jnp.int8
    assert quantize_weight_kn(w, parse_scheme("w2a16_g128_asym")).values.dtype == jnp.int8


def test_int4_nibble_pack_roundtrip():
    from mxmoe.quant.packing import pack_int4_rows, unpack_int4_rows

    rng = np.random.default_rng(5)
    codes = jnp.asarray(rng.integers(-8, 8, size=(3, 64, 16)), jnp.int8)
    packed = pack_int4_rows(codes)
    assert packed.shape == (3, 32, 16)
    np.testing.assert_array_equal(np.asarray(unpack_int4_rows(packed)), np.asarray(codes))


def test_asym_codes_recentred_to_signed():
    cfg = parse_scheme("w4a16_g-1_asym")
    rng = np.random.default_rng(3)
    w = jnp.asarray(rng.standard_normal((64, 16)).astype(np.float32))
    p = quantize_weight_kn(w, cfg)
    codes = np.asarray(p.values.astype(jnp.int8))
    assert codes.min() >= -8 and codes.max() <= 7
