"""RTN quant math: closed-form checks + parity with the reference
semantics (``/root/reference/mxmoe/quant/quant.py:40-109``) reimplemented
independently in numpy."""

import numpy as np
import jax.numpy as jnp
import pytest

from mxmoe.quant import (
    QLinearConfig,
    quantize,
    dequantize,
    fake_quant,
    parse_scheme,
    strategy_bits,
)


def numpy_minmax_ref(t, bits, gsize, sym, clip=(1.0, 1.0)):
    """Independent numpy reimplementation of grouped min-max quant."""
    g = t.shape[-1] if gsize == -1 else gsize
    x = t.reshape(-1, g).astype(np.float64)
    if bits == 1.5:
        upper, lower, sym = 1.0, -1.0, True
    elif bits == 1:
        upper, lower, sym = 1.0, 0.0, False
    elif sym:
        upper = float(2 ** (bits - 1) - 1)
        lower = -upper
    else:
        upper = float(2**bits - 1)
        lower = 0.0
    if sym:
        scale = np.abs(x).max(-1) / upper
        zp = np.zeros_like(scale)
    else:
        gmin = x.min(-1) * clip[0]
        gmax = x.max(-1) * clip[1]
        scale = (gmax - gmin) / upper
        zp = gmin
    safe = np.where(scale == 0, 1.0, scale)
    q = np.round(np.clip((x - zp[:, None]) / safe[:, None], lower, upper))
    deq = q * scale[:, None] + zp[:, None]
    return deq.reshape(t.shape)


@pytest.mark.parametrize("bits,sym", [(8, True), (8, False), (4, True), (4, False), (2, False), (1.5, True), (1, False)])
@pytest.mark.parametrize("gsize", [-1, 64])
def test_fake_quant_matches_numpy_ref(bits, sym, gsize):
    rng = np.random.default_rng(0)
    t = rng.standard_normal((8, 128)).astype(np.float32)
    got = np.asarray(fake_quant(jnp.asarray(t), bits, gsize, sym))
    want = numpy_minmax_ref(t, bits, gsize, sym)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_quant_codes_in_range():
    rng = np.random.default_rng(1)
    t = jnp.asarray(rng.standard_normal((4, 64)).astype(np.float32))
    q = quantize(t, 4, -1, True)
    assert float(q.codes.max()) <= 7 and float(q.codes.min()) >= -7
    q = quantize(t, 4, -1, False)
    assert float(q.codes.max()) <= 15 and float(q.codes.min()) >= 0


def test_roundtrip_is_idempotent():
    # fake_quant(fake_quant(x)) == fake_quant(x)
    rng = np.random.default_rng(2)
    t = jnp.asarray(rng.standard_normal((4, 128)).astype(np.float32))
    once = fake_quant(t, 4, 128, False)
    twice = fake_quant(once, 4, 128, False)
    np.testing.assert_allclose(np.asarray(once), np.asarray(twice), rtol=1e-5, atol=1e-6)


def test_16bit_passthrough():
    t = jnp.ones((2, 8))
    assert fake_quant(t, 16, -1, True) is t


def test_8bit_sym_error_bound():
    rng = np.random.default_rng(3)
    t = jnp.asarray(rng.standard_normal((16, 256)).astype(np.float32))
    fq = fake_quant(t, 8, -1, True)
    # max error <= scale/2 = absmax/127/2 per row
    err = np.abs(np.asarray(fq - t)).max(-1)
    bound = np.abs(np.asarray(t)).max(-1) / 127 / 2 + 1e-6
    assert (err <= bound).all()


def test_scheme_grammar_roundtrip():
    cfg = parse_scheme("w4a4_g-1_sym")
    assert cfg.w_bits == 4 and cfg.a_bits == 4 and cfg.w_gsize == -1 and cfg.w_sym
    assert cfg.scheme_name == "w4a4_g-1_sym"
    cfg = parse_scheme("w2a16_g128_asym")
    assert cfg.w_bits == 2 and cfg.a_bits == 16 and cfg.w_gsize == 128 and not cfg.w_sym
    assert cfg.is_weight_only


def test_strategy_bits_table():
    # matches reference get_strategy_bits (bits_solver.py:581-596)
    assert strategy_bits("w4a4_g-1_sym") == (4, 4)
    assert strategy_bits("w8a8_g-1_sym") == (8, 8)
    assert strategy_bits("w4a16_g128_asym") == (4.25, 16)
    assert strategy_bits("w2a16_g128_asym") == (2.25, 16)
    assert strategy_bits("w4a4_g128_sym") == (4.25, 4.25)


def test_qmodel_config_json_roundtrip(tmp_path):
    from mxmoe.quant import build_uniform_model, QModelConfig

    cfg = build_uniform_model(parse_scheme("w8a8_g-1_sym"), num_layers=2, num_experts=3)
    cfg.lt = {"0": (0.5, 1.25), "1": (0.25, 2.0)}
    p = tmp_path / "q.json"
    cfg.save(p)
    back = QModelConfig.load(p)
    assert back.layers["1"].experts["2"].down.w_bits == 8
    assert back.lt["0"] == (0.5, 1.25)
    assert back.all_schemes() == ["w8a8_g-1_sym"]


def test_mse_clip_search_reduces_reconstruction_error():
    """w_clip="mse" (reference find_params mse branch, gptq.py:96-110):
    the grid-searched clip must not increase — and on outlier-heavy
    weights must strictly decrease — per-group ||W - Q(W)||^2.4."""
    import numpy as np

    rng = np.random.default_rng(0)
    # heavy-tailed rows: a few large outliers per group make the min-max
    # scale waste most codes, exactly where clipping pays
    w = rng.standard_normal((64, 128)).astype(np.float32)
    w[:, ::17] *= 8.0
    wj = jnp.asarray(w)

    def err(clip):
        fq = fake_quant(wj, 4, -1, True, clip)
        return float(jnp.sum(jnp.abs(fq - wj) ** 2.4))

    e_minmax = err((1.0, 1.0))
    e_mse = err("mse")
    assert e_mse < e_minmax * 0.9, (e_mse, e_minmax)

    # asym + grouped paths run too (no crash, no regression)
    for sym, g in ((False, 32), (True, 32), (False, -1)):
        fq_m = fake_quant(wj, 4, g, sym, "mse")
        fq_0 = fake_quant(wj, 4, g, sym)
        em = float(jnp.sum(jnp.abs(fq_m - wj) ** 2.4))
        e0 = float(jnp.sum(jnp.abs(fq_0 - wj) ** 2.4))
        assert em <= e0 * 1.0001, (sym, g, em, e0)


def test_mse_clip_through_scheme_grammar_and_json():
    from mxmoe.quant.schemes import QLinearConfig, parse_scheme

    c = parse_scheme("w4a4_g-1_sym_mse")
    assert c.w_clip == "mse" and c.w_bits == 4 and c.a_bits == 4
    rt = QLinearConfig.from_dict(c.to_dict())
    assert rt.w_clip == "mse"
    assert parse_scheme("w4a4_g-1_sym").w_clip == (1.0, 1.0)


def test_mse_clip_in_gptq_find_params():
    """GPTQ's per-channel params honor the mse clip (reference runs the
    grid inside GPTQ's find_params)."""
    import numpy as np

    from mxmoe.quant.gptq import _find_group_params
    from mxmoe.quant.rtn import quant_ranges

    rng = np.random.default_rng(1)
    w = rng.standard_normal((2, 8, 64)).astype(np.float32)
    w[..., ::13] *= 6.0
    wj = jnp.asarray(w)
    upper, lower, _ = quant_ranges(4, True)

    def recon_err(scale, zp):
        q = jnp.clip(jnp.round((wj - zp[..., None]) / scale[..., None]),
                     lower, upper)
        deq = q * scale[..., None] + zp[..., None]
        return float(jnp.sum(jnp.abs(deq - wj) ** 2.4))

    s0, z0 = _find_group_params(wj, 4, True)
    sm, zm = _find_group_params(wj, 4, True, clip="mse")
    assert recon_err(sm, zm) < recon_err(s0, z0)
