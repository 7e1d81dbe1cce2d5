"""GPTQ correctness: identity-Hessian equivalence to RTN, and loss
improvement over RTN under correlated calibration activations."""

import jax
import jax.numpy as jnp
import numpy as np

from mxmoe.quant.gptq import accumulate_hessian, gptq_quantize
from mxmoe.quant.rtn import fake_quant
from mxmoe.quant.schemes import QLinearConfig


def _rtn_fq_rows(w, cfg):
    return fake_quant(w, cfg.w_bits, cfg.w_gsize, cfg.w_sym, cfg.w_clip)


def test_identity_hessian_reduces_to_rtn():
    e, n, k = 2, 16, 64
    w = jax.random.normal(jax.random.PRNGKey(0), (e, n, k))
    cfg = QLinearConfig(w_bits=4, w_gsize=-1, w_sym=True)
    h = jnp.broadcast_to(jnp.eye(k), (e, k, k))
    res = gptq_quantize(w, h, cfg, percdamp=0.0)
    ref = _rtn_fq_rows(w, cfg)
    np.testing.assert_allclose(np.asarray(res.w_fq), np.asarray(ref), atol=1e-5)


def test_gptq_beats_rtn_on_correlated_inputs():
    e, n, k, m = 3, 32, 64, 512
    key = jax.random.PRNGKey(1)
    k1, k2, k3 = jax.random.split(key, 3)
    w = jax.random.normal(k1, (e, n, k))
    # strongly correlated activations: low-rank + noise
    z = jax.random.normal(k2, (m, 8))
    mix = jax.random.normal(k3, (8, k))
    x = z @ mix + 0.1 * jax.random.normal(key, (m, k))

    h = jnp.broadcast_to(accumulate_hessian(x), (e, k, k))
    cfg = QLinearConfig(w_bits=3, w_gsize=-1, w_sym=True)
    res = gptq_quantize(w, h, cfg)
    rtn_fq = _rtn_fq_rows(w, cfg)

    def out_err(w_fq):
        d = (w_fq - w) @ x.T  # [E, N, M] output-space error
        return float(jnp.sqrt(jnp.sum(d * d)))

    assert out_err(res.w_fq) < 0.75 * out_err(rtn_fq)


def test_gptq_grouped_runs_and_improves():
    e, n, k, m = 2, 16, 128, 256
    key = jax.random.PRNGKey(4)
    w = jax.random.normal(key, (e, n, k))
    z = jax.random.normal(key, (m, 4)) @ jax.random.normal(key, (4, k))
    x = z + 0.05 * jax.random.normal(key, (m, k))
    h = jnp.broadcast_to(accumulate_hessian(x), (e, k, k))
    cfg = QLinearConfig(w_bits=4, w_gsize=32, w_sym=False)
    res = gptq_quantize(w, h, cfg)
    assert res.scale.shape == (e, n, k // 32)
    rtn_fq = _rtn_fq_rows(w, cfg)

    def out_err(w_fq):
        d = (w_fq - w) @ x.T
        return float(jnp.sqrt(jnp.sum(d * d)))

    assert out_err(res.w_fq) < out_err(rtn_fq)


def test_hessian_grouped_accumulation():
    m, k, e = 64, 16, 3
    x = jax.random.normal(jax.random.PRNGKey(5), (m, k))
    gs = jnp.array([20, 0, 44], jnp.int32)
    h = accumulate_hessian(x, gs, e)
    assert h.shape == (e, k, k)
    np.testing.assert_allclose(
        np.asarray(h[0]), np.asarray(2.0 * x[:20].T @ x[:20]), rtol=1e-4
    )
    np.testing.assert_allclose(np.asarray(h[1]), 0.0, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(h[2]), np.asarray(2.0 * x[20:].T @ x[20:]), rtol=1e-4
    )


def test_act_order_improves_or_matches_on_skewed_hessian():
    e, n, k, m = 2, 24, 64, 512
    key = jax.random.PRNGKey(7)
    w = jax.random.normal(key, (e, n, k))
    # strongly skewed per-column energies
    x = jax.random.normal(key, (m, k)) * (jnp.arange(k) % 7 + 0.2)
    h = jnp.broadcast_to(accumulate_hessian(x), (e, k, k))
    cfg = QLinearConfig(w_bits=3, w_gsize=-1, w_sym=True)
    plain = gptq_quantize(w, h, cfg)
    ao = gptq_quantize(w, h, cfg, act_order=True)

    def out_err(w_fq):
        d = (w_fq - w) @ x.T
        return float(jnp.sqrt(jnp.sum(d * d)))

    assert np.isfinite(np.asarray(ao.w_fq)).all()
    assert out_err(ao.w_fq) < out_err(plain.w_fq) * 1.05

    # grouped act-order round-trips: dequant(codes, scale, zp) == w_fq
    cfg_g = QLinearConfig(w_bits=4, w_gsize=16, w_sym=False)
    ao_g = gptq_quantize(w, h, cfg_g, act_order=True)
    deq = ao_g.codes * ao_g.scale + ao_g.zp   # per-column params
    np.testing.assert_allclose(np.asarray(deq), np.asarray(ao_g.w_fq),
                               rtol=1e-5, atol=1e-6)


def _corr_case(seed=0, e=2, n=16, k=64, m=256):
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    base = jax.random.normal(k1, (m, k), jnp.float32)
    xs = base + 0.5 * jnp.roll(base, 1, axis=1)        # correlated columns
    w = jax.random.normal(k2, (e, n, k), jnp.float32)
    h = jnp.stack([accumulate_hessian(xs) for _ in range(e)])
    return w, h, xs


def test_static_groups_scales_stay_group_aligned():
    """Reference static_groups (gptq.py:196-206): per-group params from the
    ORIGINAL weights -> [E, N, K//g] scales exactly dequantizable, with
    AND without act_order (the dynamic act-order path expands to
    per-column scales — storage-incompatible with packed g-serving;
    round-3 missing #3)."""
    w, h, _ = _corr_case()
    gsize = 16
    cfg = QLinearConfig(w_bits=4, w_gsize=gsize, w_sym=False, a_bits=16)
    for act_order in (False, True):
        res = gptq_quantize(w, h, cfg, act_order=act_order,
                            static_groups=True)
        e, n, k = w.shape
        assert res.scale.shape == (e, n, k // gsize), (act_order,
                                                       res.scale.shape)
        deq = (res.codes.reshape(e, n, k // gsize, gsize)
               * res.scale[..., None] + res.zp[..., None]).reshape(e, n, k)
        np.testing.assert_allclose(np.asarray(deq), np.asarray(res.w_fq),
                                   rtol=1e-6, atol=1e-6)
        # sanity: error not far from the dynamic-group sweep's
        err = float(jnp.mean((res.w_fq - w) ** 2))
        dyn = gptq_quantize(w, h, cfg, act_order=act_order)
        err_dyn = float(jnp.mean((dyn.w_fq - w) ** 2))
        assert err < 3.0 * err_dyn + 1e-6, (err, err_dyn)


def test_gptq_real_flex_packed_roundtrip():
    """Task-5 done criterion: grouped gptq-had with act_order REAL-
    quantizes (static groups), round-trips through packed serving
    bitwise-identically to int8-stored, and the served codes dequantize
    to exactly what the returned artifact claims (real-exec faithful)."""
    from mxmoe.models import configs, model
    from mxmoe.models.layers import MoEImpl
    from mxmoe.quant.quantizer import quantize_model_experts_mixed_gptq
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    INTERPRET = jax.default_backend() == "cpu"
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(51), dtype=jnp.float32)
    schemes = ["w4a4_g16_asym", "w8a8_g-1_sym"]
    qmodel = QModelConfig(layers={str(l): QLayerConfig(experts={
        str(i): QExpertConfig(*([parse_scheme(schemes[i % 2])] * 3))
        for i in range(5)}) for l in range(2)})
    toks = jax.random.randint(jax.random.PRNGKey(52), (2, 32), 0,
                              cfg.vocab_size)

    kw = dict(calib_tokens=toks, hadamard=True, act_order=True)
    qp8 = quantize_model_experts_mixed_gptq(params, cfg, qmodel, **kw)
    qpp = quantize_model_experts_mixed_gptq(params, cfg, qmodel,
                                            pack_w4=True, **kw)
    assert qp8["layers"]["expert_gate_up_sc"].shape[-2] == 64 // 16
    assert "expert_gate_up_zp" in qp8["layers"]
    assert "act_gsize_gateup" in qp8["layers"]

    impl = MoEImpl(kind="ragged", quant="mixed", interpret=INTERPRET)
    ref = model.forward_logits(qp8, toks, cfg, impl)
    got = model.forward_logits(qpp, toks, cfg, impl)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_gptq_non_dividing_k():
    """K not a multiple of the 128 blocksize (ds2's 10944-wide dense MLP)
    auto-shrinks the block; GPTQ must still beat RTN on correlated data."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mxmoe.quant.gptq import accumulate_hessian, gptq_quantize_kn
    from mxmoe.quant.rtn import fake_quant_weight
    from mxmoe.quant.schemes import parse_scheme

    k, n, m = 192, 64, 256       # 192 % 128 != 0 -> gcd block 64
    key = jax.random.PRNGKey(0)
    base = jax.random.normal(key, (m, k // 2), jnp.float32)
    x = jnp.concatenate([base, base * 0.5 +
                         0.1 * jax.random.normal(key, (m, k // 2))], -1)
    w = jax.random.normal(jax.random.PRNGKey(1), (1, k, n), jnp.float32)
    h = accumulate_hessian(x)[None]
    qc = parse_scheme("w4a16_g-1_sym")
    res = gptq_quantize_kn(w, h, qc)
    err_gptq = float(jnp.sum((x @ res.w_fq[0] - x @ w[0]) ** 2))
    err_rtn = float(jnp.sum((x @ fake_quant_weight(w, qc)[0] - x @ w[0]) ** 2))
    assert np.isfinite(err_gptq)
    assert err_gptq <= err_rtn * 1.05, (err_gptq, err_rtn)


def test_tri_inv_chunked_matches_full_solve():
    """Column-chunked identity solve == one-shot triangular inversion
    (the ds2 dense-layer OOM fix must not change the factor)."""
    from jax.scipy.linalg import solve_triangular

    from mxmoe.quant.gptq import _tri_inv_chunked

    rng = np.random.default_rng(0)
    e, k = 2, 96
    a = rng.standard_normal((e, k, k))
    h = a @ np.swapaxes(a, -1, -2) + k * np.eye(k)
    r_up = jnp.asarray(np.linalg.cholesky(h[..., ::-1, ::-1])[..., ::-1, ::-1])
    eye = jnp.broadcast_to(jnp.eye(k), (e, k, k))
    full = solve_triangular(r_up, eye, lower=False)
    # force chunking (3 chunks of 32 columns)
    chunked = _tri_inv_chunked(r_up, max_rhs_elems=e * k * 32)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(full),
                               rtol=1e-5, atol=1e-5)


def test_gptq_inverse_factor_matches_legacy_chain():
    """The reverse-order Cholesky identity (H = R Rᵀ, U = R⁻¹) produces
    the SAME upper factor as the old chol -> full-identity solve ->
    matmul -> second-chol chain (unique by positive diagonal) — the
    memory fix is a reformulation, not a numerics change."""
    rng = np.random.default_rng(1)
    e, k = 3, 48
    a = rng.standard_normal((e, k, k)).astype(np.float32)
    h = (a @ np.swapaxes(a, -1, -2) + k * np.eye(k, dtype=np.float32))

    # legacy chain (as shipped through round 4)
    chol = np.linalg.cholesky(h)
    inv_l = np.stack([np.linalg.solve(c, np.eye(k, dtype=np.float32))
                      for c in chol])
    hinv = np.swapaxes(inv_l, -1, -2) @ inv_l
    legacy = np.swapaxes(np.linalg.cholesky(hinv), -1, -2)

    rev = lambda x: x[..., ::-1, ::-1]
    r_up = rev(np.linalg.cholesky(rev(h)))
    new = np.stack([np.linalg.solve(r, np.eye(k, dtype=np.float32))
                    for r in r_up])
    np.testing.assert_allclose(new, legacy, rtol=2e-3, atol=2e-4)


def test_gptq_dense_wide_k_shape():
    """ds2-dense-style shape (K ≫ N, K not a multiple of the block size):
    the sweep runs, chunking engages, and fake-quant error stays below
    plain RTN's (GPTQ's defining property) — regression for the runbook
    OOM config (round-4 missing #2)."""
    from mxmoe.quant.gptq import accumulate_hessian, gptq_quantize_kn
    from mxmoe.quant.rtn import quantize as rtn_quantize
    from mxmoe.quant.schemes import parse_scheme

    rng = np.random.default_rng(2)
    k, n = 684, 64             # K ≫ N and 684 % 128 != 0 (gcd path)
    w = jnp.asarray(rng.standard_normal((1, k, n)), jnp.float32) * 0.02
    x = jnp.asarray(rng.standard_normal((256, k)), jnp.float32)
    h = accumulate_hessian(x)[None]
    qcfg = parse_scheme("w4a4_g-1_sym")
    res = gptq_quantize_kn(w, h, qcfg)
    assert bool(jnp.all(jnp.isfinite(res.w_fq)))
    err_gptq = float(jnp.linalg.norm(x @ (res.w_fq[0] - w[0])))
    q = rtn_quantize(jnp.swapaxes(w[0], 0, 1), 4, -1, True)
    w_rtn = jnp.swapaxes(q.codes * q.scale + q.zp, 0, 1)  # g=-1: scale [N, 1]
    err_rtn = float(jnp.linalg.norm(x @ (w_rtn - w[0])))
    assert err_gptq < err_rtn, (err_gptq, err_rtn)
