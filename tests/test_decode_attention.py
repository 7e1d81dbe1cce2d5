"""Cached decode attention (the XLA path over serving/kv_cache.py) vs an
independent numpy oracle, and the stacked-cache write protocol."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mxmoe.serving.kv_cache import (
    _quant_vec, attention_with_cache, attention_with_quant_cache,
    scatter_layer_cache, scatter_layer_cache_quant,
)


def _np_decode_attention(q, ck, cv, lengths, scale=None):
    """q [B, n_h, dk]; ck [B, n_kv, S, dk]; cv [B, n_kv, S, dv]: query at
    position ``lengths[b]`` attends cache slots 0..lengths[b]."""
    q, ck, cv = (np.asarray(a, np.float64) for a in (q, ck, cv))
    b, n_h, dk = q.shape
    n_kv = ck.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(dk)
    out = np.zeros((b, n_h, cv.shape[-1]))
    for bi in range(b):
        t = int(lengths[bi]) + 1
        for h in range(n_h):
            kv = h // (n_h // n_kv)
            s = ck[bi, kv, :t] @ q[bi, h] * scale
            p = np.exp(s - s.max())
            out[bi, h] = (p / p.sum()) @ cv[bi, kv, :t]
    return out


@pytest.mark.parametrize("n_h,n_kv,dk,dv,s_max", [
    (8, 2, 32, 32, 128),      # GQA
    (4, 4, 40, 24, 96),       # MLA-style: dk != dv, no grouping
    (8, 8, 32, 32, 200),      # s_max not a power of two
])
def test_decode_attention_matches_oracle(n_h, n_kv, dk, dv, s_max):
    b = 4
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    q = jax.random.normal(k1, (b, 1, n_h, dk), jnp.float32)
    ck = jax.random.normal(k2, (b, n_kv, s_max, dk), jnp.float32)
    cv = jax.random.normal(k3, (b, n_kv, s_max, dv), jnp.float32)
    lengths = jax.random.randint(k4, (b,), 0, s_max - 1)
    got = attention_with_cache(q, ck, cv, lengths, 1)           # [B,1,n_h,dv]
    ref = _np_decode_attention(q[:, 0], ck, cv, np.asarray(lengths))
    np.testing.assert_allclose(np.asarray(got[:, 0]), ref, rtol=2e-5,
                               atol=2e-5)


def test_decode_attention_q8_matches_oracle():
    """The int8 cache folds its per-vector scales into scores and probs:
    equal to attention over the dequantized cache."""
    b, n_h, n_kv, hd, s_max = 4, 8, 2, 32, 160
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(1), 4)
    q = jax.random.normal(k1, (b, 1, n_h, hd), jnp.float32)
    ck = jax.random.normal(k2, (b, n_kv, s_max, hd), jnp.float32)
    cv = jax.random.normal(k3, (b, n_kv, s_max, hd), jnp.float32)
    lengths = jax.random.randint(k4, (b,), 1, s_max - 1)
    ckq, cks = _quant_vec(ck)
    cvq, cvs = _quant_vec(cv)
    got = attention_with_quant_cache(q, ckq, cks, cvq, cvs, lengths, 1)
    ref = _np_decode_attention(
        q[:, 0], np.asarray(ckq, np.float64) * np.asarray(cks)[..., None],
        np.asarray(cvq, np.float64) * np.asarray(cvs)[..., None],
        np.asarray(lengths))
    np.testing.assert_allclose(np.asarray(got[:, 0]), ref, rtol=2e-4,
                               atol=2e-4)


def test_decode_attention_zero_length():
    """A fresh slot (length 0) attends only the just-written position."""
    b, n_h, n_kv, hd, s_max = 2, 4, 2, 32, 64
    key = jax.random.PRNGKey(2)
    q = jax.random.normal(key, (b, 1, n_h, hd), jnp.float32)
    ck = jax.random.normal(key, (b, n_kv, s_max, hd), jnp.float32)
    cv = jax.random.normal(jax.random.PRNGKey(3), (b, n_kv, s_max, hd))
    got = attention_with_cache(q, ck, cv, jnp.zeros((b,), jnp.int32), 1)
    want = jnp.repeat(cv[:, :, 0], n_h // n_kv, axis=1)          # [B,n_h,hd]
    np.testing.assert_allclose(np.asarray(got[:, 0]), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("family", ["qwen2_moe", "ds2"])
def test_forward_cached_fused_decode_matches_xla(family):
    """One cached decode step after a cached prefill equals the last
    position of the uncached forward over the whole sequence (bf16 cache
    and int8 cache, GQA and MLA)."""
    from mxmoe.models import configs, model
    from mxmoe.models.layers import MoEImpl
    from mxmoe.serving.decode import forward_cached
    from mxmoe.serving.kv_cache import init_kv_cache, init_quant_kv_cache

    cfg = (configs.tiny_qwen2_moe(num_experts=4, num_layers=2) if
           family == "qwen2_moe" else configs.tiny_ds2(num_experts=4,
                                                       num_layers=3))
    params = model.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(4), (2, 6), 0, cfg.vocab_size)
    step_tok = jax.random.randint(jax.random.PRNGKey(5), (2, 1), 0,
                                  cfg.vocab_size)
    full = model.forward_logits(params, jnp.concatenate([toks, step_tok], 1),
                                cfg, MoEImpl())[:, -1]
    for make_cache, tol in ((init_kv_cache, 2e-4),
                            (init_quant_kv_cache, 5e-2)):
        kwargs = {} if make_cache is init_quant_kv_cache else \
            {"dtype": jnp.float32}
        cache = make_cache(cfg, 2, 32, **kwargs)
        _, cache = forward_cached(params, toks, cache, cfg, impl=MoEImpl())
        got, _ = forward_cached(params, step_tok, cache, cfg, impl=MoEImpl())
        np.testing.assert_allclose(np.asarray(got[:, 0]), np.asarray(full),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_stacked_matches_oracle(quant):
    """Attention over one layer of the STACKED [L, ...] cache equals the
    oracle on that layer's slice, bf16 and int8-quant layouts."""
    nl, b, n_h, n_kv, hd, s_max = 3, 4, 8, 2, 32, 192
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(3), 4)
    q = jax.random.normal(k1, (b, 1, n_h, hd), jnp.float32)
    ck = jax.random.normal(k2, (nl, b, n_kv, s_max, hd), jnp.float32)
    cv = jax.random.normal(k3, (nl, b, n_kv, s_max, hd), jnp.float32)
    lengths = np.asarray(jax.random.randint(k4, (b,), 0, s_max - 1))
    for layer in (0, 2):
        if quant:
            ckq, cks = _quant_vec(ck)
            cvq, cvs = _quant_vec(cv)
            got = attention_with_quant_cache(q, ckq[layer], cks[layer],
                                             cvq[layer], cvs[layer],
                                             jnp.asarray(lengths), 1)
            ref = _np_decode_attention(
                q[:, 0],
                np.asarray(ckq[layer], np.float64) * np.asarray(cks[layer])[..., None],
                np.asarray(cvq[layer], np.float64) * np.asarray(cvs[layer])[..., None],
                lengths)
            tol = 2e-4
        else:
            got = attention_with_cache(q, ck[layer], cv[layer],
                                       jnp.asarray(lengths), 1)
            ref = _np_decode_attention(q[:, 0], ck[layer], cv[layer], lengths)
            tol = 2e-5
        np.testing.assert_allclose(np.asarray(got[:, 0]), ref, rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("quant", [False, True])
def test_update_stacked_multihead_block_matches_oracle(quant):
    """The in-place stacked-cache write puts each slot's new K/V at its own
    position of the chosen layer only (one layer of several, slots at
    length 0, mid and end), and attention then sees it."""
    nl, b, n_h, n_kv, hd, s_max = 2, 3, 8, 8, 64, 96
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(9), 5)
    q = jax.random.normal(k1, (b, 1, n_h, hd), jnp.float32)
    ck = jax.random.normal(k2, (nl, b, n_kv, s_max, hd), jnp.float32)
    cv = jax.random.normal(k3, (nl, b, n_kv, s_max, hd), jnp.float32)
    k_new = jax.random.normal(k4, (b, 1, n_kv, hd), jnp.float32)
    v_new = jax.random.normal(k5, (b, 1, n_kv, hd), jnp.float32)
    lengths = np.asarray([0, 5, s_max - 2], np.int32)
    layer = jnp.int32(1)

    want_k, want_v = np.array(ck), np.array(cv)
    for bi, pos in enumerate(lengths):
        want_k[1, bi, :, pos] = np.asarray(k_new[bi, 0])
        want_v[1, bi, :, pos] = np.asarray(v_new[bi, 0])
    if quant:
        ckq, cks = _quant_vec(ck)
        cvq, cvs = _quant_vec(cv)
        gkq, gks, gvq, gvs = scatter_layer_cache_quant(
            ckq, cks, cvq, cvs, layer, k_new, v_new, jnp.asarray(lengths))
        np.testing.assert_array_equal(np.asarray(gkq[0]), np.asarray(ckq[0]))
        kq_new, ks_new = _quant_vec(k_new)
        for bi, pos in enumerate(lengths):
            np.testing.assert_array_equal(np.asarray(gkq[1, bi, :, pos]),
                                          np.asarray(kq_new[bi, 0]))
            np.testing.assert_allclose(np.asarray(gks[1, bi, :, pos]),
                                       np.asarray(ks_new[bi, 0]), rtol=1e-6)
        got = attention_with_quant_cache(q, gkq[1], gks[1], gvq[1], gvs[1],
                                         jnp.asarray(lengths), 1)
        tol = 5e-2
    else:
        gck, gcv = scatter_layer_cache(ck, cv, layer, k_new, v_new,
                                       jnp.asarray(lengths))
        np.testing.assert_array_equal(np.asarray(gck), want_k)
        np.testing.assert_array_equal(np.asarray(gcv), want_v)
        got = attention_with_cache(q, gck[1], gcv[1], jnp.asarray(lengths), 1)
        tol = 2e-5
    ref = _np_decode_attention(q[:, 0], want_k[1], want_v[1], lengths)
    np.testing.assert_allclose(np.asarray(got[:, 0]), ref, rtol=tol, atol=tol)
