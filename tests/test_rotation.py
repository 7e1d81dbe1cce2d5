"""Rotation invariance: norm-fusion and Hadamard rotation must preserve
the model function exactly (up to float tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np

from mxmoe.models import configs, model
from mxmoe.models.layers import MoEImpl
from mxmoe.quant.rotation import (
    fuse_layer_norms, rotate_model, rotate_model_hadamard,
    online_hadamard_down, rotate_down_weights,
)
from mxmoe.quant.hadamard import random_hadamard_matrix


def _setup(seed=0):
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    # non-trivial norm weights so fusion is actually exercised
    layers = dict(params["layers"])
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed + 1), 3)
    layers["input_norm"] = 1.0 + 0.3 * jax.random.normal(k1, layers["input_norm"].shape)
    layers["post_attn_norm"] = 1.0 + 0.3 * jax.random.normal(k2, layers["post_attn_norm"].shape)
    params["layers"] = layers
    params["final_norm"] = 1.0 + 0.3 * jax.random.normal(k3, params["final_norm"].shape)
    toks = jax.random.randint(jax.random.PRNGKey(9), (2, 16), 0, cfg.vocab_size)
    return cfg, params, toks


def test_fuse_layer_norms_preserves_function():
    cfg, params, toks = _setup()
    impl = MoEImpl(kind="dense")
    ref = model.forward_logits(params, toks, cfg, impl)
    fused = fuse_layer_norms(params)
    got = model.forward_logits(fused, toks, cfg, impl)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-4, atol=2e-4)
    assert np.allclose(np.asarray(fused["layers"]["input_norm"]), 1.0)


def test_rotation_preserves_function():
    cfg, params, toks = _setup(seed=2)
    impl = MoEImpl(kind="dense")
    ref = model.forward_logits(params, toks, cfg, impl)
    rotated = rotate_model_hadamard(params, cfg, jax.random.PRNGKey(7))
    got = model.forward_logits(rotated, toks, cfg, impl)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-3, atol=2e-3)
    # weights must actually change
    d = np.abs(np.asarray(rotated["layers"]["wq"] - params["layers"]["wq"])).max()
    assert d > 1e-3


def test_rotation_matrix_orthogonal():
    for n in (64, 1408, 2048):
        q = random_hadamard_matrix(n, jax.random.PRNGKey(0))
        eye = np.asarray(q @ q.T)
        np.testing.assert_allclose(eye, np.eye(n), atol=1e-3)


def test_online_hadamard_down_equivalence():
    # (h @ H) @ (Hᵀ W) == h @ W
    key = jax.random.PRNGKey(3)
    n, h_dim = 48, 32
    h_act = jax.random.normal(key, (10, n))
    w = jax.random.normal(key, (1, n, h_dim))  # [L, N, H]
    ref = h_act @ w[0]
    got = online_hadamard_down(h_act) @ rotate_down_weights(w)[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_online_had_model_forward_invariance():
    """Pre-rotated down weights + online Hadamard in the ragged path must
    preserve the model function (QuaRot R4 wiring)."""
    from mxmoe.quant.rotation import rotate_down_weights

    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(21), dtype=jnp.float32)
    ref = model.forward_logits(params, jnp.arange(24).reshape(1, 24) % cfg.vocab_size,
                               cfg, MoEImpl(kind="ragged"))

    rot = dict(params)
    rot["layers"] = dict(params["layers"])
    rot["layers"]["expert_down"] = rotate_down_weights(params["layers"]["expert_down"])
    got = model.forward_logits(rot, jnp.arange(24).reshape(1, 24) % cfg.vocab_size,
                               cfg, MoEImpl(kind="ragged", online_had=True))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-3, atol=2e-3)


def test_online_had_with_real_quant_path():
    """R4 online Hadamard composes with real-quantized execution: rotated
    down weights + online transform keep logits close to the plain
    quantized model (the rotation is function-preserving pre-quantization)."""
    from mxmoe.quant.qparams import quantize_model_experts_uniform
    from mxmoe.quant.rotation import rotate_down_weights
    from mxmoe.quant.schemes import parse_scheme

    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(23), dtype=jnp.float32)
    qc = parse_scheme("w8a8_g-1_sym")

    rot = dict(params)
    rot["layers"] = dict(params["layers"])
    rot["layers"]["expert_down"] = rotate_down_weights(params["layers"]["expert_down"])
    qp_rot = quantize_model_experts_uniform(rot, qc)
    qp = quantize_model_experts_uniform(params, qc)

    impl_r = MoEImpl(kind="ragged", quant=qc, online_had=True,
                     interpret=jax.default_backend() == "cpu")
    impl_p = MoEImpl(kind="ragged", quant=qc,
                     interpret=jax.default_backend() == "cpu")
    toks = jax.random.randint(jax.random.PRNGKey(24), (1, 16), 0, cfg.vocab_size)
    got = model.forward_logits(qp_rot, toks, cfg, impl_r)
    ref = model.forward_logits(qp, toks, cfg, impl_p)
    corr = np.corrcoef(np.asarray(got).ravel(), np.asarray(ref).ravel())[0, 1]
    assert corr > 0.99, corr


def test_rotation_preserves_function_ds2_mla_dense():
    """MLA (wq/kv_a) + dense-first-layer models rotate correctly too
    (round-1 advisor finding: fuse_layer_norms crashed on ds2)."""
    cfg = configs.tiny_ds2(num_experts=4, num_layers=3)
    params = model.init_params(cfg, jax.random.PRNGKey(11), dtype=jnp.float32)
    for tree in ("layers", "dense_layers"):
        if tree not in params:
            continue
        sub = dict(params[tree])
        k1, k2 = jax.random.split(jax.random.PRNGKey(12), 2)
        sub["input_norm"] = 1.0 + 0.3 * jax.random.normal(k1, sub["input_norm"].shape)
        sub["post_attn_norm"] = 1.0 + 0.3 * jax.random.normal(k2, sub["post_attn_norm"].shape)
        params[tree] = sub
    toks = jax.random.randint(jax.random.PRNGKey(13), (2, 12), 0, cfg.vocab_size)
    impl = MoEImpl(kind="dense")
    ref = model.forward_logits(params, toks, cfg, impl)

    fused = fuse_layer_norms(params)
    got_f = model.forward_logits(fused, toks, cfg, impl)
    np.testing.assert_allclose(np.asarray(got_f), np.asarray(ref), rtol=2e-4, atol=2e-4)

    rotated = rotate_model_hadamard(params, cfg, jax.random.PRNGKey(14))
    got = model.forward_logits(rotated, toks, cfg, impl)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-3, atol=2e-3)
    d = np.abs(np.asarray(rotated["layers"]["kv_a"] - params["layers"]["kv_a"])).max()
    assert d > 1e-3


def test_host_streamed_rotation_matches_full():
    """rotate_model_hadamard_host (numpy, in-place, layer-streamed) must
    equal rotate_model_hadamard on f32 leaves, for GQA and MLA+dense."""
    from mxmoe.quant.rotation import rotate_model_hadamard_host

    for mk, seed in ((configs.tiny_qwen2_moe, 3), (configs.tiny_ds2, 4)):
        cfg = mk(num_experts=4, num_layers=3)
        params = model.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
        ref = rotate_model_hadamard(params, cfg, jax.random.PRNGKey(7))
        host = jax.tree_util.tree_map(lambda a: np.array(a), params)
        got = rotate_model_hadamard_host(host, cfg, jax.random.PRNGKey(7))
        flat_ref = jax.tree_util.tree_leaves_with_path(ref)
        flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
        for path, leaf in flat_ref:
            np.testing.assert_allclose(
                np.asarray(flat_got[path], np.float32),
                np.asarray(leaf, np.float32),
                rtol=2e-5, atol=2e-5, err_msg=str(path))


def test_host_streamed_rotation_keeps_storage_dtype():
    from mxmoe.quant.rotation import rotate_model_hadamard_host
    import ml_dtypes

    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    host = jax.tree_util.tree_map(
        lambda a: np.array(a).astype(ml_dtypes.bfloat16), params)
    got = rotate_model_hadamard_host(host, cfg)
    for leaf in jax.tree_util.tree_leaves(got):
        assert leaf.dtype == ml_dtypes.bfloat16, leaf.dtype
