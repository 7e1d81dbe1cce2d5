"""Prefill attention backends: the library fused attention
(``jax.nn.dot_product_attention``; cuDNN on the GPU, its XLA form here)
against the einsum softmax reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mxmoe.models.layers import attention


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("n_h,n_kv,s", [(4, 4, 16), (8, 2, 33)],
                         ids=["mha", "gqa"])
def test_fused_attention_matches_einsum(n_h, n_kv, s, causal):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(s), 3)
    hd = 32
    q = jax.random.normal(k1, (2, s, n_h, hd), jnp.float32)
    k = jax.random.normal(k2, (2, s, n_kv, hd), jnp.float32)
    v = jax.random.normal(k3, (2, s, n_kv, hd), jnp.float32)
    ref = attention(q, k, v, causal=causal, backend="xla")
    got = attention(q, k, v, causal=causal, backend="fused")
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_fused_attention_forward_logits():
    """The whole forward with attn_backend='fused' matches the einsum one."""
    from mxmoe.models import configs, model
    from mxmoe.models.layers import MoEImpl

    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(2), (2, 12), 0,
                              cfg.vocab_size)
    ref = model.forward_logits(params, toks, cfg, MoEImpl())
    got = model.forward_logits(params, toks, cfg,
                               MoEImpl(attn_backend="fused"))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
