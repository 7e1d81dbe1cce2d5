"""Sequence-parallel ring attention vs single-device causal attention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from mxmoe.models.layers import attention
from mxmoe.parallel.ring_attention import make_ring_attention_fn

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs multi-device mesh"
)


@pytest.mark.parametrize("p,n_h,n_kv", [(4, 4, 4), (8, 8, 2)])
def test_ring_attention_matches_causal(p, n_h, n_kv):
    if len(jax.devices()) < p:
        pytest.skip(f"needs {p} devices")
    b, s, hd = 2, 16 * p, 16
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    q = jax.random.normal(k1, (b, s, n_h, hd), jnp.float32)
    k = jax.random.normal(k2, (b, s, n_kv, hd), jnp.float32)
    v = jax.random.normal(k3, (b, s, n_kv, hd), jnp.float32)

    ref = attention(q, k, v, causal=True)

    mesh = Mesh(np.array(jax.devices()[:p]), axis_names=("seq",))
    fn = make_ring_attention_fn(mesh, "seq")
    with mesh:
        got = jax.jit(fn)(q, k, v)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_ring_attention_first_token_finite():
    """Shard 0's first query attends only position 0 — no NaN from the
    fully-masked future blocks."""
    p = 4
    if len(jax.devices()) < p:
        pytest.skip("needs 4 devices")
    b, s, n, hd = 1, 4 * p, 2, 8
    q = k = v = jnp.ones((b, s, n, hd), jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:p]), axis_names=("seq",))
    fn = make_ring_attention_fn(mesh, "seq")
    with mesh:
        out = jax.jit(fn)(q, k, v)
    assert bool(jnp.all(jnp.isfinite(out)))
    np.testing.assert_allclose(np.asarray(out), np.ones_like(out), rtol=1e-5)


def test_sp_prefill_forward_matches_single_device():
    """Ring attention REACHABLE from the model (round-3 weak #4): the
    sequence-parallel prefill forward (MoEImpl(attn_backend='ring') via
    make_sp_prefill_forward) produces the same logits as the single-device
    XLA-attention forward at S spanning 4 shards."""
    from mxmoe.models import configs, model
    from mxmoe.parallel.sharded import make_sp_prefill_forward

    p = 4
    if len(jax.devices()) < p:
        pytest.skip("needs 4 devices")
    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 8 * p), 0,
                              cfg.vocab_size)

    ref = model.forward_logits(params, toks, cfg)
    fwd = make_sp_prefill_forward(cfg, Mesh(np.array(jax.devices()[:p]),
                                            axis_names=("seq",)))
    got = fwd(params, toks)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=5e-4, atol=5e-4)
