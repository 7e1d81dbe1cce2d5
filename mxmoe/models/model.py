"""Full causal-LM forward for the MoE decoder families.

Parameters live in a dict pytree with per-layer tensors **stacked along a
leading L axis** so the layer loop is a ``jax.lax.scan`` — one compiled
layer body regardless of depth (compile-time win over unrolled loops).

Layout (see ``init_params``):
  embed        [V, H]
  layers/...   each [L, ...]  (attention, norms, router, experts, shared)
  final_norm   [H]
  lm_head      [H, V]
"""

from __future__ import annotations


import functools

import jax
import jax.numpy as jnp

from .configs import MoEConfig
from .layers import MoEImpl, decoder_layer, rms_norm, rope_frequencies


def _attn_shapes(cfg: MoEConfig) -> dict[str, tuple]:
    h = cfg.hidden_size
    if cfg.attention_type == "mla":
        return {
            "wq": (h, cfg.num_heads * cfg.qk_head_dim),
            "kv_a": (h, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            "kv_a_norm": (cfg.kv_lora_rank,),
            "kv_b": (cfg.kv_lora_rank,
                     cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            "wo": (cfg.num_heads * cfg.v_head_dim, h),
        }
    shapes = {
        "wq": (h, cfg.q_dim),
        "wk": (h, cfg.kv_dim),
        "wv": (h, cfg.kv_dim),
        "wo": (cfg.q_dim, h),
    }
    if cfg.attention_bias:
        shapes.update({"bq": (cfg.q_dim,), "bk": (cfg.kv_dim,), "bv": (cfg.kv_dim,)})
    return shapes


def layer_param_shapes(cfg: MoEConfig) -> dict[str, tuple]:
    h = cfg.hidden_size
    n = cfg.moe_intermediate_size
    ns = cfg.shared_expert_intermediate_size
    shapes = {
        **_attn_shapes(cfg),
        "input_norm": (h,),
        "post_attn_norm": (h,),
        "router": (h, cfg.num_experts),
        "expert_gate_up": (cfg.num_experts, h, 2 * n),
        "expert_down": (cfg.num_experts, n, h),
    }
    if ns > 0:
        shapes.update({
            "shared_gate_up": (h, 2 * ns),
            "shared_down": (ns, h),
        })
        if cfg.has_shared_expert_gate:
            shapes["shared_gate"] = (h, 1)
    return shapes


def dense_layer_param_shapes(cfg: MoEConfig) -> dict[str, tuple]:
    """First-k dense layers (ds2 layer 0: plain SwiGLU MLP)."""
    h = cfg.hidden_size
    i = cfg.dense_intermediate_size
    return {
        **_attn_shapes(cfg),
        "input_norm": (h,),
        "post_attn_norm": (h,),
        "mlp_gate_up": (h, 2 * i),
        "mlp_down": (i, h),
    }


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _normal(key, shape, std, dtype):
    """N(0, std²) in ``dtype``; one fused kernel, so no f32 copy of a
    full-width expert stack is ever materialized."""
    return (jax.random.normal(key, shape, jnp.float32) * std).astype(dtype)


def _init_stack(shapes: dict, num: int, key: jax.Array, dtype) -> dict:
    out = {}
    lkeys = jax.random.split(key, len(shapes))
    for i, (name, shape) in enumerate(shapes.items()):
        full_shape = (num, *shape)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        if len(shape) == 1:
            val = jnp.ones(full_shape, dtype) if "norm" in name else jnp.zeros(full_shape, dtype)
        else:
            val = _normal(lkeys[i], full_shape, 0.4 / fan_in**0.5, dtype)
        out[name] = val
    return out


def init_params(cfg: MoEConfig, key: jax.Array, dtype=jnp.float32) -> dict:
    """Random-init parameter pytree (for tests; real weights via hf_loader)."""
    keys = jax.random.split(key, 4)

    params = {
        "embed": _normal(keys[1], (cfg.vocab_size, cfg.hidden_size), 0.02, dtype),
        "layers": _init_stack(layer_param_shapes(cfg), cfg.num_moe_layers, keys[0], dtype),
        "final_norm": jnp.ones((cfg.hidden_size,), dtype),
        "lm_head": _normal(keys[2], (cfg.hidden_size, cfg.vocab_size), 0.02, dtype),
    }
    if cfg.first_dense_layers > 0:
        params["dense_layers"] = _init_stack(
            dense_layer_param_shapes(cfg), cfg.first_dense_layers, keys[3], dtype
        )
    return params


def forward_hidden(
    params: dict,
    tokens: jax.Array,           # [B, S] int32
    cfg: MoEConfig,
    impl: MoEImpl = MoEImpl(),
    positions: jax.Array | None = None,
) -> jax.Array:
    """Token ids -> final hidden states [B, S, H] (pre-norm applied)."""
    # OOB ids would gather NaN fill values and silently poison routing
    x = jnp.take(params["embed"], tokens, axis=0, mode="clip")
    s = tokens.shape[1]
    if positions is None:
        positions = jnp.arange(s)
    if cfg.attention_type == "mla":
        from .layers import rope_frequencies_interleaved

        cos, sin = rope_frequencies_interleaved(
            cfg.qk_rope_head_dim, cfg.rope_theta, positions
        )
    else:
        cos, sin = rope_frequencies(cfg.head_dim, cfg.rope_theta, positions)

    if "dense_layers" in params:
        def dense_body(carry, layer_params):
            return decoder_layer(
                carry, layer_params, cfg, cos, sin, impl, dense_mlp=True
            ), None

        x, _ = jax.lax.scan(dense_body, x, params["dense_layers"])

    # quantized expert weights ride as a scan CONSTANT stack, not scan-xs:
    # XLA cannot fuse the per-iteration slice into a Pallas custom-call
    # operand and would copy every layer's weights each chunk
    # (layers.split_expert_stack)
    from .layers import split_expert_stack

    xs_layers, estack = ((params["layers"], {}) if impl.quant is None
                         else split_expert_stack(params["layers"]))

    def body(carry, layer_params):
        h, l = carry
        if estack:
            layer_params = dict(layer_params, _expert_stack=estack,
                                _layer_index=l)
        out = decoder_layer(h, layer_params, cfg, cos, sin, impl)
        return (out, l + 1), None

    (x, _), _ = jax.lax.scan(body, (x, jnp.int32(0)), xs_layers)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def head_logits(params: dict, h: jax.Array, cfg: MoEConfig) -> jax.Array:
    """Final projection; supports the int8-quantized lm_head
    (quant.qparams.quantize_lm_head) via a per-token int8 dot."""
    if "lm_head_q" in params:
        from ..quant.qparams import quantize_act_per_token

        shape = h.shape[:-1]
        h2 = h.reshape(-1, h.shape[-1])
        hq, hsc = quantize_act_per_token(h2, 8)
        acc = jnp.dot(hq, params["lm_head_q"], preferred_element_type=jnp.int32)
        out = acc.astype(jnp.float32) * hsc * params["lm_head_sc"]
        return out.reshape(*shape, -1).astype(h.dtype)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return h @ head


def forward_logits(
    params: dict,
    tokens: jax.Array,
    cfg: MoEConfig,
    impl: MoEImpl = MoEImpl(),
) -> jax.Array:
    h = forward_hidden(params, tokens, cfg, impl)
    return head_logits(params, h, cfg)


def make_forward_fn(cfg: MoEConfig, impl: MoEImpl = MoEImpl()):
    """jit-ready closure over the static config."""

    @jax.jit
    def fn(params, tokens):
        return forward_logits(params, tokens, cfg, impl)

    return fn
