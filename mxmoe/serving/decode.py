"""Cache-aware decoder forward: prefill and decode share one code path.

Both are [B, S_new] chunks against a KVCache; prefill uses S_new = chunk
size with per-slot valid lengths, decode uses S_new = 1. The layer loop is
a lax.scan that carries the cache slices alongside the stacked layer
params, so prefill/decode each compile exactly once per shape.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from functools import partial

from ..models.configs import MoEConfig
from ..models.layers import (MoEImpl, moe_block, rms_norm,
                             split_expert_stack)
from .kv_cache import (KVCache, QuantKVCache, attention_with_cache,
                       attention_with_quant_cache, scatter_layer_cache,
                       scatter_layer_cache_quant)


def _rope_tables(cfg: MoEConfig, positions: jax.Array) -> tuple[jax.Array, jax.Array]:
    """cos/sin [B, S, hd] for per-slot positions [B, S]."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (jnp.arange(0, hd, 2, dtype=jnp.float32) / hd))
    ang = positions.astype(jnp.float32)[..., None] * inv_freq  # [B, S, hd/2]
    emb = jnp.concatenate([ang, ang], axis=-1)
    return jnp.cos(emb), jnp.sin(emb)


def _apply_rope_bs(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """x [B, S, nH, hd], cos/sin [B, S, hd]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = jnp.concatenate([-x2, x1], axis=-1)
    c = cos[:, :, None, :].astype(x.dtype)
    s = sin[:, :, None, :].astype(x.dtype)
    return x * c + rotated * s


def _attention_block_cached(x, lp, cfg, cos, sin, ck, cv, layer, lengths,
                            valid=None):
    """``ck``/``cv`` are the STACKED [L, B, n_kv, S, hd] caches; the write
    is an in-place scatter into layer ``layer`` (a per-layer scan-xs/ys
    cache protocol would re-materialize every padded layer slice per
    step)."""
    b, s, _ = x.shape
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = _apply_rope_bs(q, cos, sin)
    k = _apply_rope_bs(k, cos, sin)
    ck, cv = scatter_layer_cache(ck, cv, layer, k, v, lengths,
                                 valid=valid)
    out = attention_with_cache(q, ck[layer], cv[layer], lengths, s)
    return out.reshape(b, s, -1) @ lp["wo"], ck, cv


def _rope_tables_mla(cfg: MoEConfig, positions: jax.Array):
    """Interleaved-convention tables [B, S, rope_dim/2] (DeepSeek MLA)."""
    d = cfg.qk_rope_head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (jnp.arange(0, d, 2, dtype=jnp.float32) / d))
    ang = positions.astype(jnp.float32)[..., None] * inv_freq
    return jnp.cos(ang), jnp.sin(ang)


def _apply_rope_interleaved_bs(x, cos, sin):
    """x [B, S, nH, d]; cos/sin [B, S, d/2]; pairwise complex rotation."""
    x1 = x[..., 0::2].astype(jnp.float32)
    x2 = x[..., 1::2].astype(jnp.float32)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = jnp.stack([x1 * c - x2 * s, x1 * s + x2 * c], axis=-1)
    return out.reshape(x.shape).astype(x.dtype)


def _attention_block_cached_mla(x, lp, cfg, cos, sin, ck, cv, layer, lengths,
                                valid=None):
    b, s, _ = x.shape
    n_h = cfg.num_heads
    d_nope, d_rope, d_v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    d_qk = d_nope + d_rope

    q = (x @ lp["wq"]).reshape(b, s, n_h, d_qk)
    q_nope, q_pe = q[..., :d_nope], q[..., d_nope:]
    ckv = x @ lp["kv_a"]
    c_kv, k_pe = ckv[..., : cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    c_kv = rms_norm(c_kv, lp["kv_a_norm"], cfg.rms_norm_eps)
    kv = (c_kv @ lp["kv_b"]).reshape(b, s, n_h, d_nope + d_v)
    k_nope, v = kv[..., :d_nope], kv[..., d_nope:]

    q_pe = _apply_rope_interleaved_bs(q_pe, cos, sin)
    k_pe = _apply_rope_interleaved_bs(k_pe[:, :, None, :], cos, sin)
    k_pe = jnp.broadcast_to(k_pe, (b, s, n_h, d_rope))
    q_full = jnp.concatenate([q_nope, q_pe], axis=-1)
    k_full = jnp.concatenate([k_nope, k_pe], axis=-1)
    # MLA cache lanes are padded to a 128 multiple (kv_cache.mla_cache_k_dim);
    # the zero tail adds nothing to q.k. Scale stays 1/sqrt(qk_head_dim),
    # NOT the padded dim.
    dk_c = ck.shape[-1]
    if dk_c > d_qk:
        padw = ((0, 0), (0, 0), (0, 0), (0, dk_c - d_qk))
        q_full = jnp.pad(q_full, padw)
        k_full = jnp.pad(k_full, padw)
    mla_scale = 1.0 / float(d_qk) ** 0.5

    ck, cv = scatter_layer_cache(ck, cv, layer, k_full, v, lengths,
                                 valid=valid)
    out = attention_with_cache(q_full, ck[layer], cv[layer], lengths, s,
                               scale=mla_scale)
    return out.reshape(b, s, n_h * d_v) @ lp["wo"], ck, cv


def _attention_block_cached_quant(x, lp, cfg, cos, sin, caches, layer,
                                  lengths, valid=None):
    """GQA attention over the STACKED int8 KV cache (QuantKVCache path)."""
    ckq, cks, cvq, cvs = caches
    b, s, _ = x.shape
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = _apply_rope_bs(q, cos, sin)
    k = _apply_rope_bs(k, cos, sin)
    ckq, cks, cvq, cvs = scatter_layer_cache_quant(
        ckq, cks, cvq, cvs, layer, k, v, lengths, valid=valid)
    out = attention_with_quant_cache(q, ckq[layer], cks[layer],
                                     cvq[layer], cvs[layer], lengths, s)
    return out.reshape(b, s, -1) @ lp["wo"], (ckq, cks, cvq, cvs)


def _attention_block_cached_quant_mla(x, lp, cfg, cos, sin, caches, layer,
                                      lengths, valid=None):
    """MLA attention over the STACKED int8 KV cache."""
    ckq, cks, cvq, cvs = caches
    b, s, _ = x.shape
    n_h = cfg.num_heads
    d_nope, d_rope, d_v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    d_qk = d_nope + d_rope

    q = (x @ lp["wq"]).reshape(b, s, n_h, d_qk)
    q_nope, q_pe = q[..., :d_nope], q[..., d_nope:]
    ckv = x @ lp["kv_a"]
    c_kv, k_pe = ckv[..., : cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    c_kv = rms_norm(c_kv, lp["kv_a_norm"], cfg.rms_norm_eps)
    kv = (c_kv @ lp["kv_b"]).reshape(b, s, n_h, d_nope + d_v)
    k_nope, v = kv[..., :d_nope], kv[..., d_nope:]
    q_pe = _apply_rope_interleaved_bs(q_pe, cos, sin)
    k_pe = _apply_rope_interleaved_bs(k_pe[:, :, None, :], cos, sin)
    k_pe = jnp.broadcast_to(k_pe, (b, s, n_h, d_rope))
    q_full = jnp.concatenate([q_nope, q_pe], axis=-1)
    k_full = jnp.concatenate([k_nope, k_pe], axis=-1)
    # MLA cache lanes are padded to a 128 multiple (kv_cache.mla_cache_k_dim);
    # the zero tail adds nothing to q.k. Scale stays 1/sqrt(qk_head_dim),
    # NOT the padded dim.
    dk_c = ckq.shape[-1]
    if dk_c > d_qk:
        padw = ((0, 0), (0, 0), (0, 0), (0, dk_c - d_qk))
        q_full = jnp.pad(q_full, padw)
        k_full = jnp.pad(k_full, padw)
    mla_scale = 1.0 / float(d_qk) ** 0.5

    ckq, cks, cvq, cvs = scatter_layer_cache_quant(
        ckq, cks, cvq, cvs, layer, k_full, v, lengths, valid=valid)
    out = attention_with_quant_cache(q_full, ckq[layer], cks[layer],
                                     cvq[layer], cvs[layer], lengths, s,
                                     scale=mla_scale)
    return out.reshape(b, s, n_h * d_v) @ lp["wo"], (ckq, cks, cvq, cvs)



def _layer_xs_and_stack(params: dict, impl: MoEImpl):
    """Scan-xs layer params + the expert-weight stack (see
    models.layers.split_expert_stack: scan-slicing quantized expert
    weights copies them every step; the stack rides as a loop constant
    with globalized kernel metadata). EP mixed serving stacks UNFLATTENED
    ([L, E, ...]: the expert dim stays a shardable mesh axis; shards
    flatten locally inside the shard_map — round-4 verdict weak #5: the
    EP wrapper used to slice per-layer expert shards inside the scan,
    re-materializing every layer's weights each step). The uniform-quant
    and bf16 EP blocks take fixed positional operands and keep the old
    per-layer layout."""
    if impl.quant is None:
        return params["layers"], {}
    use_stack = (impl.stack_weights if impl.stack_weights is not None
                 else not impl.use_interpret)
    if impl.ep_moe is not None:
        if (impl.quant == "mixed" and not impl.mixed_weight_only
                and use_stack):
            return split_expert_stack(params["layers"], flatten=False)
        return params["layers"], {}
    if not use_stack:
        return params["layers"], {}
    return split_expert_stack(params["layers"])


def _forward_cached_quant(params, tokens, cache, cfg, impl, valid_lengths):
    """forward_cached over a QuantKVCache (GQA and MLA)."""
    b, s_new = tokens.shape
    x = jnp.take(params["embed"], tokens, axis=0, mode="clip")
    positions = cache.lengths[:, None] + jnp.arange(s_new)[None]
    write_ok = valid_lengths > 0    # [B]; scalar per slot under vmap
    if cfg.attention_type == "mla":
        cos, sin = _rope_tables_mla(cfg, positions)
        attn_q = partial(_attention_block_cached_quant_mla, valid=write_ok)
    else:
        cos, sin = _rope_tables(cfg, positions)
        attn_q = partial(_attention_block_cached_quant, valid=write_ok)

    # caches ride the scan CARRY as full stacked arrays (in-place scatter
    # per layer); the old xs/ys protocol re-materialized every padded
    # layer slice per step — see scatter_layer_cache
    xs_layers, estack = _layer_xs_and_stack(params, impl)
    d = cfg.first_dense_layers

    def make_body(dense_mlp: bool):
        def body(carry, lp):
            x, caches, l = carry
            h, caches = attn_q(
                rms_norm(x, lp["input_norm"], cfg.rms_norm_eps),
                lp, cfg, cos, sin, caches, l, cache.lengths,
            )
            h = x + h
            norm_h = rms_norm(h, lp["post_attn_norm"], cfg.rms_norm_eps)
            if dense_mlp:
                from ..models.layers import dense_mlp_block

                out = h + dense_mlp_block(norm_h, lp, cfg)
            else:
                if estack:
                    lp = dict(lp, _expert_stack=estack, _layer_index=l - d)
                moe = (impl.ep_moe if impl.ep_moe is not None
                       else lambda a, b, c: moe_block(a, b, c, impl))
                out = h + moe(norm_h, lp, cfg)
            return (out, caches, l + 1), None
        return body

    carry = (x, (cache.k_q, cache.k_sc, cache.v_q, cache.v_sc),
             jnp.int32(0))
    if d > 0 and "dense_layers" in params:
        carry, _ = jax.lax.scan(make_body(True), carry,
                                params["dense_layers"])
    carry, _ = jax.lax.scan(make_body(False), carry, xs_layers)
    x, (nkq, nks, nvq, nvs), _ = carry
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    from ..models.model import head_logits

    logits = head_logits(params, x, cfg)
    # clamp at capacity: an unbounded length would index past the cache end
    new_len = jnp.minimum(cache.lengths + valid_lengths, cache.max_len)
    new_cache = QuantKVCache(nkq, nks, nvq, nvs, new_len)
    return logits, new_cache


def forward_cached(
    params: dict,
    tokens: jax.Array,        # [B, S_new]
    cache: KVCache,
    cfg: MoEConfig,
    impl: MoEImpl = MoEImpl(),
    valid_lengths: jax.Array | None = None,   # [B] tokens actually new
) -> tuple[jax.Array, KVCache]:
    """Run a chunk against the cache -> (logits [B, S_new, V], new cache)."""
    b, s_new = tokens.shape
    if valid_lengths is None:
        valid_lengths = jnp.full((b,), s_new, jnp.int32)
    if isinstance(cache, QuantKVCache):
        return _forward_cached_quant(params, tokens, cache, cfg, impl,
                                     valid_lengths)
    x = jnp.take(params["embed"], tokens, axis=0, mode="clip")
    positions = cache.lengths[:, None] + jnp.arange(s_new)[None]
    mla = cfg.attention_type == "mla"
    write_ok = valid_lengths > 0    # [B]; scalar per slot under vmap
    if mla:
        cos, sin = _rope_tables_mla(cfg, positions)
        attn_cached = partial(_attention_block_cached_mla, valid=write_ok)
    else:
        cos, sin = _rope_tables(cfg, positions)
        attn_cached = partial(_attention_block_cached, valid=write_ok)

    # caches in the scan CARRY (see _forward_cached_quant / the scatter
    # protocol note in kv_cache.scatter_layer_cache)
    xs_layers, estack = _layer_xs_and_stack(params, impl)
    d = cfg.first_dense_layers

    def make_body(dense_mlp: bool):
        def body(carry, lp):
            x, ck, cv, l = carry
            h, ck, cv = attn_cached(
                rms_norm(x, lp["input_norm"], cfg.rms_norm_eps),
                lp, cfg, cos, sin, ck, cv, l, cache.lengths,
            )
            h = x + h
            norm_h = rms_norm(h, lp["post_attn_norm"], cfg.rms_norm_eps)
            if dense_mlp:
                from ..models.layers import dense_mlp_block

                out = h + dense_mlp_block(norm_h, lp, cfg)
            else:
                if estack:
                    lp = dict(lp, _expert_stack=estack, _layer_index=l - d)
                moe = (impl.ep_moe if impl.ep_moe is not None
                       else lambda a, b, c: moe_block(a, b, c, impl))
                out = h + moe(norm_h, lp, cfg)
            return (out, ck, cv, l + 1), None
        return body

    carry = (x, cache.k, cache.v, jnp.int32(0))
    if d > 0 and "dense_layers" in params:
        carry, _ = jax.lax.scan(make_body(True), carry,
                                params["dense_layers"])
    carry, _ = jax.lax.scan(make_body(False), carry, xs_layers)
    x, new_k, new_v, _ = carry
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    from ..models.model import head_logits

    logits = head_logits(params, x, cfg)
    new_len = jnp.minimum(cache.lengths + valid_lengths, cache.max_len)
    new_cache = KVCache(k=new_k, v=new_v, lengths=new_len)
    return logits, new_cache


def decode_scan(
    params: dict,
    last_tokens: jax.Array,   # [B] the most recent token per slot
    cache,
    n_steps: int,
    cfg: MoEConfig,
    impl: MoEImpl = MoEImpl(),
    valid: jax.Array | None = None,   # [B] int32 active-slot mask
    temperature: float = 0.0,
    top_k: int = 0,
    rng: jax.Array | None = None,
):
    """Generate ``n_steps`` tokens in ONE device dispatch.

    A host loop pays a dispatch round-trip per token; scanning the decode
    step + sampling on device amortizes it to one round-trip per chunk. EOS handling stays on the host (callers run chunks and trim) —
    a slot's extra tokens past EOS are discarded and its cache slot is
    re-prefilled from position 0 on reuse, so the over-run is harmless.

    Returns ``(tokens [B, n_steps], cache)``.
    """
    b = last_tokens.shape[0]
    if valid is None:
        valid = jnp.ones((b,), jnp.int32)
    if rng is None:
        rng = jax.random.PRNGKey(0)

    def body(carry, key):
        toks, c = carry
        logits, c = forward_cached(params, toks, c, cfg, impl,
                                   valid_lengths=valid)
        nxt = sample_tokens(logits[:, -1], key, temperature, top_k)
        return (nxt[:, None], c), nxt

    keys = jax.random.split(rng, n_steps)
    (_, cache), toks = jax.lax.scan(
        body, (last_tokens[:, None].astype(jnp.int32), cache), keys)
    return toks.T, cache


def sample_tokens(
    logits: jax.Array,        # [B, V] last-position logits
    key: jax.Array,
    temperature: float = 0.0,
    top_k: int = 0,
) -> jax.Array:
    if temperature <= 0.0:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    scaled = logits.astype(jnp.float32) / temperature
    if top_k > 0:
        vals, _ = jax.lax.top_k(scaled, top_k)
        cutoff = vals[:, -1:]
        scaled = jnp.where(scaled < cutoff, -jnp.inf, scaled)
    return jax.random.categorical(key, scaled, axis=-1).astype(jnp.int32)
