"""Static-shape KV cache for decode.

Layout: K/V stacked [L, B, n_kv, S_max, hd] (head-major). The stacked
arrays ride the layer scan's CARRY and are updated in place by
advanced-index scatters at per-slot positions (``scatter_layer_cache*``)
— no dynamic shapes anywhere, no per-layer slice materialization (the
old xs/ys protocol re-read and re-wrote every padded layer slice per
decode step). Batch slots are independent
(continuous batching assigns/evicts slots).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.configs import MoEConfig


class KVCache(NamedTuple):
    k: jax.Array          # [L, B, n_kv, S_max, hd] (head-major: attention
                          # contractions need no cache transpose at decode)
    v: jax.Array          # [L, B, n_kv, S_max, hd]
    lengths: jax.Array    # [B] int32 valid tokens per slot

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def mla_cache_k_dim(cfg: MoEConfig) -> int:
    """MLA K-cache lane width: qk_head_dim padded UP to a 128 multiple
    (192 -> 256). The rope block's tail lanes store zeros, which add
    nothing to q.k — attention is exact. The padding served a fused
    decode kernel that no longer exists; whether it still pays on the GPU
    (+33% K-cache bytes at 192) is not measured yet."""
    return -(-cfg.qk_head_dim // 128) * 128


def init_kv_cache(
    cfg: MoEConfig, batch: int, max_len: int, dtype=jnp.bfloat16
) -> KVCache:
    """K/V head dims differ under MLA (qk_head_dim vs v_head_dim)."""
    if cfg.attention_type == "mla":
        n_kv, k_dim, v_dim = cfg.num_heads, mla_cache_k_dim(cfg), cfg.v_head_dim
    else:
        n_kv = cfg.num_kv_heads
        k_dim = v_dim = cfg.head_dim
    return KVCache(
        k=jnp.zeros((cfg.num_layers, batch, n_kv, max_len, k_dim), dtype),
        v=jnp.zeros((cfg.num_layers, batch, n_kv, max_len, v_dim), dtype),
        lengths=jnp.zeros((batch,), jnp.int32),
    )


def scatter_layer_cache(full_k, full_v, layer, new_k, new_v, lengths,
                        valid=None):
    """Write a chunk into ONE layer of the STACKED cache, in place.

    ``full_k``/``full_v``: [L, B, n_kv, S_max, hd]; ``new_k``/``new_v``
    token-major [B, S_new, n_kv, hd]; ``layer`` a traced scalar.

    This is the decode-hot-path protocol: an advanced-index scatter on a
    loop-carried stacked cache stays in place under XLA, while a
    per-layer scan xs/ys protocol re-materializes every layer's full
    padded [B, n, S_max, hd] slice per step, linear in S_max. Slots whose write
    would overflow S_max (or with ``valid`` False) are dropped, never
    clamped onto a neighbour's history.
    """
    b, s_new = new_k.shape[:2]
    s_max = full_k.shape[3]
    pos = lengths[:, None] + jnp.arange(s_new)[None]       # [B, S_new]
    if valid is not None:
        pos = jnp.where(valid[:, None], pos, s_max)        # OOB -> dropped
    bidx = jnp.arange(b)[:, None]
    full_k = full_k.at[layer, bidx, :, pos, :].set(
        new_k.astype(full_k.dtype), mode="drop")
    full_v = full_v.at[layer, bidx, :, pos, :].set(
        new_v.astype(full_v.dtype), mode="drop")
    return full_k, full_v


def scatter_layer_cache_quant(ckq, cks, cvq, cvs, layer, new_k, new_v,
                              lengths, valid=None):
    """Quantized-cache variant of :func:`scatter_layer_cache`:
    per-vector int8 quant fused into the scatter write."""
    kq, ks = _quant_vec(new_k)                 # [B, S_new, n, hd], [B, S_new, n]
    vq, vs = _quant_vec(new_v)
    b, s_new = new_k.shape[:2]
    s_max = ckq.shape[3]
    pos = lengths[:, None] + jnp.arange(s_new)[None]
    if valid is not None:
        pos = jnp.where(valid[:, None], pos, s_max)
    bidx = jnp.arange(b)[:, None]
    ckq = ckq.at[layer, bidx, :, pos, :].set(kq, mode="drop")
    cks = cks.at[layer, bidx, :, pos].set(ks, mode="drop")
    cvq = cvq.at[layer, bidx, :, pos, :].set(vq, mode="drop")
    cvs = cvs.at[layer, bidx, :, pos].set(vs, mode="drop")
    return ckq, cks, cvq, cvs


def attention_with_cache(
    q: jax.Array,          # [B, S_new, n_h, hd]
    cache_k: jax.Array,    # [B, n_kv, S_max, hd] (already updated)
    cache_v: jax.Array,
    lengths: jax.Array,    # [B] lengths BEFORE this step
    s_new: int,
    scale: float | None = None,   # default 1/sqrt(hd); MLA passes
                                  # 1/sqrt(qk_head_dim) since hd is PADDED
) -> jax.Array:
    """GQA attention over the head-major cache with causal + validity
    masking. Query position i attends cache slots [0, lengths + i]."""
    b, _, n_h, hd = q.shape
    n_kv = cache_k.shape[1]
    s_max = cache_k.shape[2]
    groups = n_h // n_kv

    qg = q.reshape(b, s_new, n_kv, groups, hd)
    scores = jnp.einsum("bsngh,bnth->bngst", qg, cache_k).astype(jnp.float32)
    scores = scores * (scale if scale is not None else 1.0 / float(hd) ** 0.5)

    key_pos = jax.lax.broadcasted_iota(jnp.int32, (s_new, s_max), 1)
    q_end = lengths[:, None, None] + jax.lax.broadcasted_iota(
        jnp.int32, (s_new, s_max), 0
    )[None]
    mask = key_pos[None] <= q_end              # [B, S_new, S_max]
    scores = jnp.where(mask[:, None, None], scores, -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    out = jnp.einsum("bngst,bnth->bsngh", probs, cache_v)
    # v head dim may differ from the qk head dim (MLA)
    return out.reshape(b, s_new, n_h, cache_v.shape[-1])


# ---------------------------------------------------------------------------
# int8-quantized KV cache: 2x memory / read bandwidth, per-vector scales
# ---------------------------------------------------------------------------

class QuantKVCache(NamedTuple):
    """KV cache with int8 storage and per-(slot, pos, head) vector scales.

    Scales factor out of both attention contractions, so dequant costs one
    elementwise multiply on scores / probs — no materialized f32 cache.
    """

    k_q: jax.Array        # [L, B, n_kv, S_max, hd] int8 (head-major)
    k_sc: jax.Array       # [L, B, n_kv, S_max] f32
    v_q: jax.Array
    v_sc: jax.Array
    lengths: jax.Array    # [B]

    @property
    def max_len(self) -> int:
        return self.k_q.shape[3]


def init_quant_kv_cache(cfg: MoEConfig, batch: int, max_len: int) -> QuantKVCache:
    if cfg.attention_type == "mla":
        n_kv, k_dim, v_dim = cfg.num_heads, mla_cache_k_dim(cfg), cfg.v_head_dim
    else:
        n_kv = cfg.num_kv_heads
        k_dim = v_dim = cfg.head_dim
    shape_k = (cfg.num_layers, batch, n_kv, max_len, k_dim)
    shape_v = (cfg.num_layers, batch, n_kv, max_len, v_dim)
    sc = (cfg.num_layers, batch, n_kv, max_len)
    return QuantKVCache(
        k_q=jnp.zeros(shape_k, jnp.int8), k_sc=jnp.zeros(sc, jnp.float32),
        v_q=jnp.zeros(shape_v, jnp.int8), v_sc=jnp.zeros(sc, jnp.float32),
        lengths=jnp.zeros((batch,), jnp.int32),
    )


def _quant_vec(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-vector sym int8 quant over the last axis."""
    amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)
    sc = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.round(x.astype(jnp.float32) / sc[..., None]).astype(jnp.int8)
    return q, sc


def attention_with_quant_cache(
    q: jax.Array,          # [B, S_new, n_h, hd]
    ckq: jax.Array,        # [B, n_kv, S_max, hd] int8 (head-major)
    cks: jax.Array,        # [B, n_kv, S_max] f32
    cvq: jax.Array,
    cvs: jax.Array,
    lengths: jax.Array,
    s_new: int,
    scale: float | None = None,   # default 1/sqrt(hd); MLA passes
                                  # 1/sqrt(qk_head_dim) since hd is PADDED
) -> jax.Array:
    """GQA attention over the int8 cache; scales fold into scores/probs."""
    b, _, n_h, hd = q.shape
    n_kv = ckq.shape[1]
    s_max = ckq.shape[2]
    groups = n_h // n_kv

    qg = q.reshape(b, s_new, n_kv, groups, hd)
    scores = jnp.einsum(
        "bsngh,bnth->bngst", qg.astype(jnp.float32), ckq.astype(jnp.float32)
    )
    scores = scores * cks[:, :, None, None, :]          # [B, n, 1, 1, t]
    scores = scores * (scale if scale is not None else 1.0 / float(hd) ** 0.5)

    key_pos = jax.lax.broadcasted_iota(jnp.int32, (s_new, s_max), 1)
    q_end = lengths[:, None, None] + jax.lax.broadcasted_iota(
        jnp.int32, (s_new, s_max), 0
    )[None]
    mask = key_pos[None] <= q_end
    scores = jnp.where(mask[:, None, None], scores, -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1)
    probs = probs * cvs[:, :, None, None, :]
    out = jnp.einsum("bngst,bnth->bsngh", probs, cvq.astype(jnp.float32))
    return out.reshape(b, s_new, n_h, cvq.shape[-1]).astype(q.dtype)
