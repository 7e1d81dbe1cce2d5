"""Token -> expert routing and ragged dispatch, static-shaped for XLA.

XLA replacement for the reference's in-kernel permutation
(``torch.sort`` + ``index_select`` in ``ref_bind.cu:47-64``): here routing
emits a stable sort permutation plus per-expert ``group_sizes``, the layout
every grouped-matmul kernel (``jax.lax.ragged_dot`` and our Pallas gmm)
consumes directly. All shapes are static: T tokens x top-k slots.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Routing(NamedTuple):
    """Routing decisions for a batch of T tokens with top-k experts each."""

    weights: jax.Array      # [T, k] float32 combine weights
    expert_ids: jax.Array   # [T, k] int32


class Dispatch(NamedTuple):
    """Sorted ragged layout for grouped matmul over T*k expanded rows."""

    sort_idx: jax.Array     # [T*k] position in expanded (token-major) order
    group_sizes: jax.Array  # [E] rows per expert (sums to T*k)
    token_ids: jax.Array    # [T*k] source token per sorted row
    combine_weights: jax.Array  # [T*k] weight per sorted row


def route_topk(
    router_logits: jax.Array,
    top_k: int,
    norm_topk_prob: bool,
    scaling: float = 1.0,
) -> Routing:
    """Softmax-then-top-k routing (Qwen2-MoE / Mixtral / DeepSeek-V2).

    Matches HF semantics: softmax over all experts in float32, take top-k,
    optionally renormalize the selected weights to sum to 1
    (``norm_topk_prob``; True for Mixtral, False for Qwen1.5-MoE-A2.7B),
    then multiply by ``scaling`` (DeepSeek-V2 routed_scaling_factor).
    Reference traces this via gate hooks (``moe_tracer.py:88-129``).
    """
    probs = jax.nn.softmax(router_logits.astype(jnp.float32), axis=-1)
    weights, ids = jax.lax.top_k(probs, top_k)
    if norm_topk_prob:
        weights = weights / jnp.sum(weights, axis=-1, keepdims=True)
    if scaling != 1.0:
        weights = weights * scaling
    return Routing(weights=weights, expert_ids=ids.astype(jnp.int32))


def make_dispatch(
    routing: Routing, num_experts: int, align: int | None = None
) -> Dispatch:
    """Stable-sort the T*k expanded rows by expert id.

    ``align``: pad every expert's row count to a multiple of ``align`` (the
    grouped-matmul row-tile bm). Each output tile then belongs to exactly
    one expert, so no boundary tile is computed once per overlapping group —
    E·bm/2 expected padding rows versus (E-1)·bm boundary recompute in the
    unaligned layout (half the waste, and padding tiles beyond the live
    count are skipped by the kernels' num_logical guard). Padding rows
    alias token 0 with combine weight 0: their outputs are never read.
    """
    t, k = routing.expert_ids.shape
    flat_experts = routing.expert_ids.reshape(-1)            # [T*k]
    flat_weights = routing.weights.reshape(-1)
    token_ids = (
        jax.lax.broadcasted_iota(jnp.int32, (t, k), 0).reshape(-1)
    )
    sort_idx = jnp.argsort(flat_experts, stable=True)
    group_sizes = jnp.bincount(flat_experts, length=num_experts).astype(jnp.int32)
    if align is None or align <= 1:
        return Dispatch(
            sort_idx=sort_idx,
            group_sizes=group_sizes,
            token_ids=jnp.take(token_ids, sort_idx),
            combine_weights=jnp.take(flat_weights, sort_idx),
        )

    bm = int(align)
    padded = ((group_sizes + bm - 1) // bm) * bm             # [E]
    m_pad = t * k + num_experts * (bm - 1)                   # static bound
    starts = jnp.cumsum(group_sizes) - group_sizes
    padded_starts = jnp.cumsum(padded) - padded
    # position of each sorted row in the padded layout
    g_of_row = jnp.repeat(jnp.arange(num_experts, dtype=jnp.int32),
                          group_sizes, total_repeat_length=t * k)
    rank = jnp.arange(t * k, dtype=jnp.int32) - starts[g_of_row]
    pos = padded_starts[g_of_row] + rank                     # [T*k] < m_pad
    tid_sorted = jnp.take(token_ids, sort_idx)
    w_sorted = jnp.take(flat_weights, sort_idx)
    tid_pad = jnp.zeros((m_pad,), jnp.int32).at[pos].set(tid_sorted)
    w_pad = jnp.zeros((m_pad,), flat_weights.dtype).at[pos].set(w_sorted)
    return Dispatch(
        sort_idx=sort_idx,
        group_sizes=padded,
        token_ids=tid_pad,
        combine_weights=w_pad,
    )


def gather_tokens(x: jax.Array, dispatch: Dispatch) -> jax.Array:
    """[T, H] -> [T*k, H] rows in expert-sorted order."""
    return jnp.take(x, dispatch.token_ids, axis=0)


def combine_tokens(
    expert_out: jax.Array, dispatch: Dispatch, num_tokens: int
) -> jax.Array:
    """Weighted scatter-add of sorted expert outputs back to [T, H].

    Zero-weight rows (aligned-layout padding, dropped assignments) are
    masked rather than multiplied: their outputs may be uninitialized
    (kernels skip tiles past the live count) and NaN·0 would poison the
    segment sum."""
    w = dispatch.combine_weights[:, None].astype(expert_out.dtype)
    weighted = jnp.where(w != 0, expert_out * w, 0)
    return jax.ops.segment_sum(weighted, dispatch.token_ids, num_segments=num_tokens)
