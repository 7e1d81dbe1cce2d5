"""Grouped (ragged) matmul front-end and the plain-XLA quantized families.

``gmm(lhs, rhs, group_sizes)`` computes, for each expert g, ``out[rows_g] =
lhs[rows_g] @ rhs[g]`` where rows are contiguous per group (expert-sorted):

  'auto'       — the Triton grouped kernel (``pallas_gmm.gmm_float``) on
                 the GPU where its blocks tile the widths, ``ragged_dot``
                 elsewhere: XLA lowers ``ragged_dot`` on the GPU to a dense
                 product over every group (E× the work; PERF.md)
  'ragged_dot' — jax.lax.ragged_dot, XLA's native grouped matmul
  'dense'      — one-hot einsum reference (oracle for tests)

The quantized schemes the Triton int8 kernel (:mod:`.pallas_gmm`) does not
cover — grouped (g128-class) scales, asymmetric weights, weight-only a16 and
layers that mix a16 with w×a experts — run here: dequantize both operands
in XLA (exactly the fake-quant transform), then one f32 grouped product at
full precision. They are off the served mixed-precision path, so they are
written for clarity, not speed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import pallas_gmm


def gmm_dense_reference(lhs: jax.Array, rhs: jax.Array, group_sizes: jax.Array) -> jax.Array:
    """O(E)-compute oracle: mask-and-sum over experts. Exact for any sizes."""
    m = lhs.shape[0]
    e = rhs.shape[0]
    ends = jnp.cumsum(group_sizes)
    starts = ends - group_sizes
    row = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)
    out = jnp.zeros((m, rhs.shape[-1]), dtype=jnp.promote_types(lhs.dtype, rhs.dtype))
    for g in range(e):
        mask = (row >= starts[g]) & (row < ends[g])
        contrib = (jnp.where(mask, 1, 0).astype(lhs.dtype) * lhs) @ rhs[g]
        out = out + contrib
    return out


def gmm(
    lhs: jax.Array,          # [M, K] expert-sorted rows
    rhs: jax.Array,          # [E, K, N]
    group_sizes: jax.Array,  # [E] int32
    backend: str = "auto",
    preferred_element_type=None,
) -> jax.Array:
    out_dtype = preferred_element_type or lhs.dtype
    if backend == "auto":
        from ..utils.device import interpret_kernels

        if not interpret_kernels() and lhs.dtype == rhs.dtype and \
                pallas_gmm.float_supported(*rhs.shape[1:]):
            return pallas_gmm.gmm_float(lhs, rhs, group_sizes,
                                        out_dtype=out_dtype)
    if backend in ("auto", "ragged_dot"):
        # full precision: an f32 product must not run as TF32 on the GPU
        return jax.lax.ragged_dot(lhs, rhs, group_sizes,
                                  precision=jax.lax.Precision.HIGHEST,
                                  preferred_element_type=out_dtype)
    if backend == "dense":
        return gmm_dense_reference(lhs, rhs, group_sizes)
    raise ValueError(f"unknown gmm backend {backend!r}")


def ragged_to_dense_int8(rhs: jax.Array, pflags: jax.Array,
                         blk_offsets: jax.Array, k: int) -> jax.Array:
    """Ragged mixed weight buffer ``[R, N]`` (K/2-row units; packed experts
    nibble-packed in one unit, int8 experts in two) -> ``[E, K, N]`` int8."""
    k2 = k // 2
    kk = jnp.arange(k, dtype=jnp.int32)
    pf = jnp.asarray(pflags, jnp.int32)[:, None]                  # [E, 1]
    src = (jnp.asarray(blk_offsets, jnp.int32)[:, None] * k2
           + jnp.where(pf == 1, kk % k2, kk))                       # [E, K]
    rows = jnp.take(rhs, src, axis=0)                               # [E,K,N]
    four = jnp.int8(4)
    lo = jax.lax.shift_right_arithmetic(jax.lax.shift_left(rows, four), four)
    hi = jax.lax.shift_right_arithmetic(rows, four)
    unpacked = jnp.where((kk < k2)[None, :, None], lo, hi)
    return jnp.where(pf[:, :, None] == 1, unpacked, rows)


def dequant_weights(wq: jax.Array, sc: jax.Array, zp: jax.Array | None = None
                    ) -> jax.Array:
    """[E, K, N] codes with [E, G, N] scales/zero points -> f32 [E, K, N]."""
    e, k, n = wq.shape
    g = sc.shape[-2]
    w = wq.astype(jnp.float32).reshape(e, g, k // g, n) * sc[:, :, None, :]
    if zp is not None:
        w = w + zp[:, :, None, :]
    return w.reshape(e, k, n)


def dequant_acts(aq: jax.Array, asc: jax.Array) -> jax.Array:
    """[M, K] codes with [M, G] scales -> f32 [M, K]."""
    m, k = aq.shape
    g = asc.shape[-1]
    return (aq.astype(jnp.float32).reshape(m, g, k // g)
            * asc[:, :, None]).reshape(m, k)


def _layer_slice(w, group_base, e):
    """This layer's ``e`` groups of a layer-stacked ``[L*E, ...]`` operand."""
    if group_base is None or w.shape[0] == e:
        return w
    return jax.lax.dynamic_slice_in_dim(
        w, jnp.asarray(group_base, jnp.int32), e, axis=0)


def gmm_dequant(
    lhs: jax.Array,          # [M, K] f32/bf16 activations (already dequantized)
    wq: jax.Array,           # [E(or L*E), K, N] int8 codes
    sc: jax.Array,           # [E, G, N] f32
    zp: jax.Array | None,    # [E, G, N] f32 recentred zero points or None
    group_sizes: jax.Array,  # [E]
    *,
    group_base=None,         # layer-stacked operands: this layer's first group
    out_dtype=jnp.bfloat16,
) -> jax.Array:
    """Quantized grouped matmul in XLA + the float kernel: ``lhs @
    dequant(W)`` per group in f32 at full precision — the fake-quant
    semantics every kernel matches."""
    e = group_sizes.shape[0]
    w = dequant_weights(_layer_slice(wq, group_base, e),
                        _layer_slice(sc, group_base, e),
                        None if zp is None else _layer_slice(zp, group_base, e))
    out = gmm(lhs.astype(jnp.float32), w, group_sizes)
    return out.astype(out_dtype)


def gmm_w8a8_grouped(lhs_q, lhs_scale, rhs_q, rhs_scale, group_sizes, *,
                     rhs_zp=None, group_base=None, out_dtype=jnp.bfloat16):
    """w×a with per-(row, k-group) act scales ``[M, G]`` and per-(k-group,
    column) weight scales/zero points ``[E, G, N]`` (grouped, asymmetric and
    flex mixes; per-channel experts carry scales replicated across G)."""
    return gmm_dequant(dequant_acts(lhs_q, lhs_scale.reshape(lhs_q.shape[0], -1)),
                       rhs_q, rhs_scale, rhs_zp, group_sizes,
                       group_base=group_base, out_dtype=out_dtype)


def gmm_mixed_wo_wxa(lhs, lhs_q, lhs_scale, rhs_q, rhs_scale, row_a16,
                     group_sizes, *, rhs_zp=None, group_base=None,
                     out_dtype=jnp.bfloat16):
    """Layers mixing weight-only a16 experts with w×a experts: a16 rows
    (``row_a16 [M]`` true) keep their activations, the others use their
    dequantized codes; one product over every expert."""
    a = jnp.where(row_a16[:, None], lhs.astype(jnp.float32),
                  dequant_acts(lhs_q, lhs_scale.reshape(lhs_q.shape[0], -1)))
    return gmm_dequant(a, rhs_q, rhs_scale, rhs_zp, group_sizes,
                       group_base=group_base, out_dtype=out_dtype)
