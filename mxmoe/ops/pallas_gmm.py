"""Grouped matmul: one Pallas kernel on the Triton route.

For every expert g with a contiguous row range,
``out[rows_g] = (lhs_q[rows_g] @ W_g) * s_a[rows] * s_w[g]`` — the
reference's fused GroupGEMM (``hz_fused.cuh:14-445``): one launch covers
every routed expert and every bit width of a layer, because a bit width
lives in the codes' range and in the scales, not in the kernel. The same
kernel without scales is the float grouped product (:func:`gmm_float`):
XLA's ``ragged_dot`` runs on the GPU as a dense product over every group.

Design (Hopper):
  * Grid ``(n_tiles, logical_tiles)``. A logical tile is an (m-tile, group)
    intersection; each program loads its group id and row bounds from int32
    metadata (:func:`make_group_metadata`) — the reference's persistent-CTA
    prefix-sum scan computed once in XLA instead of inside every CTA.
  * K is walked inside the program with an int32 accumulator; Triton's
    ``num_stages`` pipelines the loads.
  * Weights live in one ragged int8 buffer ``[R, N]`` of K/2-row units:
    an int8 expert spans two units (its two K halves), a nibble-packed w4
    expert one (low nibble = row k, high nibble = row k + K/2,
    ``quant.packing.pack_int4_halves``). A per-group flag selects the loop;
    packed weights are unpacked to int8 in registers because Hopper's tensor
    cores have no int4. A plain ``[E, K, N]`` int8 stack is the all-int8
    special case of the same buffer.
  * Epilogue: ``acc · s_a[row] · s_w[n]`` in f32, stored masked to the
    group's rows.

Schemes the kernel does not cover (grouped scales, asymmetric weights,
weight-only a16) run as plain XLA in :mod:`mxmoe.ops.gmm`.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GroupMetadata(NamedTuple):
    group_ids: jax.Array      # [max_logical] group per logical tile
    m_tile_ids: jax.Array     # [max_logical] output m-tile per logical tile
    group_offsets: jax.Array  # [E+1] row starts (cumsum of group sizes)
    num_logical: jax.Array    # scalar int32: active logical tiles


def make_group_metadata(group_sizes: jax.Array, m: int, bm: int) -> GroupMetadata:
    """Logical-tile schedule for a grouped matmul.

    A logical tile is an (m_tile, group) intersection. Groups own contiguous
    row ranges; an m-tile straddling a boundary appears once per overlapped
    group. Total logical tiles ≤ cdiv(m, bm) + E - 1 (static bound).
    """
    e = group_sizes.shape[0]
    sizes = group_sizes.astype(jnp.int32)
    ends = jnp.cumsum(sizes)
    starts = ends - sizes
    group_offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32), ends])

    first_tile = starts // bm
    last_tile = jnp.where(sizes > 0, (ends - 1) // bm, first_tile)
    group_tiles = jnp.where(sizes > 0, last_tile - first_tile + 1, 0)
    num_logical = jnp.sum(group_tiles)

    # intersections <= m-tiles + interior group boundaries; with few rows
    # (decode) at most min(e, m) groups are nonempty, tightening the bound
    max_logical = min(_cdiv(m, bm) + e - 1, _cdiv(m, bm) + min(e, m) - 1)
    tile_offsets = jnp.cumsum(group_tiles) - group_tiles  # exclusive
    group_ids = jnp.repeat(
        jnp.arange(e, dtype=jnp.int32), group_tiles,
        total_repeat_length=max_logical,
    )
    # entries past num_logical are clamped to valid ids; the kernel's
    # ``t < num_logical`` guard makes those programs exit at once
    group_ids = jnp.clip(group_ids, 0, e - 1)
    t_idx = jnp.arange(max_logical, dtype=jnp.int32)
    m_tile_ids = first_tile[group_ids] + (t_idx - tile_offsets[group_ids])
    m_tile_ids = jnp.clip(m_tile_ids, 0, max(_cdiv(m, bm) - 1, 0))
    return GroupMetadata(group_ids, m_tile_ids, group_offsets, num_logical)


def offsets_overflow(x) -> bool:
    """True when Pallas-Triton would address ``x`` with wrapping offsets.

    The Triton lowering switches to 64-bit offsets only for operands above
    4 GiB; between 2 GiB and 4 GiB its 32-bit element offsets wrap (seen on
    an H100: a 2.8 GiB weight buffer gave wrong products). Callers keep
    such operands out of the kernel (``models.layers.split_expert_stack``
    leaves them per layer)."""
    size = math.prod(x.shape)
    return size > 2**31 - 1 and size * jnp.dtype(x.dtype).itemsize <= 2**32


def _pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two <= cap dividing n (Triton blocks are powers of 2)."""
    b = 1
    while b * 2 <= cap and n % (b * 2) == 0:
        b *= 2
    return b


def _gmm_kernel(*refs, bm, bn, bk, k2, scaled):
    if scaled:
        (gids_ref, mtids_ref, goffs_ref, nlog_ref, blk_ref, pf_ref, base_ref,
         lhs_ref, asc_ref, rhs_ref, bsc_ref, out_ref) = refs
    else:
        (gids_ref, mtids_ref, goffs_ref, nlog_ref, blk_ref, pf_ref, base_ref,
         lhs_ref, rhs_ref, out_ref) = refs
    integer = lhs_ref.dtype == jnp.int8
    acc_dtype = jnp.int32 if integer else jnp.float32
    # program ids are read outside the conditional (interpret mode
    # substitutes them only at the kernel's top level)
    col0 = pl.program_id(0) * bn
    t = pl.program_id(1)

    @pl.when(t < nlog_ref[0])
    def _():
        g = gids_ref[t]
        row0 = pl.multiple_of(mtids_ref[t] * bm, bm)
        rows = pl.ds(row0, bm)
        cols = pl.ds(pl.multiple_of(col0, bn), bn)
        wrow = blk_ref[g] * k2          # first weight row of this group

        def a(k0):
            return lhs_ref[rows, pl.ds(k0, bk)]

        def w(r0):
            return rhs_ref[pl.ds(wrow + r0, bk), cols]

        def dot(x, y):
            # HIGHEST keeps f32 operands in full precision (no TF32)
            return jnp.dot(x, y, preferred_element_type=acc_dtype,
                           precision=jax.lax.Precision.HIGHEST)

        def plain_step(j, acc):
            r0 = pl.multiple_of(j * bk, bk)
            return acc + dot(a(r0), w(r0)) + dot(a(k2 + r0), w(k2 + r0))

        def packed_step(j, acc):
            r0 = pl.multiple_of(j * bk, bk)
            p = w(r0)
            four = jnp.int8(4)
            lo = jax.lax.shift_right_arithmetic(jax.lax.shift_left(p, four), four)
            hi = jax.lax.shift_right_arithmetic(p, four)
            return acc + dot(a(r0), lo) + dot(a(k2 + r0), hi)

        def k_loop(step):
            return lambda: jax.lax.fori_loop(
                0, k2 // bk, step, jnp.zeros((bm, bn), acc_dtype))

        if integer:
            acc = jax.lax.cond(pf_ref[g] == 1, k_loop(packed_step),
                               k_loop(plain_step))
        else:
            acc = k_loop(plain_step)()
        if scaled and out_ref.dtype != jnp.int32:
            acc = (acc.astype(jnp.float32) * asc_ref[rows][:, None]
                   * bsc_ref[base_ref[0] + g, cols][None, :])
        r = row0 + jax.lax.broadcasted_iota(jnp.int32, (bm, bn), 0)
        mask = (r >= goffs_ref[g]) & (r < goffs_ref[g + 1])
        plt.store(out_ref.at[rows, cols], acc.astype(out_ref.dtype), mask=mask)


def _grouped_call(lhs, rhs, group_sizes, pflags, blk_offsets, scales, *,
                  group_base, bm, bn, bk, num_warps, num_stages, out_dtype,
                  interpret, name):
    """Launch :func:`_gmm_kernel`; ``scales`` is ``(lhs_scale, rhs_scale)``
    or None (unscaled float product)."""
    if interpret is None:
        from ..utils.device import interpret_kernels

        interpret = interpret_kernels()
    m, k = lhs.shape
    assert k % 2 == 0, k
    k2 = k // 2
    n = rhs.shape[-1]
    assert rhs.shape[0] % k2 == 0, (rhs.shape, k2)
    assert not offsets_overflow(rhs), f"weight buffer {rhs.shape} in the " \
        "2-4 GiB range the Triton lowering addresses with wrapping offsets"
    bn = _pow2_divisor(n, bn)
    bk = _pow2_divisor(k2, bk)
    assert bn >= 16 and bk >= 16, (n, k2, bn, bk)
    m_pad = _cdiv(max(m, 1), bm) * bm
    if m_pad != m:   # whole row tiles: every block load stays in bounds
        lhs = jnp.pad(lhs, ((0, m_pad - m), (0, 0)))
    meta = make_group_metadata(group_sizes, m_pad, bm)
    operands = [lhs]
    if scales is not None:
        lhs_scale, rhs_scale = scales
        lhs_scale = lhs_scale.reshape(m).astype(jnp.float32)
        operands += [jnp.pad(lhs_scale, (0, m_pad - m)), rhs,
                     rhs_scale.reshape(-1, n).astype(jnp.float32)]
    else:
        operands.append(rhs)
    kernel = functools.partial(_gmm_kernel, bm=bm, bn=bn, bk=bk, k2=k2,
                               scaled=scales is not None)
    out = pl.pallas_call(
        kernel,
        grid=(n // bn, meta.group_ids.shape[0]),
        out_shape=jax.ShapeDtypeStruct((m_pad, n), out_dtype),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=num_stages),
        interpret=interpret,
        name=name,
    )(meta.group_ids, meta.m_tile_ids, meta.group_offsets,
      meta.num_logical.reshape(1), jnp.asarray(blk_offsets, jnp.int32),
      jnp.asarray(pflags, jnp.int32),
      jnp.asarray(group_base, jnp.int32).reshape(1), *operands)
    return out[:m] if m_pad != m else out


def gmm_int8(
    lhs_q: jax.Array,        # [M, K] int8 codes
    lhs_scale: jax.Array,    # [M, 1] (or [M]) f32 per-row scale
    rhs: jax.Array,          # [R, N] int8 ragged buffer of K/2-row units
    rhs_scale: jax.Array,    # [G_total, 1, N] (or [G_total, N]) f32
    group_sizes: jax.Array,  # [E] int32 rows per group (traced ok)
    pflags: jax.Array,       # [E] int32: 1 = the group's weights are packed
    blk_offsets: jax.Array,  # [E] int32: first K/2-unit of each group in rhs
    *,
    group_base=0,            # scale row of group 0 (layer-stacked scales)
    bm: int = 128,
    bn: int = 64,
    bk: int = 128,
    num_warps: int = 4,
    num_stages: int = 3,
    out_dtype=jnp.bfloat16,
    interpret: bool | None = None,
) -> jax.Array:
    """The one grouped int8 launch (see module docstring).

    Default tiles are the best measured on an H100 at the headline widths
    (PERF.md); decode-sized launches pass a short ``bm``.

    ``out_dtype=jnp.int32`` returns the unscaled int32 accumulators.
    ``interpret=None`` interprets exactly when JAX runs on the CPU.
    """
    return _grouped_call(
        lhs_q, rhs, group_sizes, pflags, blk_offsets, (lhs_scale, rhs_scale),
        group_base=group_base, bm=bm, bn=bn, bk=bk, num_warps=num_warps,
        num_stages=num_stages, out_dtype=out_dtype, interpret=interpret,
        name="gmm_int8")


def float_tiles(m: int, dtype) -> dict:
    """Tiles of :func:`gmm_float`, the best of an H100 sweep at the
    headline widths (PERF.md): short row tiles for decode-sized launches;
    f32 operands take a smaller K block (shared memory holds
    ``num_stages`` copies of both blocks) and, at prefill, a shorter row
    tile (the 128-row f32 tile ran 5x slower)."""
    f32 = jnp.dtype(dtype) == jnp.float32
    if m <= 1024:
        return dict(bm=16, bn=64, bk=32 if f32 else 128, num_warps=4,
                    num_stages=3)
    return dict(bm=64 if f32 else 128, bn=128, bk=32 if f32 else 64,
                num_warps=4, num_stages=3)


def float_supported(k: int, n: int) -> bool:
    """Widths the kernel's power-of-two blocks can tile."""
    return k % 2 == 0 and _pow2_divisor(k // 2, 16) >= 16 \
        and _pow2_divisor(n, 16) >= 16


def gmm_float(
    lhs: jax.Array,          # [M, K] bf16 or f32, expert-sorted rows
    rhs: jax.Array,          # [G_total, K, N] same dtype
    group_sizes: jax.Array,  # [E] int32
    *,
    group_base=0,            # first group of this layer in a layer stack
    out_dtype=None,
    tiles: dict | None = None,
    interpret: bool | None = None,
) -> jax.Array:
    """Float grouped product ``out[rows_g] = lhs[rows_g] @ rhs[base + g]``
    with an f32 accumulator (f32 operands at full precision): the same
    kernel, every group "int8-stored" (two K/2 units) and no scales."""
    e = group_sizes.shape[0]
    g_total, k, n = rhs.shape
    blk = (jnp.arange(e, dtype=jnp.int32)
           + jnp.asarray(group_base, jnp.int32)) * 2
    return _grouped_call(
        lhs, rhs.reshape(g_total * k, n), group_sizes,
        jnp.zeros((e,), jnp.int32), blk, None, group_base=group_base,
        out_dtype=out_dtype or lhs.dtype, interpret=interpret,
        name="gmm_float", **(tiles or float_tiles(lhs.shape[0], lhs.dtype)))


def _stack_layout(rhs_q, e_local, group_base, packed):
    """[G_total, K or K/2, N] stack -> (ragged [R, N], pflags, blk_offsets)."""
    g_total, kr, n = rhs_q.shape
    units = 1 if packed else 2
    blk = (jnp.arange(e_local, dtype=jnp.int32)
           + jnp.asarray(group_base, jnp.int32)) * units
    pf = jnp.full((e_local,), int(packed), jnp.int32)
    return rhs_q.reshape(g_total * kr, n), pf, blk


def gmm_w8a8(lhs_q, lhs_scale, rhs_q, rhs_scale, group_sizes, *,
             group_base=0, **kw) -> jax.Array:
    """Per-token × per-channel int8 grouped matmul over an ``[E, K, N]``
    int8 stack (``[L*E, K, N]`` layer-stacked with ``group_base = l*E``)."""
    e = group_sizes.shape[0]
    rhs, pf, blk = _stack_layout(rhs_q, e, group_base, packed=False)
    return gmm_int8(lhs_q, lhs_scale, rhs, rhs_scale, group_sizes, pf, blk,
                    group_base=group_base, **kw)


def gmm_w4a8_packed(lhs_q, lhs_scale, rhs_packed, rhs_scale, group_sizes, *,
                    group_base=0, **kw) -> jax.Array:
    """Same product over an all-nibble-packed ``[E, K/2, N]`` stack: half
    the weight bytes of :func:`gmm_w8a8` on identical codes."""
    e = group_sizes.shape[0]
    rhs, pf, blk = _stack_layout(rhs_packed, e, group_base, packed=True)
    return gmm_int8(lhs_q, lhs_scale, rhs, rhs_scale, group_sizes, pf, blk,
                    group_base=group_base, **kw)


def gmm_int8_reference(lhs_q, lhs_scale, rhs, rhs_scale, group_sizes, pflags,
                       blk_offsets, *, group_base=0, out_dtype=jnp.float32):
    """Plain XLA oracle of :func:`gmm_int8`: unpack the ragged buffer to an
    ``[E, K, N]`` int8 stack, exact int32 products per group, same f32
    epilogue. ``out_dtype=None`` returns the int32 accumulators."""
    from .gmm import ragged_to_dense_int8

    e = group_sizes.shape[0]
    k = lhs_q.shape[1]
    wq = ragged_to_dense_int8(rhs, pflags, blk_offsets, k)          # [E,K,N]
    acc = jax.lax.ragged_dot(lhs_q, wq, group_sizes,
                             preferred_element_type=jnp.int32)
    if out_dtype is None:
        return acc
    n = rhs.shape[-1]
    sc = jax.lax.dynamic_slice_in_dim(rhs_scale.reshape(-1, n),
                                      jnp.asarray(group_base, jnp.int32), e)
    row_g = jnp.repeat(jnp.arange(e), group_sizes,
                       total_repeat_length=lhs_q.shape[0])
    return (acc.astype(jnp.float32) * lhs_scale.reshape(-1, 1)
            * sc[row_g]).astype(out_dtype)
