"""Integer storage formats for quantized kernels.

Replacement for the reference's host-side pack/permute pipeline
(``mxmoe/kernels/src/include/quantize.cuh:289-475``). There is no
``ldmatrix`` layout to permute for: the Triton kernel and XLA handle tiling,
so packing is just (a) integer codes in int8 (w<=4 optionally nibble-packed
two per byte; the tensor cores compute int8/bf16), and (b) scale/zp laid
out so a kernel can index them per (k-group, column).

Conventions (all kernels use A[M,K] @ B[K,N]):
  weights      B stored [.., K, N]; scales/zp [.., K//g, N]  (g=-1 -> [.., 1, N])
  activations  A stored [M, K];     scales/zp [M, K//g]      (g=-1 -> [M, 1])

Asymmetric codes are re-centred to signed storage: q' = q - 2^(b-1) with
zp' = zp + 2^(b-1) * scale, so int4/int8 hold them natively and
``dequant = q' * scale + zp'`` still holds exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .rtn import quantize
from .schemes import QLinearConfig


class PackedTensor(NamedTuple):
    values: jax.Array  # int8 or int4 codes
    scale: jax.Array   # float32
    zp: jax.Array      # float32 (zeros when symmetric)
    bits: int
    gsize: int
    sym: bool

    @property
    def storage_dtype(self):
        return self.values.dtype


def storage_dtype_for(bits: float) -> jnp.dtype:
    # Sub-byte codes live in int8; the bandwidth-saving format is explicit
    # nibble packing (pack_int4_halves) consumed by the int8 kernel, which
    # unpacks in registers (the GPU's tensor cores have no int4 path).
    if bits <= 8:
        return jnp.int8
    raise ValueError(f"no integer storage for {bits}-bit")


def pack_int4_halves(codes_i8: jax.Array) -> jax.Array:
    """Pack signed 4-bit codes [..., K, N] -> int8 [..., K//2, N] with the
    *halves* layout: low nibble = k, high nibble = k + K/2. Unpacking is a
    contiguous concat along K (no sublane interleave) — the layout the
    int4-packed Pallas kernel consumes."""
    k = codes_i8.shape[-2]
    lo = codes_i8[..., : k // 2, :].astype(jnp.int32) & 0xF
    hi = codes_i8[..., k // 2:, :].astype(jnp.int32) & 0xF
    return (lo | (hi << 4)).astype(jnp.int8)


def unpack_int4_halves(packed: jax.Array) -> jax.Array:
    """Inverse of :func:`pack_int4_halves`."""
    p = packed.astype(jnp.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return jnp.concatenate([lo, hi], axis=-2).astype(jnp.int8)


def pack_int4_rows(codes_i8: jax.Array) -> jax.Array:
    """Pack signed 4-bit codes [..., K, N] -> int8 [..., K//2, N], two
    adjacent K values per byte (low nibble = even k). K must be even."""
    lo = codes_i8[..., 0::2, :].astype(jnp.int32) & 0xF
    hi = codes_i8[..., 1::2, :].astype(jnp.int32) & 0xF
    return (lo | (hi << 4)).astype(jnp.int8)


def unpack_int4_rows(packed: jax.Array) -> jax.Array:
    """Inverse of :func:`pack_int4_rows`: int8 [..., K//2, N] -> [..., K, N]."""
    p = packed.astype(jnp.int32)
    lo = ((p & 0xF) ^ 8) - 8          # sign-extend low nibble
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    k2, n = packed.shape[-2], packed.shape[-1]
    out = jnp.stack([lo, hi], axis=-2)            # [..., K//2, 2, N]
    return out.reshape(*packed.shape[:-2], 2 * k2, n).astype(jnp.int8)


def build_ragged_mixed(codes_i8: jax.Array, pflags) -> tuple[jax.Array, list[int]]:
    """Stacked int8 codes [E, K, N] + per-expert packed flags -> the ragged
    mixed weight buffer consumed by ``ops.pallas_gmm.gmm_int8``.

    Experts with ``pflags[e]`` true must hold int4-range codes; they are
    nibble-packed (halves layout) into ONE K/2-row unit. int8 experts span
    TWO K/2-row units (their upper/lower K halves). Returns
    (rhs_cat [R, N] int8, blk_offsets) with R = sum over experts of
    (K/2 if packed else K) — the exact avg-bits HBM footprint.
    """
    import numpy as np

    e, k, n = codes_i8.shape
    assert k % 2 == 0, k
    pf = np.asarray(pflags, bool)
    pieces = []
    blk_offsets = []
    off = 0
    for ei in range(e):
        blk_offsets.append(off)
        if pf[ei]:
            pieces.append(pack_int4_halves(codes_i8[ei]))
            off += 1
        else:
            pieces.append(codes_i8[ei])
            off += 2
    return jnp.concatenate(pieces, axis=0), blk_offsets


def _to_signed_storage(codes: jax.Array, scale: jax.Array, zp: jax.Array,
                       bits: float, sym: bool):
    dtype = storage_dtype_for(bits)
    if sym or bits == 1.5:
        return codes.astype(jnp.int8).astype(dtype), scale, zp
    shift = float(1 << (int(bits) - 1)) if bits >= 2 else 1.0
    new_zp = zp + shift * scale
    signed = codes - shift
    return signed.astype(jnp.int8).astype(dtype), scale, new_zp


def quantize_act(a: jax.Array, cfg: QLinearConfig) -> PackedTensor:
    """Per-token (grouped) activation quantization -> signed codes.

    a: [M, K] (or any leading dims + K). Groups along K.
    """
    q = quantize(a, cfg.a_bits, cfg.a_gsize, cfg.a_sym, cfg.a_clip)
    values, scale, zp = _to_signed_storage(q.codes, q.scale, q.zp, cfg.a_bits, cfg.a_sym or cfg.a_bits == 1.5)
    g = a.shape[-1] if cfg.a_gsize == -1 else cfg.a_gsize
    return PackedTensor(values, scale, zp, int(cfg.a_bits), g, cfg.a_sym)


def quantize_weight_kn(w_kn: jax.Array, cfg: QLinearConfig) -> PackedTensor:
    """Quantize a weight stored [.., K, N] with groups along K per column.

    Equivalent grouping to the reference (rows of the [N, K] weight grouped
    along K, ``quant.py:319-359``), transposed into the kernel's B layout.
    scale/zp come out [.., K//g, N].
    """
    w_nk = jnp.swapaxes(w_kn, -1, -2)  # [.., N, K]
    q = quantize(w_nk, cfg.w_bits, cfg.w_gsize, cfg.w_sym, cfg.w_clip)
    eff_sym = cfg.w_sym or cfg.w_bits == 1.5
    values, scale, zp = _to_signed_storage(q.codes, q.scale, q.zp, cfg.w_bits, eff_sym)
    values = jnp.swapaxes(values, -1, -2)          # [.., K, N]
    scale = jnp.swapaxes(scale, -1, -2)            # [.., K//g, N]
    zp = jnp.swapaxes(zp, -1, -2)
    g = w_kn.shape[-2] if cfg.w_gsize == -1 else cfg.w_gsize
    return PackedTensor(values, scale, zp, int(cfg.w_bits), g, cfg.w_sym)


def dequantize_act(p: PackedTensor) -> jax.Array:
    m_shape = p.values.shape
    k = m_shape[-1]
    cg = p.values.astype(jnp.float32).reshape(*m_shape[:-1], k // p.gsize, p.gsize)
    out = cg * p.scale[..., None] + p.zp[..., None]
    return out.reshape(m_shape)


def dequantize_weight_kn(p: PackedTensor) -> jax.Array:
    """[.., K, N] codes + [.., K//g, N] params -> float32 [.., K, N]."""
    v = p.values.astype(jnp.float32)
    k, n = v.shape[-2], v.shape[-1]
    vg = v.reshape(*v.shape[:-2], k // p.gsize, p.gsize, n)
    out = vg * p.scale[..., :, None, :] + p.zp[..., :, None, :]
    return out.reshape(*v.shape[:-2], k, n)


def shard_ragged_mixed(qcat: jax.Array, blk, pf, k: int, ep: int):
    """Global ragged mixed buffer -> per-expert-shard stacked layout.

    ``qcat [R, N]`` (one layer's buffer from :func:`build_ragged_mixed`),
    ``blk``/``pf`` [E]: slice each expert's K/2-unit block(s) out of the
    global buffer and re-concatenate per shard of ``ceil(E/ep)`` contiguous
    experts, padding every shard to the max shard length so the result
    stacks to ``[ep, R_l, N]`` (shardable over a mesh axis). When ``E``
    does not divide ``ep`` (the flagship's 60 experts on a power-of-two
    mesh — reference topology table ``bits_solver.py:636-644``) the tail
    shard(s) get never-routed PHANTOM experts: one zero packed K/2-unit
    each, pointing into the shard's zero padding. Returns (qcat_sharded,
    blk_local [E_pad]) — blk_local offsets are LOCAL to each shard's
    buffer, ready for ``gmm_int8`` per shard; callers must pad
    their ``pf`` arrays to E_pad with 1 (packed) to match.
    """
    import numpy as np

    blk = np.asarray(blk, np.int64)
    pf = np.asarray(pf, np.int64)
    e = blk.shape[0]
    e_local = -(-e // ep)
    e_pad = e_local * ep
    k2 = k // 2
    units = np.concatenate(
        [2 - pf, np.ones(e_pad - e, np.int64)])        # [E_pad] K/2-units
    shard_units = units.reshape(ep, e_local).sum(1)
    r_l = int(shard_units.max()) * k2

    shards, blk_local = [], []
    for s in range(ep):
        pieces, off = [], 0
        for ei in range(s * e_local, (s + 1) * e_local):
            blk_local.append(off)
            if ei < e:
                rows = int(units[ei]) * k2
                pieces.append(
                    qcat[int(blk[ei]) * k2: int(blk[ei]) * k2 + rows])
            off += int(units[ei])
        buf = (jnp.concatenate(pieces, axis=0) if pieces
               else jnp.zeros((0, qcat.shape[1]), qcat.dtype))
        shards.append(jnp.pad(buf, ((0, r_l - buf.shape[0]), (0, 0))))
    return jnp.stack(shards), blk_local


def pack_ragged_stack(q_layers, pf_all):
    """Per-layer int8 code stacks -> the stacked ragged mixed layout.

    ``q_layers``: sequence of [E, K, N] int8 (numpy or jax), ``pf_all``:
    [L][E] packed flags. Returns (qcat [L, R_max, N], blk [L, E], pf
    [L, E]) — the single emission point for the packed storage layout so
    the RTN/GPTQ real quantizers can't drift apart."""
    import numpy as np

    cats, blks = [], []
    for q_l, pf_l in zip(q_layers, pf_all):
        cat, blk = build_ragged_mixed(jnp.asarray(q_l), pf_l)
        cats.append(np.asarray(cat))
        blks.append(blk)
    r_max = max(c.shape[0] for c in cats)
    cats = [np.pad(c, ((0, r_max - c.shape[0]), (0, 0))) for c in cats]
    return (jnp.asarray(np.stack(cats)), jnp.asarray(blks, jnp.int32),
            jnp.asarray(pf_all, jnp.int32))
