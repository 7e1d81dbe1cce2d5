"""Grouped-matmul kernels vs oracles.

The analog of the reference's `check` mode (``test.cu:101-158``): every
kernel is compared element-wise against a reference executed on the same
(fake-quantized) operands, so only kernel arithmetic is under test. Here
the Triton int8 kernel runs in interpret mode; ``tests/test_gpu.py`` runs
it compiled on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mxmoe.ops import gmm as gmm_ops
from mxmoe.ops import pallas_gmm
from mxmoe.ops.gmm import gmm_dense_reference
from mxmoe.quant.packing import build_ragged_mixed, pack_int4_halves

INTERPRET = True      # the Triton kernel's CPU form


def _rand_groups(key, e, total):
    """Random nonnegative group sizes summing to total, some zeros."""
    w = jax.random.dirichlet(key, jnp.ones(e) * 0.5)
    sizes = jnp.floor(w * total).astype(jnp.int32)
    sizes = sizes.at[0].add(total - jnp.sum(sizes))
    return sizes


def test_group_metadata_basic():
    gs = jnp.array([3, 0, 5, 8], jnp.int32)
    m, bm = 16, 4
    meta = pallas_gmm.make_group_metadata(gs, m, bm)
    gids = np.asarray(meta.group_ids)
    mtids = np.asarray(meta.m_tile_ids)
    n = int(meta.num_logical)
    # groups: rows [0,3) -> tile 0; [3,3) empty; [3,8) -> tiles 0,1; [8,16) -> tiles 2,3
    assert n == 5
    assert list(gids[:n]) == [0, 2, 2, 3, 3]
    assert list(mtids[:n]) == [0, 0, 1, 2, 3]
    # padding is clamped to valid ids
    assert (gids >= 0).all() and (gids < 4).all()
    assert (mtids >= 0).all() and (mtids < 4).all()
    # m_tile_ids nondecreasing over active entries
    assert (np.diff(mtids[:n]) >= 0).all()


@pytest.mark.parametrize("m,k,n,e", [(256, 128, 256, 8), (384, 256, 128, 5)])
def test_gmm_bf16_matches_oracle(m, k, n, e):
    """Unquantized experts: the 'auto' backend (ragged_dot on the CPU)."""
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    lhs = jax.random.normal(k1, (m, k), jnp.float32)
    rhs = jax.random.normal(k2, (e, k, n), jnp.float32)
    gs = _rand_groups(k3, e, m)
    out = gmm_ops.gmm(lhs, rhs, gs)
    ref = gmm_dense_reference(lhs, rhs, gs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-2, atol=2e-2)


def test_gmm_bf16_zero_and_tiny_groups():
    m, k, n, e = 128, 128, 128, 6
    key = jax.random.PRNGKey(1)
    lhs = jax.random.normal(key, (m, k), jnp.float32)
    rhs = jax.random.normal(key, (e, k, n), jnp.float32)
    gs = jnp.array([0, 1, 0, 63, 0, 64], jnp.int32)
    out = gmm_ops.gmm(lhs, rhs, gs)
    ref = gmm_dense_reference(lhs, rhs, gs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-2, atol=2e-2)


def _int8_operands(key, m, k, n, e, w4=False):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    hi = 8 if w4 else 128
    aq = jax.random.randint(k1, (m, k), -127, 128, jnp.int8)
    asc = jax.random.uniform(k2, (m, 1), jnp.float32, 0.001, 0.02)
    wq = jax.random.randint(k3, (e, k, n), -hi + (not w4), hi, jnp.int8)
    wsc = jax.random.uniform(k4, (e, 1, n), jnp.float32, 0.001, 0.02)
    return aq, asc, wq, wsc


def test_gmm_w8a8_matches_fakequant_oracle():
    m, k, n, e = 256, 256, 256, 4
    key = jax.random.PRNGKey(2)
    k1, k2, k3 = jax.random.split(key, 3)
    a = jax.random.normal(k1, (m, k), jnp.float32)
    w = jax.random.normal(k2, (e, k, n), jnp.float32)
    gs = _rand_groups(k3, e, m)
    a_scale = jnp.max(jnp.abs(a), axis=-1, keepdims=True) / 127.0
    a_q = jnp.round(a / a_scale).astype(jnp.int8)
    w_scale = jnp.max(jnp.abs(w), axis=1, keepdims=True) / 127.0   # [e,1,n]
    w_q = jnp.round(w / w_scale).astype(jnp.int8)

    out = pallas_gmm.gmm_w8a8(a_q, a_scale, w_q, w_scale, gs, bm=64, bn=128,
                              out_dtype=jnp.float32, interpret=INTERPRET)
    ref = gmm_dense_reference(a_q.astype(jnp.float32) * a_scale,
                              w_q.astype(jnp.float32) * w_scale, gs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("gsize,sym", [(128, True), (64, False)])
def test_gmm_weight_only_matches_fakequant_oracle(gsize, sym):
    m, k, n, e = 128, 256, 128, 3
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    a = jax.random.normal(k1, (m, k), jnp.float32)
    w = jax.random.normal(k2, (e, k, n), jnp.float32)
    gs = _rand_groups(k3, e, m)

    from mxmoe.quant.packing import quantize_weight_kn, dequantize_weight_kn
    from mxmoe.quant.schemes import QLinearConfig

    cfg = QLinearConfig(w_bits=4, w_gsize=gsize, w_sym=sym, a_bits=16)
    packed = quantize_weight_kn(w, cfg)
    out = gmm_ops.gmm_dequant(a, packed.values.astype(jnp.int8),
                              packed.scale, packed.zp, gs,
                              out_dtype=jnp.float32)
    ref = gmm_dense_reference(a, dequantize_weight_kn(packed), gs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-3, atol=2e-3)


def test_gmm_w4a8_packed_matches_unpacked():
    """All-packed [E, K/2, N] stack == the int8-stored stack, bitwise."""
    m, k, n, e = 128, 256, 128, 3
    aq, asc, wq, wsc = _int8_operands(jax.random.PRNGKey(7), m, k, n, e, w4=True)
    gs = _rand_groups(jax.random.PRNGKey(8), e, m)
    packed = pack_int4_halves(wq)
    assert packed.shape == (e, k // 2, n)
    got = pallas_gmm.gmm_w4a8_packed(aq, asc, packed, wsc, gs, bm=64, bn=128,
                                     out_dtype=jnp.float32, interpret=INTERPRET)
    want = pallas_gmm.gmm_w8a8(aq, asc, wq, wsc, gs, bm=64, bn=128,
                               out_dtype=jnp.float32, interpret=INTERPRET)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_gmm_w8a8_grouped_matches_fakequant_oracle():
    m, k, n, e, g = 128, 256, 128, 3, 64
    key = jax.random.PRNGKey(9)
    k1, k2, k3 = jax.random.split(key, 3)
    a = jax.random.normal(k1, (m, k), jnp.float32)
    w = jax.random.normal(k2, (e, k, n), jnp.float32)
    gs = _rand_groups(k3, e, m)
    ag = a.reshape(m, k // g, g)
    a_scale = jnp.max(jnp.abs(ag), axis=-1) / 127.0           # [m, k//g]
    a_q = jnp.round(ag / a_scale[..., None]).reshape(m, k).astype(jnp.int8)
    wg = w.reshape(e, k // g, g, n)
    w_scale = jnp.max(jnp.abs(wg), axis=2) / 127.0            # [e, k//g, n]
    w_q = jnp.round(wg / w_scale[:, :, None, :]).reshape(e, k, n).astype(jnp.int8)

    out = gmm_ops.gmm_w8a8_grouped(a_q, a_scale, w_q, w_scale, gs,
                                   out_dtype=jnp.float32)
    a_fq = (a_q.reshape(m, k // g, g).astype(jnp.float32) * a_scale[..., None]).reshape(m, k)
    w_fq = (w_q.reshape(e, k // g, g, n).astype(jnp.float32) * w_scale[:, :, None, :]).reshape(e, k, n)
    ref = gmm_dense_reference(a_fq, w_fq, gs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_gmm_w8a8_asym_matches_fakequant_oracle():
    m, k, n, e = 128, 256, 128, 3
    key = jax.random.PRNGKey(12)
    k1, k2, k3 = jax.random.split(key, 3)
    a = jax.random.normal(k1, (m, k), jnp.float32)
    w = jax.random.normal(k2, (e, k, n), jnp.float32) + 0.5   # asym-friendly
    gs = _rand_groups(k3, e, m)

    from mxmoe.quant.packing import quantize_weight_kn, dequantize_weight_kn
    from mxmoe.quant.qparams import quantize_act_per_token
    from mxmoe.quant.schemes import QLinearConfig

    cfg = QLinearConfig(w_bits=8, w_gsize=-1, w_sym=False, a_bits=8)
    p = quantize_weight_kn(w, cfg)
    aq, asc = quantize_act_per_token(a, 8)
    got = gmm_ops.gmm_w8a8_grouped(aq, asc, p.values, p.scale, gs,
                                   rhs_zp=p.zp, out_dtype=jnp.float32)
    ref = gmm_dense_reference(aq.astype(jnp.float32) * asc,
                              dequantize_weight_kn(p), gs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("gsize,sym", [(64, True), (32, False)])
def test_gmm_weight_only_packed_matches_unpacked(gsize, sym):
    """Nibble-packed w4a16 launcher == int8-stored weight-only launcher."""
    from mxmoe.bench.kernels import make_launcher

    m, k, n, e = 128, 256, 128, 3
    key = jax.random.PRNGKey(11)
    k1, k2, k3 = jax.random.split(key, 3)
    a = jax.random.normal(k1, (m, k), jnp.float32)
    w = jax.random.normal(k2, (e, k, n), jnp.float32)
    gs = _rand_groups(k3, e, m)

    from mxmoe.quant.packing import quantize_weight_kn
    from mxmoe.quant.schemes import QLinearConfig

    cfg = QLinearConfig(w_bits=4, w_gsize=gsize, w_sym=sym, a_bits=16)
    packed = quantize_weight_kn(w, cfg)
    wq = packed.values.astype(jnp.int8)
    ops = {"lhs": a, "rhs_sc": packed.scale, "rhs_zp": packed.zp, "gs": gs}
    name = cfg.scheme_name
    ref = make_launcher(name)({**ops, "rhs": wq})
    got = make_launcher(name + "_packed")({**ops, "rhs": pack_int4_halves(wq)})
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_gmm_mixed_packed_matches_int8_all_modes():
    """ONE-launch mixed packed/int8 GMM (ragged weight buffer, per-expert
    nibble packing) is bitwise-identical to the all-int8 launch for
    unaligned and bm-aligned row layouts, eagerly and under jit with
    traced sizes — w<=4 experts stream half the weight
    bytes in the SAME launch (reference storage families
    ``cta_gemm.cuh:112-286``, fused dispatch ``hz_fused.cuh:14-127``)."""
    rng = np.random.default_rng(0)
    e_, k_, n_ = 6, 128, 192
    sizes = [96, 0, 128, 33, 257, 64]
    m = sum(sizes)
    pflags = np.array([1, 0, 0, 1, 1, 0], np.int32)
    wq = np.zeros((e_, k_, n_), np.int8)
    for ei in range(e_):
        hi = 8 if pflags[ei] else 128
        wq[ei] = rng.integers(-hi, hi, size=(k_, n_)).astype(np.int8)
    aq = jnp.asarray(rng.integers(-128, 128, size=(m, k_)), jnp.int8)
    asc = jnp.asarray(rng.uniform(0.5, 2, (m, 1)), jnp.float32)
    wsc = jnp.asarray(rng.uniform(0.5, 2, (e_, 1, n_)), jnp.float32)
    gs = jnp.asarray(sizes, jnp.int32)

    rhs_cat, blk_off = build_ragged_mixed(jnp.asarray(wq), pflags)
    # the ragged buffer realizes the byte budget exactly: K/2 rows per
    # packed expert, K per int8 expert
    assert rhs_cat.shape[0] == sum(
        k_ // 2 if pflags[ei] else k_ for ei in range(e_))
    pf, blk = jnp.asarray(pflags), jnp.asarray(blk_off, jnp.int32)
    kw = dict(bm=64, bn=64, interpret=INTERPRET)

    ref = pallas_gmm.gmm_w8a8(aq, asc, jnp.asarray(wq), wsc, gs, **kw)
    out_dyn = pallas_gmm.gmm_int8(aq, asc, rhs_cat, wsc, gs, pf, blk, **kw)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(out_dyn))

    sizes_al = [64, 0, 128, 64, 256, 64]
    m2 = sum(sizes_al)
    aq2 = jnp.asarray(rng.integers(-128, 128, size=(m2, k_)), jnp.int8)
    asc2 = jnp.asarray(rng.uniform(0.5, 2, (m2, 1)), jnp.float32)
    gs2 = jnp.asarray(sizes_al, jnp.int32)
    ref2 = pallas_gmm.gmm_w8a8(aq2, asc2, jnp.asarray(wq), wsc, gs2, **kw)
    out_al = pallas_gmm.gmm_int8(aq2, asc2, rhs_cat, wsc, gs2, pf, blk, **kw)
    np.testing.assert_array_equal(np.asarray(ref2), np.asarray(out_al))

    f = jax.jit(lambda a, s, rc, ws, g, p, b: pallas_gmm.gmm_int8(
        a, s, rc, ws, g, p, b, **kw))
    np.testing.assert_array_equal(
        np.asarray(ref), np.asarray(f(aq, asc, rhs_cat, wsc, gs, pf, blk)))


def test_gmm_int8_mixtral_scale_k():
    """Mixtral-scale K (14336): the K loop walks 128-row weight blocks
    inside each program, so no tile grows with K; exact vs the oracle."""
    rng = np.random.default_rng(3)
    e_, k_, n_ = 4, 14336, 64
    pf = np.array([1, 0, 1, 0], np.int32)
    wq = np.zeros((e_, k_, n_), np.int8)
    for ei in range(e_):
        hi = 8 if pf[ei] else 128
        wq[ei] = rng.integers(-hi, hi, (k_, n_)).astype(np.int8)
    cat, blk = build_ragged_mixed(jnp.asarray(wq), pf)
    sizes = [16, 8, 16, 8]
    m = sum(sizes)
    aq = jnp.asarray(rng.integers(-128, 128, (m, k_)), jnp.int8)
    gs = jnp.asarray(sizes, jnp.int32)
    args = (aq, jnp.ones((m, 1)), cat, jnp.ones((e_, 1, n_)), gs,
            jnp.asarray(pf), jnp.asarray(blk, jnp.int32))
    got = pallas_gmm.gmm_int8(*args, bm=16, out_dtype=jnp.int32,
                              interpret=INTERPRET)
    ref = pallas_gmm.gmm_int8_reference(*args, out_dtype=None)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


# ---------------------------------------------------------------------------
# The Triton int8 kernel vs its exact int32 oracle, over every layout
# ---------------------------------------------------------------------------

_GROUPS = {
    # real rows per expert (E = 5)
    "zero": (24, 0, 40, 0, 17),          # empty groups between live ones
    "tiny": (1, 2, 1, 0, 3),             # decode-sized groups, one m-tile
    "straddle": (13, 21, 9, 30, 7),      # every boundary inside a row tile
}


@pytest.mark.parametrize("stacked", [False, True], ids=["layer", "stacked"])
@pytest.mark.parametrize("groups", sorted(_GROUPS))
@pytest.mark.parametrize("aligned", [False, True], ids=["masked", "aligned"])
@pytest.mark.parametrize("layout", ["int8", "packed", "mixed"])
def test_gmm_int8_matches_int32_oracle(layout, aligned, groups, stacked):
    """Raw int32 accumulators and the scaled output of the one kernel
    equal the XLA oracle exactly: int8-stored, all-packed and mixed ragged
    weights; unaligned ("masked") and aligned (every group padded to bm,
    ``MoEImpl.dispatch_align``) row layouts; zero / tiny / straddling groups; weights
    of one layer or of a layer stack addressed through ``group_base``."""
    e, k, n, bm, layers = 5, 64, 32, 16, 3
    sizes = _GROUPS[groups]
    if aligned:
        sizes = tuple(-(-s // bm) * bm for s in sizes)
    m = sum(sizes)
    rng = np.random.default_rng(len(groups) + 7 * aligned)
    pf = {"int8": [0] * e, "packed": [1] * e, "mixed": [1, 0, 0, 1, 0]}[layout]
    cats, blks, wscs = [], [], []
    for _ in range(layers if stacked else 1):
        codes = np.stack([rng.integers(-8 if p else -127, 8 if p else 128,
                                       (k, n)) for p in pf]).astype(np.int8)
        cat, blk = build_ragged_mixed(jnp.asarray(codes), pf)
        cats.append(np.asarray(cat))
        blks.append(np.asarray(blk))
        wscs.append(rng.uniform(0.01, 0.02, (e, 1, n)).astype(np.float32))
    layer = len(cats) - 1 if stacked else 0
    units = cats[0].shape[0] // (k // 2)
    rhs = jnp.asarray(np.concatenate(cats))
    wsc = jnp.asarray(np.concatenate(wscs))
    blk = jnp.asarray(blks[layer] + layer * units, jnp.int32)
    aq = jnp.asarray(rng.integers(-127, 128, (m, k)), jnp.int8)
    asc = jnp.asarray(rng.uniform(0.01, 0.02, (m, 1)), jnp.float32)
    gs = jnp.asarray(sizes, jnp.int32)
    args = (aq, asc, rhs, wsc, gs, jnp.asarray(pf, jnp.int32), blk)
    kw = dict(group_base=layer * e)
    launch = dict(bm=bm, bn=16, bk=16, interpret=INTERPRET, **kw)

    acc = pallas_gmm.gmm_int8(*args, out_dtype=jnp.int32, **launch)
    want = pallas_gmm.gmm_int8_reference(*args, out_dtype=None, **kw)
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(want))
    out = pallas_gmm.gmm_int8(*args, out_dtype=jnp.float32, **launch)
    ref = pallas_gmm.gmm_int8_reference(*args, out_dtype=jnp.float32, **kw)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_ragged_to_dense_int8_roundtrip():
    """The XLA unpack of the ragged buffer returns the original codes."""
    rng = np.random.default_rng(4)
    pf = np.array([1, 0, 1, 1, 0], np.int32)
    codes = np.stack([rng.integers(-8 if p else -128, 8 if p else 128,
                                   (32, 24)) for p in pf]).astype(np.int8)
    cat, blk = build_ragged_mixed(jnp.asarray(codes), pf)
    back = gmm_ops.ragged_to_dense_int8(cat, jnp.asarray(pf),
                                        jnp.asarray(blk, jnp.int32), 32)
    np.testing.assert_array_equal(np.asarray(back), codes)


def test_offsets_overflow_flags_only_the_2_to_4_gib_band():
    f = pallas_gmm.offsets_overflow
    sds = jax.ShapeDtypeStruct
    assert not f(sds((2**20, 2**10), jnp.int8))          # 1 GiB
    assert f(sds((3 * 2**20, 2**10), jnp.int8))          # 3 GiB: wraps
    assert not f(sds((5 * 2**20, 2**10), jnp.int8))      # 5 GiB: 64-bit
    # offsets count elements: 3 GiB of f32 is < 2**31 elements
    assert not f(sds((3 * 2**28,), jnp.float32))


# ---------------------------------------------------------------------------
# FLEX mixed path: per-expert (gsize, sym) as data, plain XLA
# ---------------------------------------------------------------------------

def _flex_fixture(seed=0, m_sizes=(16, 9, 0, 23), k=256, n=128, gsize=64,
                  schemes=None):
    """Per-expert mixed schemes incl. grouped + asym; returns operands for
    the flex kernels plus a float64 dequant oracle."""
    from mxmoe.quant.packing import quantize_weight_kn, dequantize_weight_kn
    from mxmoe.quant.qparams import quantize_act_rows_flex
    from mxmoe.quant.schemes import QLinearConfig

    if schemes is None:
        schemes = [
            QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True, a_bits=8),
            QLinearConfig(w_bits=4, w_gsize=gsize, w_sym=False, a_bits=4,
                          a_gsize=gsize),
            QLinearConfig(w_bits=8, w_gsize=gsize, w_sym=True, a_bits=8,
                          a_gsize=gsize),
            QLinearConfig(w_bits=4, w_gsize=-1, w_sym=True, a_bits=8),
        ]
    e = len(m_sizes)
    g = k // gsize
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    m = sum(m_sizes)
    x = jax.random.normal(k1, (m, k), jnp.float32)
    w = jax.random.normal(k2, (e, k, n), jnp.float32) * 0.1

    wq = np.zeros((e, k, n), np.int8)
    sc = np.zeros((e, g, n), np.float32)
    zp = np.zeros((e, g, n), np.float32)
    w_deq = np.zeros((e, k, n), np.float64)
    for ei, c in enumerate(schemes):
        p = quantize_weight_kn(w[ei][None], c)
        wq[ei] = np.asarray(p.values[0])
        reps = g if c.w_gsize == -1 else 1
        sc[ei] = np.repeat(np.asarray(p.scale[0]), reps, axis=0)
        zp[ei] = np.repeat(np.asarray(p.zp[0]), reps, axis=0)
        w_deq[ei] = np.asarray(dequantize_weight_kn(p)[0])

    sizes = jnp.asarray(m_sizes, jnp.int32)
    row_e = np.repeat(np.arange(e), m_sizes)
    bits = jnp.asarray([float(schemes[i].a_bits) for i in row_e])
    gflags = jnp.asarray([int(schemes[i].a_gsize != -1) for i in row_e],
                         jnp.int32)
    aq, asc = quantize_act_rows_flex(x, bits, gflags, gsize)

    # float64 oracle on the dequantized operands, per expert
    a_deq = (np.asarray(aq, np.float64).reshape(m, g, gsize)
             * np.asarray(asc, np.float64)[..., None]).reshape(m, k)
    ref = np.zeros((m, n), np.float64)
    off = 0
    for ei, sz in enumerate(m_sizes):
        ref[off:off + sz] = a_deq[off:off + sz] @ w_deq[ei]
        off += sz
    return dict(x=x, aq=aq, asc=asc, wq=jnp.asarray(wq), sc=jnp.asarray(sc),
                zp=jnp.asarray(zp), sizes=sizes, ref=ref, gsize=gsize,
                schemes=schemes, row_e=row_e, bits=bits, gflags=gflags)


def test_gmm_grouped_flex_zp_matches_oracle():
    """One product over a mix of {per-channel sym, grouped asym, grouped
    sym, per-channel w4}: replicated scales + the zero-point term serve the
    reference fused kernel's full w×a scheme domain
    (compose_kernel.py:47-57)."""
    c = _flex_fixture()
    out = gmm_ops.gmm_w8a8_grouped(c["aq"], c["asc"], c["wq"], c["sc"],
                                   c["sizes"], rhs_zp=c["zp"],
                                   out_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(out), c["ref"], rtol=2e-5,
                               atol=2e-5)


def test_gmm_mixed_packed_flex_matches_grouped():
    """PACKED flex storage (w<=4 experts nibble-packed in the ragged
    buffer) unpacks to exactly the int8-stored codes, so the grouped
    product is bitwise-identical."""
    c = _flex_fixture()
    pf = [int(s.w_bits <= 4) for s in c["schemes"]]
    qcat, blk = build_ragged_mixed(c["wq"], pf)
    k = c["wq"].shape[1]
    wq = gmm_ops.ragged_to_dense_int8(qcat, jnp.asarray(pf, jnp.int32),
                                      jnp.asarray(blk, jnp.int32), k)
    kw = dict(rhs_zp=c["zp"], out_dtype=jnp.float32)
    ref = gmm_ops.gmm_w8a8_grouped(c["aq"], c["asc"], c["wq"], c["sc"],
                                   c["sizes"], **kw)
    out = gmm_ops.gmm_w8a8_grouped(c["aq"], c["asc"], wq, c["sc"],
                                   c["sizes"], **kw)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_gmm_mixed_wo_wxa_flex_matches_oracle():
    """The reference's literal second hand instance — w4a16 g128 (asym
    weight-only) + w8a8 per-channel — in ONE product
    (hz_fused.cuh:14-445 instance _89)."""
    from mxmoe.quant.schemes import QLinearConfig

    gsize = 64
    schemes = [
        QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True, a_bits=8),
        QLinearConfig(w_bits=4, w_gsize=gsize, w_sym=False, a_bits=16),
        QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True, a_bits=8),
        QLinearConfig(w_bits=4, w_gsize=gsize, w_sym=False, a_bits=16),
    ]
    c = _flex_fixture(schemes=schemes)
    m, k = c["x"].shape
    row_a16 = jnp.asarray([s.a_bits >= 16 for s in
                           (c["schemes"][i] for i in c["row_e"])])
    out = gmm_ops.gmm_mixed_wo_wxa(
        c["x"].astype(jnp.float32), c["aq"], c["asc"], c["wq"], c["sc"],
        row_a16, c["sizes"], rhs_zp=c["zp"], out_dtype=jnp.float32)
    # oracle: a16 experts use the raw activations against dequant weights
    ref = np.array(c["ref"])
    off = 0
    xs = np.asarray(c["x"], np.float64)
    for ei, sz in enumerate(np.bincount(c["row_e"], minlength=4)):
        if c["schemes"][ei].a_bits >= 16 and sz:
            wd = (np.asarray(c["wq"][ei], np.float64).reshape(-1, c["gsize"], ref.shape[1])
                  * np.asarray(c["sc"][ei], np.float64)[:, None, :]
                  + np.asarray(c["zp"][ei], np.float64)[:, None, :]).reshape(k, -1)
            ref[off:off + sz] = xs[off:off + sz] @ wd
        off += sz
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-5, atol=2e-5)


def test_gmm_mixed_packed_flex_straddle_matches_grouped():
    """K/2 NOT group-aligned (qwen2_moe down: K=1408, g=128 -> 704 % 128
    != 0): the ragged unpack keeps every code in place, so the grouped
    product is still bitwise-identical to the int8-stored one."""
    # K = 352, g = 32 -> K/2 = 176 = 5.5 groups (same 0.5-group straddle
    # geometry as qwen2_moe's 1408/128)
    c = _flex_fixture(k=352, gsize=32, m_sizes=(16, 9, 3, 23))
    pf = [int(s.w_bits <= 4) for s in c["schemes"]]
    qcat, blk = build_ragged_mixed(c["wq"], pf)
    kw = dict(rhs_zp=c["zp"], out_dtype=jnp.float32)
    ref = gmm_ops.gmm_w8a8_grouped(c["aq"], c["asc"], c["wq"], c["sc"],
                                   c["sizes"], **kw)
    np.testing.assert_allclose(np.asarray(ref), c["ref"], rtol=2e-5,
                               atol=2e-5)
    wq = gmm_ops.ragged_to_dense_int8(qcat, jnp.asarray(pf, jnp.int32),
                                      jnp.asarray(blk, jnp.int32), 352)
    out = gmm_ops.gmm_w8a8_grouped(c["aq"], c["asc"], wq, c["sc"],
                                   c["sizes"], **kw)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_layer_stacked_group_base_matches_per_layer():
    """gmm_w8a8 over a [L*E, K, N] stack with group_base = l*E equals the
    per-layer-slice launch bitwise, for every layer (the decode scan
    passes stacked weights as loop constants — layers.split_expert_stack —
    because slicing them into a kernel operand copies them)."""
    L, E, K, N, M = 3, 4, 64, 64, 48
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(11), 3)
    wq = jax.random.randint(k1, (L * E, K, N), -127, 128, jnp.int8)
    wsc = jax.random.uniform(k2, (L * E, 1, N), jnp.float32, 0.01, 0.02)
    aq = jax.random.randint(k3, (M, K), -127, 128, jnp.int8)
    asc = jax.random.uniform(k1, (M, 1), jnp.float32, 0.01, 0.02)
    gs = jnp.asarray([13, 0, 20, M - 33], jnp.int32)
    for l in range(L):
        ref = pallas_gmm.gmm_w8a8(
            aq, asc, wq[l * E:(l + 1) * E], wsc[l * E:(l + 1) * E], gs,
            bm=16, bn=32, interpret=INTERPRET)
        got = pallas_gmm.gmm_w8a8(
            aq, asc, wq, wsc, gs, bm=16, bn=32, interpret=INTERPRET,
            group_base=jnp.int32(l * E))
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_layer_stacked_mixed_packed_matches_per_layer():
    """gmm_int8 over the layer-global ragged buffer (stacked cat,
    layer-global blk offsets, stacked scales) == the per-layer launch."""
    L, E, K, N, M = 2, 4, 64, 64, 32
    rng = np.random.default_rng(5)
    pf = np.asarray([1, 0, 1, 0], np.int32)
    cats, blks, scs = [], [], []
    for l in range(L):
        codes = rng.integers(-7, 8, (E, K, N)).astype(np.int8)
        cat, blk = build_ragged_mixed(jnp.asarray(codes), pf)
        cats.append(np.asarray(cat))
        blks.append(blk)
        scs.append(rng.uniform(0.01, 0.02, (E, 1, N)).astype(np.float32))
    cat_all = jnp.asarray(np.concatenate(cats, axis=0))
    sc_all = jnp.asarray(np.concatenate(scs, axis=0))
    units = cats[0].shape[0] // (K // 2)
    aq = jnp.asarray(rng.integers(-7, 8, (M, K)), jnp.int8)
    asc = jnp.asarray(rng.uniform(0.01, 0.02, (M, 1)), jnp.float32)
    gs = jnp.asarray([5, 11, 0, M - 16], jnp.int32)
    pfd = jnp.asarray(pf)
    for l in range(L):
        ref = pallas_gmm.gmm_int8(
            aq, asc, jnp.asarray(cats[l]), jnp.asarray(scs[l]), gs, pfd,
            jnp.asarray(blks[l], jnp.int32), bm=16, bn=32,
            interpret=INTERPRET)
        got = pallas_gmm.gmm_int8(
            aq, asc, cat_all, sc_all, gs, pfd,
            jnp.asarray(blks[l], jnp.int32) + l * units, bm=16, bn=32,
            interpret=INTERPRET, group_base=jnp.int32(l * E))
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


# ---------------------------------------------------------------------------
# The float grouped product (the same kernel, unscaled) vs its oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stacked", [False, True], ids=["layer", "stacked"])
@pytest.mark.parametrize("groups", sorted(_GROUPS))
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32],
                         ids=["bf16", "f32"])
def test_gmm_float_matches_oracle(dtype, groups, stacked):
    """``gmm_float`` (interpret mode) equals the one-hot oracle on the same
    operands: f32 accumulation of bf16 products, f32 operands at full
    precision; zero / tiny / straddling groups; one layer or a layer stack
    addressed through ``group_base``."""
    e, k, n, layers = 5, 64, 32, 3
    sizes = _GROUPS[groups]
    m = sum(sizes)
    rng = np.random.default_rng(len(groups))
    lhs = jnp.asarray(rng.normal(size=(m, k)), dtype)
    rhs = jnp.asarray(rng.normal(size=((layers if stacked else 1) * e, k, n)),
                      dtype)
    base = (layers - 1) * e if stacked else 0
    gs = jnp.asarray(sizes, jnp.int32)
    got = pallas_gmm.gmm_float(
        lhs, rhs, gs, group_base=base, out_dtype=jnp.float32,
        tiles=dict(bm=16, bn=16, bk=16, num_warps=4, num_stages=3),
        interpret=INTERPRET)
    ref = gmm_dense_reference(lhs.astype(jnp.float32),
                              rhs[base:base + e].astype(jnp.float32), gs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["auto", "ragged_dot", "dense"])
def test_gmm_backends_agree(backend):
    """Every ``ops.gmm.gmm`` backend computes the same grouped product
    ('auto' is ragged_dot here and ``gmm_float`` on the card, where
    tests/test_gpu.py checks it)."""
    m, k, n, e = 96, 128, 64, 6
    rng = np.random.default_rng(5)
    lhs = jnp.asarray(rng.normal(size=(m, k)), jnp.float32)
    rhs = jnp.asarray(rng.normal(size=(e, k, n)), jnp.float32)
    gs = jnp.asarray([30, 0, 1, 40, 0, 25], jnp.int32)
    got = gmm_ops.gmm(lhs, rhs, gs, backend=backend)
    ref = gmm_dense_reference(lhs, rhs, gs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("k,n,ok", [(40, 64, False), (64, 40, False),
                                    (1408, 2048, True), (2048, 2816, True)])
def test_gmm_float_supported_widths(k, n, ok):
    """The power-of-two blocks tile K/2 and N only with a 16 divisor;
    other widths keep ragged_dot on the card."""
    assert pallas_gmm.float_supported(k, n) == ok
