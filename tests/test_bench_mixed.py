"""The headline bench step (bench.py): mixed w4a4(packed)+w8a8 in one
launch per GEMM, aligned row layout, vs the fake-quant oracle."""

import jax
import jax.numpy as jnp
import numpy as np

import bench as bench_mod
from mxmoe.bench.workloads import GroupGemmWorkload
from mxmoe.ops.gmm import gmm_dense_reference, ragged_to_dense_int8
from mxmoe.quant.qparams import (quantize_act_per_row_bits,
                                 quantize_act_per_token)

WL = GroupGemmWorkload("t", group_sizes=(40, 24, 56, 8, 72, 56), k=128, n=128,
                       shared_m=32, shared_k=128, shared_n=64)
MASK = np.array([True, False, True, False, True, False])


def _build(bm, seed=0):
    operands = [bench_mod._build_fp_operands(WL, jax.random.PRNGKey(seed),
                                             dtype=jnp.float32)]
    return operands, bench_mod.quantize_mixed(operands, [MASK], bm=bm)[0]


def test_mixed_bucketed_matches_oracle():
    """Routed and shared outputs of one headline step match the dense
    reference on the dequantized operands (w4 experts nibble-packed in
    the ragged buffer, w8 experts int8)."""
    bm = 16
    _, p = _build(bm)
    routed, shared = bench_mod.mixed_layer_outputs(p, bm=bm)
    aq, asc = quantize_act_per_row_bits(p["lhs"], p["bits"])
    wq = ragged_to_dense_int8(p["cat"], p["pf"], p["blk"], WL.k)
    ref = gmm_dense_reference(aq.astype(jnp.float32) * asc,
                              wq.astype(jnp.float32) * p["wsc"],
                              p["gs"])
    np.testing.assert_allclose(np.asarray(routed, np.float32),
                               np.asarray(ref), rtol=1e-2, atol=1e-2)
    saq, sasc = quantize_act_per_token(p["sl"], 8)
    sref = (saq.astype(jnp.float32) * sasc) @ (p["sw"].astype(jnp.float32)
                                              * p["ssc"])
    np.testing.assert_allclose(np.asarray(shared, np.float32),
                               np.asarray(sref), rtol=1e-2, atol=1e-2)
    # w4 experts hold ±7 codes in half the rows of an int8 expert
    assert p["cat"].shape[0] == (MASK.sum() * WL.k // 2
                                 + (~MASK).sum() * WL.k)
    assert np.abs(np.asarray(wq)[MASK]).max() <= 7


def test_mixed_aligned_layout_properties():
    """Aligned layout: every group size is a bm multiple, padding rows are
    zero, and real rows are preserved in order."""
    bm = 16
    _, p = _build(bm, seed=1)
    gs = np.asarray(p["gs"])
    assert all(g % bm == 0 for g in gs)
    lhs = np.asarray(p["lhs"])
    off = 0
    for g_pad, g_real in zip(gs, WL.group_sizes):
        assert np.all(lhs[off + g_real: off + g_pad] == 0)
        assert np.any(lhs[off: off + g_real] != 0)
        off += g_pad
    bits = np.asarray(p["bits"])
    starts = np.concatenate([[0], np.cumsum(gs)])
    for e in range(len(MASK)):
        assert np.all(bits[starts[e]:starts[e + 1]] == (4.0 if MASK[e] else 8.0))


def test_onelaunch_aligned_matches_unaligned_bitwise():
    """Padding every expert's rows to a bm multiple only inserts zero rows:
    each expert's real rows come out bitwise-identical to a layout whose
    groups were padded to a different bm."""
    outs = {}
    for bm in (8, 16):
        _, p = _build(bm, seed=2)
        outs[bm] = (np.asarray(bench_mod.mixed_layer_outputs(
            p, bm=bm)[0], np.float32), np.asarray(p["gs"]))
    gs = np.array(WL.group_sizes)
    (o8, g8), (o16, g16) = outs[8], outs[16]
    s8 = np.concatenate([[0], np.cumsum(g8)])
    s16 = np.concatenate([[0], np.cumsum(g16)])
    for e in range(len(gs)):
        np.testing.assert_array_equal(o8[s8[e]: s8[e] + gs[e]],
                                      o16[s16[e]: s16[e] + gs[e]])
