"""Headline benchmark: canonical qwen2_moe layer-10 bs8192 MoE FFN GroupGEMM.

Protocol mirrors the reference bench binary (``test.cu`` bench mode,
SURVEY.md §6): Σ2MNK / median-time TFLOPS on the recorded workload —
routed experts AND shared expert, gate_up AND down — with speedup reported
against the *vendor baseline*: for the reference that is the best CUTLASS
grouped-GEMM fp16 tile; here it is XLA bf16 (`jax.lax.ragged_dot` for the
routed groups + dense `jnp.dot` for the shared expert).

Ours: the mixed w4a4+w8a8 layer (even experts w4a4, odd w8a8) as ONE
launch per GEMM — per-row dynamic activation quant, then the Triton int8
grouped kernel (``ops.pallas_gmm.gmm_int8``) with w4 experts nibble-packed
and bit widths as data; the shared expert is a dense int8 dot.

Runs on a GPU only. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "TFLOPS", "vs_baseline": N,
   "platform": ..., "device_kind": ..., "count": N, ...}
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from mxmoe.bench import workloads
from mxmoe.bench.timing import bench_step_chained
from mxmoe.models.layers import shared_int8_dot
from mxmoe.ops import pallas_gmm
from mxmoe.quant.packing import build_ragged_mixed
from mxmoe.quant.qparams import (quantize_act_per_row_bits,
                                 quantize_act_per_token)

# routed-GMM row tile = the alignment of every expert's row group
BENCH_BM = int(os.environ.get("MXMOE_BENCH_BM", "128"))


def _build_fp_operands(wl, key, dtype=jnp.bfloat16):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    lhs = jax.random.uniform(k1, (wl.m_total, wl.k), jnp.float32, -1, 1).astype(dtype)
    rhs = jax.random.uniform(
        k2, (wl.num_experts, wl.k, wl.n), jnp.float32, -1, 1
    ).astype(dtype)
    group_sizes = jnp.array(wl.group_sizes, jnp.int32)
    shared = None
    if wl.shared_m:
        sh_lhs = jax.random.uniform(k3, (wl.shared_m, wl.shared_k), jnp.float32, -1, 1).astype(dtype)
        sh_rhs = jax.random.uniform(k4, (wl.shared_k, wl.shared_n), jnp.float32, -1, 1).astype(dtype)
        shared = (sh_lhs, sh_rhs)
    return lhs, rhs, group_sizes, shared


def _out_scalar(out):
    """Bounded scalar from an output, reading ONE row.

    ``optimization_barrier`` first: it pins the full output as a value —
    XLA can neither dead-code-eliminate the producing kernel nor narrow a
    dot to the sliced row — so every timed op runs and materializes, like
    the reference protocol, while the consumer reads ~nothing."""
    out = jax.lax.optimization_barrier(out)
    return jnp.tanh(jnp.sum(out[0, :8].astype(jnp.float32)) * 1e-3)


def _chain_feedback(outs):
    """Next-iteration carry from this iteration's outputs: ONE scalar per
    workload, read from every output (so none is dead). Iteration i+1
    scales the loop-invariant activations by ``1 + 1e-3·s_i``; the multiply
    fuses into the activation read, so the dependence that serializes the
    chain adds no memory traffic."""
    return {"s": jnp.stack([sum(_out_scalar(o) for o in wl)
                            for wl in outs])}


def _scaled(x, scalar):
    """x · (1 + 1e-3·s) — the chain dependence injection."""
    return x * (1 + 1e-3 * scalar).astype(x.dtype)


def _baseline_step_factory(operands):
    """XLA bf16: ragged_dot for routed experts + dense dot for shared.
    Weights ride the consts jit arg (closing over them would embed ~1 GB
    of HLO literals); only activations flow through the chain carry."""
    consts = [(lhs, rhs, gs, None if sh is None else (sh[0], sh[1]))
              for lhs, rhs, gs, sh in operands]
    state0 = {"s": jnp.zeros((len(operands),), jnp.float32)}

    def step(state, cc):
        outs = []
        for i, (lhs, rhs, gs, sh) in enumerate(cc):
            wl = [jax.lax.ragged_dot(_scaled(lhs, state["s"][i]), rhs, gs,
                                     preferred_element_type=jnp.bfloat16)]
            if sh is not None:
                wl.append(jnp.dot(_scaled(sh[0], state["s"][i]), sh[1],
                                  preferred_element_type=jnp.bfloat16))
            outs.append(wl)
        return _chain_feedback(outs)

    return step, state0, consts


def quantize_mixed(operands, w4_mask_per_wl, bm: int = BENCH_BM):
    """Mixed w4a4+w8a8 operands for ONE launch per workload.

    w4 experts quantize to ±7 codes (scale = max/7) and are nibble-packed
    into the ragged weight buffer; w8 experts keep ±127 int8 codes. Each
    activation row takes its expert's act width (4 or 8 bits) in one quant
    pass. Every expert's rows are padded to a ``bm`` multiple with zero
    rows, so no boundary tile is computed twice — the aligned dispatch
    layout (``MoEImpl.dispatch_align``).

    Returns per workload a dict of arrays: ``lhs``, ``cat``, ``pf``,
    ``blk``, ``wsc``, ``bits``, the padded group sizes ``gs`` and the
    shared ``sl``/``sw``/``ssc``.
    """
    out = []
    for (lhs, rhs, gs, shared), w4_mask in zip(operands, w4_mask_per_wl):
        sizes = np.asarray(gs)
        starts = np.concatenate([[0], np.cumsum(sizes)])
        padded = ((sizes + bm - 1) // bm) * bm
        row_order = np.concatenate([
            np.concatenate([np.arange(starts[e], starts[e + 1]),
                            np.full(padded[e] - sizes[e], -1, np.int64)])
            for e in range(len(sizes))])
        keep = (row_order >= 0)[:, None]
        lhs = jnp.take(lhs, jnp.asarray(np.maximum(row_order, 0)),
                       axis=0) * jnp.asarray(keep, lhs.dtype)
        w = rhs.astype(jnp.float32)
        maxcode = jnp.asarray(np.where(w4_mask, 7.0, 127.0),
                              jnp.float32)[:, None, None]          # [E,1,1]
        wsc = jnp.max(jnp.abs(w), axis=1, keepdims=True) / maxcode
        wq = jnp.round(w / wsc).astype(jnp.int8)
        cat, blk = build_ragged_mixed(wq, w4_mask)
        p = dict(lhs=lhs, cat=cat, pf=jnp.asarray(w4_mask, jnp.int32),
                 blk=jnp.asarray(blk, jnp.int32), wsc=wsc,
                 bits=jnp.asarray(np.repeat(np.where(w4_mask, 4.0, 8.0),
                                            padded), jnp.float32),
                 gs=jnp.asarray(padded, jnp.int32))
        if shared is not None:
            sw = shared[1].astype(jnp.float32)
            ssc = jnp.max(jnp.abs(sw), axis=0, keepdims=True) / 127.0
            p.update(sl=shared[0], sw=jnp.round(sw / ssc).astype(jnp.int8),
                     ssc=ssc)
        out.append(p)
    return out


def mixed_layer_outputs(p, chain=None, bm: int = BENCH_BM):
    """One workload of the headline step: [routed output, shared output],
    launched as the model launches it (traced group sizes).
    ``chain``: the chained-timing scalar folded into the activation reads."""
    def acts(x):
        return x if chain is None else _scaled(x, chain)

    aq, asc = quantize_act_per_row_bits(acts(p["lhs"]), p["bits"])
    routed = pallas_gmm.gmm_int8(aq, asc, p["cat"], p["wsc"], p["gs"],
                                 p["pf"], p["blk"], bm=bm)
    outs = [routed]
    if "sl" in p:
        saq, sasc = quantize_act_per_token(acts(p["sl"]), 8)
        acc = shared_int8_dot(saq, p["sw"])
        outs.append((acc.astype(jnp.float32) * sasc * p["ssc"])
                    .astype(jnp.bfloat16))
    return outs


def _mixed_step_factory(qmix):
    """Chainable step: each iteration's outputs feed the next iteration's
    activation scale, serializing iterations by data dependence."""
    state0 = {"s": jnp.zeros((len(qmix),), jnp.float32)}

    def step(state, cc):
        return _chain_feedback([
            mixed_layer_outputs(p, chain=state["s"][i])
            for i, p in enumerate(cc)])

    return step, state0, qmix


def build_headline(seed: int = 42):
    """(workloads, fp operands, mixed operands, total flops) of the cell."""
    gate_up, down = workloads.qwen2_moe_l10_bs8192()
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    operands = [_build_fp_operands(gate_up, k1), _build_fp_operands(down, k2)]
    masks = [np.arange(wl.num_experts) % 2 == 0 for wl in (gate_up, down)]
    qmix = quantize_mixed(operands, masks)
    return (gate_up, down), operands, qmix, gate_up.flops + down.flops


def main():
    import sys
    import time as _time

    from mxmoe.utils.device import (device_record, enable_compile_cache,
                                    require_gpu)

    require_gpu()
    enable_compile_cache()
    t0 = _time.time()

    def _log(msg):
        print(f"[bench +{_time.time() - t0:.0f}s] {msg}", file=sys.stderr,
              flush=True)

    _, operands, qmix, total_flops = build_headline()

    # the baseline is measured in every run, on this card: cards of one
    # kind differ with their power limit
    bstep, bstate, bconsts = _baseline_step_factory(operands)
    rb = bench_step_chained(bstep, bstate, consts=bconsts,
                            n1=2, n2=5, repeats=2)
    base_ms = rb.median_ms
    _log(f"baseline done: {base_ms:.3f} ms/iter")
    base_tflops = total_flops / (base_ms * 1e-3) / 1e12

    step, state0, mconsts = _mixed_step_factory(qmix)
    ro = bench_step_chained(step, state0, consts=mconsts,
                            n1=4, n2=32, repeats=5, target_s=0.1)
    _log(f"mixed done: {ro.median_ms:.3f} ms/iter")
    ours_tflops = ro.tflops(total_flops)
    band = sorted(total_flops / (s * 1e-3) / 1e12 for s in ro.samples_ms)
    print(json.dumps({
        "metric": "qwen2_moe_l10_bs8192_moe_ffn_mixed_w4a4+w8a8",
        "value": ours_tflops,
        "unit": "TFLOPS",
        "vs_baseline": ours_tflops / base_tflops,
        "band": [band[0], band[-1]],
        "step_ms": ro.median_ms,
        **device_record(),
    }))


if __name__ == "__main__":
    main()
