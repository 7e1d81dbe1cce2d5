"""Smoke test of the main path on the GPU: kernel, headline layer, serving.

    python chip_smoke.py              # one GPU: phases 1-5
    python chip_smoke.py --devices 4  # four GPUs: the expert-parallel Engine

Everything runs in this one process (a second JAX process could not get
the card's memory):

  1. device  — JAX must see a GPU; its kind and count, and the card's name
               and power limit from nvidia-smi.
  2. kernels — the Triton grouped kernels at the headline widths
               (qwen2_moe layer 10, bs8192: gate_up K=2048 N=2816, down
               K=1408 N=2048, 60 groups) and at a decode size (256 routed
               rows): int8 — exact int32 accumulators, packed w4 ==
               int8-stored w4, scaled output vs an f32 reference at
               "highest" precision; float (bf16 and f32 operands) vs the
               same reference; each timed next to the plain XLA forms.
  3. layer   — bench.py's headline mixed step (routed + shared experts),
               checked against the reference and timed.
  4. serve   — Qwen1.5-MoE-A2.7B at full width and depth (random weights
               from --seed), per-expert w4a4/w8a8 with w4 nibble-packed
               and a w8a8 shared expert, four requests through
               serving.engine.Engine; prefill logits vs the fake-quant
               reference; unpadded short prefills and decode steps vs
               the Engine's padded chunks.
  5. tests   — the tests marked ``gpu`` (tests/test_gpu.py).

With ``--devices 4`` only the four-card phase runs: the same model and
requests through Engine(mesh=4 cards) with the expert-parallel all-to-all,
compared with the one-card Engine. Any failed check raises; the last line
of standard output is one JSON object {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PROMPT_LENS = (16, 128, 512, 1000)
MAX_NEW = 32
REF_LAYERS = 4      # depth of the f32 fake-quant reference copy (phase 4)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """name, power limit of the card, read by a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def close_to(got, ref, rtol: float, atol_frac: float, what: str) -> None:
    """|got - ref| <= rtol*|ref| + atol_frac*max|ref|, elementwise."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max())
    err = np.abs(got - ref)
    bound = rtol * np.abs(ref) + atol_frac * scale
    worst = float((err / np.maximum(bound, 1e-30)).max())
    check(bool(np.all(err <= bound)),
          f"{what}: max|diff| {err.max():.3e} (max|ref| {scale:.3e}, "
          f"worst diff/bound {worst:.3f}; bound {rtol:g}*|ref| + "
          f"{atol_frac:g}*max|ref|)")


# bf16 output rounding (at most half an ulp, 2^-8 relative) with a quarter of
# headroom, plus f32 summation-order slack of the reference for outputs that
# cancel to near zero
BF16_RTOL, BF16_ATOL = 5e-3, 1e-4


def device_ms(fn, args, chain_arg: int, n=(2, 12), reps: int = 3) -> float:
    """Per-call device time of ``fn(*args)``: n calls inside one jit, the
    operand ``args[chain_arg]`` multiplied by (1 + 0*previous output) so no
    call can be hoisted or elided (chain through an operand the whole
    computation depends on); slope between two loop lengths, median of
    ``reps``."""
    import jax
    import jax.numpy as jnp

    def loop(count, *a):
        def body(_, c):
            a2 = list(a)
            x = a2[chain_arg]
            a2[chain_arg] = x * (1 + c).astype(x.dtype)
            out = jax.tree_util.tree_leaves(fn(*a2))[0]
            out = jax.lax.optimization_barrier(out)
            return c + 0 * out.ravel()[0].astype(jnp.float32)
        return jax.lax.fori_loop(0, count, body, jnp.float32(0))

    f = jax.jit(loop)
    jax.block_until_ready(f(n[0], *args))
    jax.block_until_ready(f(n[1], *args))
    slopes = []
    for _ in range(reps):
        ts = []
        for cnt in n:
            t0 = time.perf_counter()
            jax.block_until_ready(f(cnt, *args))
            ts.append(time.perf_counter() - t0)
        slopes.append((ts[1] - ts[0]) / (n[1] - n[0]))
    return float(np.median(slopes)) * 1e3


def f32_reference(aq, asc, wq, wsc, gs):
    """Dequantized codes, one f32 ``ragged_dot`` per call (XLA, independent
    of the kernels under test; call under "highest" precision)."""
    import jax
    import jax.numpy as jnp

    return jax.lax.ragged_dot(aq.astype(jnp.float32) * asc.reshape(-1, 1),
                              wq.astype(jnp.float32) * wsc, gs)


# ---------------------------------------------------------------------------
# 2. kernels
# ---------------------------------------------------------------------------

def kernel_phase(card: str) -> None:
    import jax
    import jax.numpy as jnp

    import bench
    from mxmoe.ops import gmm as gmm_ops
    from mxmoe.ops import pallas_gmm
    from mxmoe.quant.qparams import quantize_act_per_row_bits

    log(f"== phase 2: kernels (card {card})")
    workloads, operands, qmix, _ = bench.build_headline()
    for wl, (lhs, rhs, _, _), p in zip(workloads, operands, qmix):
        tag = wl.name.split("-")[-1]
        e = wl.num_experts
        gs = p["gs"]
        aq, asc = jax.jit(quantize_act_per_row_bits)(p["lhs"], p["bits"])
        wq = jax.jit(gmm_ops.ragged_to_dense_int8, static_argnums=3)(
            p["cat"], p["pf"], p["blk"], wl.k)                 # [E, K, N]
        int8_cat = wq.reshape(-1, wl.n)
        int8_pf = jnp.zeros((e,), jnp.int32)
        int8_blk = 2 * jnp.arange(e, dtype=jnp.int32)
        m = int(p["gs"].sum())
        log(f"-- {tag}: M={m} (rows padded per expert to {bench.BENCH_BM}) "
            f"K={wl.k} N={wl.n} E={e}, even experts w4a4 (packed), odd w8a8")

        def kern(aq, asc, cat, pf, blk, out_dtype=jnp.bfloat16):
            return pallas_gmm.gmm_int8(aq, asc, cat, p["wsc"], gs, pf, blk,
                                       out_dtype=out_dtype, bm=bench.BENCH_BM)

        acc_p = jax.jit(lambda *a: kern(*a, out_dtype=jnp.int32))(
            aq, asc, p["cat"], p["pf"], p["blk"])
        acc_8 = jax.jit(lambda *a: kern(*a, out_dtype=jnp.int32))(
            aq, asc, int8_cat, int8_pf, int8_blk)
        acc_ref = jax.jit(lambda *a: pallas_gmm.gmm_int8_reference(
            *a, out_dtype=None))(aq, asc, p["cat"], p["wsc"], gs, p["pf"],
                                 p["blk"])
        check(bool(jnp.array_equal(acc_p, acc_ref)),
              f"{tag} packed-mixed int32 accumulators == XLA oracle exactly")
        check(bool(jnp.array_equal(acc_p, acc_8)),
              f"{tag} packed w4 == int8-stored w4 exactly (int32)")
        out = jax.jit(kern)(aq, asc, p["cat"], p["pf"], p["blk"])
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(lambda aq, asc, wq: f32_reference(
                aq, asc, wq, p["wsc"], gs))(aq, asc, wq)
        close_to(out, ref, BF16_RTOL, BF16_ATOL,
                 f"{tag} bf16 output vs f32 dequantized reference")

        flops = 2 * m * wl.k * wl.n
        t = {
            "triton gmm_int8 (w4 packed, one launch)": device_ms(
                kern, (aq, asc, p["cat"], p["pf"], p["blk"]), 1),
            "triton gmm_int8 (w4 stored as int8)": device_ms(
                kern, (aq, asc, int8_cat, int8_pf, int8_blk), 1),
            "XLA unpack w4, then triton gmm_int8": device_ms(
                lambda aq, asc, cat, pf, blk: kern(
                    aq, asc, gmm_ops.ragged_to_dense_int8(
                        cat, pf, blk, wl.k).reshape(-1, wl.n),
                    int8_pf, int8_blk),
                (aq, asc, p["cat"], p["pf"], p["blk"]), 1),
            "XLA unpack + ragged_dot int8 + epilogue": device_ms(
                lambda aq, asc, cat, pf, blk: pallas_gmm.gmm_int8_reference(
                    aq, asc, cat, p["wsc"], gs, pf, blk,
                    out_dtype=jnp.bfloat16),
                (aq, asc, p["cat"], p["pf"], p["blk"]), 0, n=(1, 3)),
            "triton gmm_float bf16 (unquantized)": device_ms(
                lambda x, w: pallas_gmm.gmm_float(x, w, gs), (p["lhs"], rhs),
                0),
            "XLA ragged_dot bf16 (unquantized)": device_ms(
                lambda x, w: jax.lax.ragged_dot(
                    x, w, gs, preferred_element_type=jnp.bfloat16),
                (p["lhs"], rhs), 0, n=(1, 3)),
            "XLA act quant (row amax + quantize)": device_ms(
                quantize_act_per_row_bits, (p["lhs"], p["bits"]), 0),
        }
        for name, ms in t.items():
            rate = ("" if "act quant" in name else
                    f"  {flops / ms / 1e9:.1f} TOP/s")
            log(f"  time {tag}: {name}: {ms:.4f} ms{rate}  [{card}]")
        log(f"  act quant bytes at the single-pass bound: "
            f"{m * wl.k * 3 / 3.35e12 * 1e3:.4f} ms at 3.35 TB/s")

        # decode-sized launch: 64 tokens x top-4 = 256 routed rows, traced
        # group sizes, short row tile (the model's decode setting)
        rng = np.random.default_rng(0)
        sz = np.bincount(rng.integers(0, e, 256), minlength=e)
        gsd = jnp.asarray(sz, jnp.int32)
        aqd, ascd = aq[:256], asc[:256]
        dkw = dict(bm=16, bn=128)

        def dec(aq, asc, cat, pf, blk, out_dtype=jnp.bfloat16):
            return pallas_gmm.gmm_int8(aq, asc, cat, p["wsc"], gsd, pf, blk,
                                       out_dtype=out_dtype, **dkw)

        acc = jax.jit(lambda *a: dec(*a, out_dtype=jnp.int32))(
            aqd, ascd, p["cat"], p["pf"], p["blk"])
        accr = pallas_gmm.gmm_int8_reference(aqd, ascd, p["cat"], p["wsc"],
                                             gsd, p["pf"], p["blk"],
                                             out_dtype=None)
        check(bool(jnp.array_equal(acc, accr)),
              f"{tag} decode-256 int32 accumulators == XLA oracle exactly")
        outd = jax.jit(dec)(aqd, ascd, p["cat"], p["pf"], p["blk"])
        with jax.default_matmul_precision("highest"):
            refd = f32_reference(aqd, ascd, wq, p["wsc"], gsd)
        close_to(outd, refd, BF16_RTOL, BF16_ATOL,
                 f"{tag} decode-256 bf16 output vs f32 reference")
        wbytes = {"packed": p["cat"].nbytes, "int8": int8_cat.nbytes}
        for name, (cat, pf, blk) in (
                ("packed", (p["cat"], p["pf"], p["blk"])),
                ("int8", (int8_cat, int8_pf, int8_blk))):
            ms = device_ms(dec, (aqd, ascd, cat, pf, blk), 1)
            log(f"  time {tag} decode-256: triton gmm_int8 (w4 {name}): "
                f"{ms:.4f} ms, weights {wbytes[name] / 1e6:.0f} MB -> "
                f"{wbytes[name] / ms / 1e6:.0f} GB/s  [{card}]")
        ms = device_ms(
            lambda aq, asc, cat, pf, blk: pallas_gmm.gmm_int8_reference(
                aq, asc, cat, p["wsc"], gsd, pf, blk, out_dtype=jnp.bfloat16),
            (aqd, ascd, p["cat"], p["pf"], p["blk"]), 0, n=(1, 5))
        log(f"  time {tag} decode-256: XLA unpack + ragged_dot int8: "
            f"{ms:.4f} ms  [{card}]")
        ms = device_ms(lambda x, w: jax.lax.ragged_dot(
            x, w, gsd, preferred_element_type=jnp.bfloat16),
            (p["lhs"][:256], rhs), 0, n=(1, 5))
        log(f"  time {tag} decode-256: XLA ragged_dot bf16: {ms:.4f} ms  "
            f"[{card}]")
        float_kernel_check(tag, card, p["lhs"], rhs, gs, gsd)

        # shared expert: cuBLAS int8 dot vs the bf16 dot
        sl, sw = p["sl"], p["sw"]
        saq, _ = quantize_act_per_row_bits(sl, jnp.full((sl.shape[0],), 8.))
        ms8 = device_ms(lambda a, w: jnp.dot(
            a, w, preferred_element_type=jnp.int32), (saq, sw), 0)
        ms16 = device_ms(lambda a, w: jnp.dot(
            a, w, preferred_element_type=jnp.bfloat16),
            (sl, sw.astype(jnp.bfloat16)), 0)
        sflops = 2 * sl.shape[0] * sl.shape[1] * sw.shape[1]
        log(f"  time {tag} shared [{sl.shape[0]},{sl.shape[1]}]x"
            f"[{sw.shape[0]},{sw.shape[1]}]: XLA int8 dot {ms8:.4f} ms "
            f"({sflops / ms8 / 1e9:.0f} TOP/s), bf16 dot {ms16:.4f} ms "
            f"({sflops / ms16 / 1e9:.0f} TFLOP/s)  [{card}]")


def float_kernel_check(tag, card, lhs, rhs, gs, gsd) -> None:
    """The float grouped product (``gmm_float``, the 'auto' backend of
    ops.gmm.gmm on the card) at the headline rows and at 256 decode rows:
    bf16 vs an f32 reference at "highest" precision, and f32 operands (the
    XLA quant families' product) at full precision."""
    import jax
    import jax.numpy as jnp

    from mxmoe.ops import pallas_gmm

    for label, x, g in (("", lhs, gs), (" decode-256", lhs[:256], gsd)):
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(lambda a, w: jax.lax.ragged_dot(
                a.astype(jnp.float32), w.astype(jnp.float32), g))(x, rhs)
        out = jax.jit(lambda a, w: pallas_gmm.gmm_float(a, w, g))(x, rhs)
        close_to(out, ref, BF16_RTOL, BF16_ATOL,
                 f"{tag}{label} triton gmm_float bf16 vs f32 reference")
        out32 = jax.jit(lambda a, w: pallas_gmm.gmm_float(
            a.astype(jnp.float32), w.astype(jnp.float32), g))(x, rhs)
        # f32 products of bf16-exact operands: only summation order differs
        close_to(out32, ref, 1e-5, 1e-6,
                 f"{tag}{label} triton gmm_float f32 vs f32 reference")
    ms = device_ms(lambda a, w: pallas_gmm.gmm_float(a, w, gsd),
                   (lhs[:256], rhs), 0)
    log(f"  time {tag} decode-256: triton gmm_float bf16: {ms:.4f} ms  "
        f"[{card}]")


# ---------------------------------------------------------------------------
# 3. headline layer
# ---------------------------------------------------------------------------

def layer_phase(card: str) -> None:
    import jax
    import jax.numpy as jnp

    import bench
    from mxmoe.bench.timing import bench_step_chained
    from mxmoe.ops import gmm as gmm_ops
    from mxmoe.quant.qparams import (quantize_act_per_row_bits,
                                     quantize_act_per_token)

    log(f"== phase 3: headline layer, bench.py's mixed step (card {card})")
    workloads, operands, qmix, flops = bench.build_headline()
    for wl, p in zip(workloads, qmix):
        tag = wl.name.split("-")[-1]
        routed, shared = jax.jit(bench.mixed_layer_outputs)(p)
        aq, asc = quantize_act_per_row_bits(p["lhs"], p["bits"])
        wq = gmm_ops.ragged_to_dense_int8(p["cat"], p["pf"], p["blk"], wl.k)
        with jax.default_matmul_precision("highest"):
            ref = f32_reference(aq, asc, wq, p["wsc"], p["gs"])
            saq, sasc = quantize_act_per_token(p["sl"], 8)
            sref = jnp.dot(saq.astype(jnp.float32) * sasc,
                           p["sw"].astype(jnp.float32) * p["ssc"])
        close_to(routed, ref, BF16_RTOL, BF16_ATOL,
                 f"{tag} routed experts vs f32 reference")
        close_to(shared, sref, BF16_RTOL, BF16_ATOL,
                 f"{tag} shared expert vs f32 reference")
    step, state0, consts = bench._mixed_step_factory(qmix)
    r = bench_step_chained(step, state0, consts=consts, n1=4, n2=32,
                           repeats=5, target_s=0.1)
    bstep, bstate, bconsts = bench._baseline_step_factory(operands)
    rb = bench_step_chained(bstep, bstate, consts=bconsts, n1=2, n2=5,
                            repeats=2)
    log(f"  time headline layer (gate_up + down, routed + shared): "
        f"{r.median_ms:.4f} ms/step = {r.tflops(flops):.1f} TFLOPS "
        f"(samples {', '.join(f'{s:.4f}' for s in r.samples_ms)} ms); "
        f"XLA bf16 baseline {rb.median_ms:.4f} ms/step = "
        f"{rb.tflops(flops):.1f} TFLOPS; speedup "
        f"{rb.median_ms / r.median_ms:.2f}x  [{card}]")


# ---------------------------------------------------------------------------
# 4. serve
# ---------------------------------------------------------------------------

def build_served_model(cfg, seed: int):
    """(fp params, mixed-packed params, qconfig) of the served model."""
    import jax
    import jax.numpy as jnp

    from mxmoe.models import model
    from mxmoe.quant.qparams import quantize_model_experts_mixed
    from mxmoe.serving.bench_serving import alternating_qconfig

    fp = model.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.bfloat16)
    qmc = alternating_qconfig(cfg)
    q = quantize_model_experts_mixed(fp, cfg, qmc, pack_w4=True)
    return fp, q


def depth_cut(params: dict, n: int) -> dict:
    """The first ``n`` layers (copies; the full stack can then be freed)."""
    return {**params, "layers": {k: v[:n] for k, v in params["layers"].items()}}


def prompts_for(cfg, seed: int) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]


def reference_parity(fp_r, q, cfg, prompt, ref_layers: int) -> None:
    """Prefill logits of the real-quantized forward (the Engine's
    forward_cached) over the first ``ref_layers`` layers vs forward_logits
    on f32 fake-quant parameters of the same layers (``fp_r``, the depth-
    cut float model), at "highest" precision."""
    import jax
    import jax.numpy as jnp

    from mxmoe.models import model
    from mxmoe.models.layers import MoEImpl
    from mxmoe.quant.quantizer import quantize_model_fake
    from mxmoe.serving.bench_serving import alternating_qconfig
    from mxmoe.serving.decode import forward_cached
    from mxmoe.serving.kv_cache import init_kv_cache

    cfg_r = dataclasses.replace(cfg, num_layers=ref_layers)
    fq = quantize_model_fake(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), fp_r),
        cfg_r, alternating_qconfig(cfg_r), "rtn")
    toks = jnp.asarray([prompt], jnp.int32)
    impl = MoEImpl(kind="ragged", quant="mixed")
    real, _ = jax.jit(lambda p, t, c: forward_cached(p, t, c, cfg_r, impl))(
        depth_cut(q, ref_layers), toks, init_kv_cache(cfg_r, 1, len(prompt)))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, t: model.forward_logits(p, t, cfg_r,
                                                        MoEImpl()))(fq, toks)
    real = np.asarray(real[0], np.float32)
    ref = np.asarray(ref[0], np.float32)
    agree = float(np.mean(real.argmax(-1) == ref.argmax(-1)))
    log(f"  reference: f32 fake-quant copy of the first {ref_layers} of "
        f"{cfg.num_layers} layers (an f32 copy of all layers would need "
        f"~57 GB beside the served model); prompt of {len(prompt)} tokens; "
        f"argmax agreement {agree:.4f}")
    # act quant reads bf16 activations on the real path and f32 ones on the
    # reference, so codes at a rounding boundary may differ by one step
    close_to(real, ref, 0.0, 0.05,
             f"prefill logits ({ref_layers} layers) vs fake-quant reference")
    check(agree >= 0.9, f"prefill argmax agreement {agree:.4f} >= 0.9")


def unpadded_check(q, cfg, eng, prompt, sizes=(16, 20, 24),
                   steps: int = 4) -> None:
    """forward_cached on unpadded short prompts (the Engine pads each
    prefill to its chunk, so it never runs these row counts): every logit
    finite, the last position's logits within bf16 noise of the Engine's
    padded prefill of the same prompt, then ``steps`` single-token decode
    steps against that cache with finite logits."""
    import jax
    import jax.numpy as jnp

    from mxmoe.models.layers import MoEImpl
    from mxmoe.serving.decode import forward_cached
    from mxmoe.serving.kv_cache import init_kv_cache

    impl = MoEImpl(kind="ragged", quant="mixed")
    f = jax.jit(lambda p, t, c: forward_cached(p, t, c, cfg, impl))
    for n in sizes:
        seq = (prompt * (n // len(prompt) + 1))[:n]
        cache = init_kv_cache(cfg, 1, max(sizes) + steps)
        lg, cache = f(q, jnp.asarray([seq], jnp.int32), cache)
        lg = np.asarray(lg[0], np.float32)
        bad = int((~np.isfinite(lg)).sum())
        check(bad == 0, f"unpadded prefill of {n} tokens: {bad} non-finite "
                        f"logits of {lg.size}")
        rid = eng.submit(seq, 1)
        eng.run_to_completion()
        close_to(lg[-1], eng.prompt_logits(rid), 0.0, 0.02,
                 f"unpadded {n}-token prefill vs the Engine's padded chunk")
        tok, finite = int(lg[-1].argmax()), []
        for _ in range(steps):
            dl, cache = f(q, jnp.asarray([[tok]], jnp.int32), cache)
            dl = np.asarray(dl[0, -1], np.float32)
            finite.append(bool(np.isfinite(dl).all()))
            tok = int(dl.argmax())
        check(all(finite), f"{steps} decode steps after the unpadded "
                           f"{n}-token prefill: finite logits")


def serve(q, cfg, prompts, mesh=None, ep_cfg=None):
    """Run the requests through Engine; returns (engine, rids, results)."""
    from mxmoe.models.layers import MoEImpl
    from mxmoe.serving.engine import Engine, EngineConfig

    eng = Engine(q, cfg, EngineConfig(batch_slots=4, max_len=2048),
                 MoEImpl(kind="ragged", quant="mixed"), mesh=mesh,
                 ep_cfg=ep_cfg)
    t0 = time.perf_counter()
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    res = eng.run_to_completion()
    log(f"  {len(prompts)} requests served in {time.perf_counter() - t0:.1f}"
        f" s (compile included)")
    return eng, rids, res


def serve_phase(card: str, seed: int) -> None:
    import jax

    from mxmoe.models import configs

    cfg = configs.QWEN2_MOE_A2_7B
    log(f"== phase 4: serve {cfg.model_type} at full width, {cfg.num_layers} "
        f"layers (card {card})")
    t0 = time.perf_counter()
    fp, q = build_served_model(cfg, seed)
    jax.block_until_ready(q)
    log(f"  built and quantized in {time.perf_counter() - t0:.1f} s; "
        f"experts w4a4 (packed) / w8a8 alternating, shared expert w8a8")
    prompts = prompts_for(cfg, seed)
    # keep only the reference's layers of the float model: an f32 copy of
    # all of them would not fit beside the served model
    fp_r = depth_cut(fp, REF_LAYERS)
    del fp
    reference_parity(fp_r, q, cfg, prompts[2], REF_LAYERS)
    del fp_r
    eng, rids, res = serve(q, cfg, prompts)
    unpadded_check(q, cfg, eng, prompts[0])
    for rid, prompt in zip(rids, prompts):
        toks = res[rid]
        check(len(toks) == MAX_NEW and all(0 <= t < cfg.vocab_size
                                           for t in toks),
              f"request {rid} (prompt {len(prompt)}): {len(toks)} tokens")
        log(f"  greedy tokens (prompt {len(prompt)}): {toks}")
    for name, ma in eng.memory_analysis().items():
        log(f"  memory_analysis {name}: {ma}")
    stats = jax.devices()[0].memory_stats() or {"peak_bytes_in_use": 0}
    log(f"  peak_bytes_in_use: {stats['peak_bytes_in_use']} "
        f"({stats['peak_bytes_in_use'] / 2**30:.2f} GiB)  [{card}]")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def four_card_phase(card: str, seed: int) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mxmoe.models import configs
    from mxmoe.parallel.ep import EPConfig, make_ep_moe_mixed_dyn

    devs = jax.devices()
    check(len(devs) >= 4, f"{len(devs)} GPUs visible")
    cfg = configs.QWEN2_MOE_A2_7B
    log(f"== four-card phase: {cfg.model_type}, {cfg.num_layers} layers, "
        f"Engine over Mesh(4 cards, ('expert',)) vs one card (card {card})")
    fp, q = build_served_model(cfg, seed)
    del fp
    prompts = prompts_for(cfg, seed)
    eng1, rids1, res1 = serve(q, cfg, prompts)
    mesh = Mesh(np.array(devs[:4]), ("expert",))
    # capacity = every assignment a shard can send: no drop is possible
    ep_cfg = EPConfig(axis="expert", capacity_factor=4.0)
    eng4, rids4, res4 = serve(q, cfg, prompts, mesh=mesh, ep_cfg=ep_cfg)

    # measured drops: the EP block with drop statistics on layer 0's
    # experts over the longest prompt's first chunk of embeddings
    lp0 = {k: v[0] for k, v in eng4.params["layers"].items()}
    chunk = prompts[3][:min(256, len(prompts[3])) // 4 * 4]
    x = jnp.take(eng4.params["embed"], jnp.asarray(chunk), axis=0)
    stats_fn = make_ep_moe_mixed_dyn(
        cfg, mesh, dataclasses.replace(ep_cfg, return_stats=True))
    with mesh:
        _, dropped = jax.jit(stats_fn)(x, lp0)
    drops = int(np.asarray(dropped).sum())
    log(f"  EP dropped assignments (layer 0, {len(chunk)} tokens x "
        f"top-{cfg.top_k}): {drops}")
    check(drops == 0, "no EP assignment dropped")

    diffs = []
    for r1, r4, prompt in zip(rids1, rids4, prompts):
        l1, l4 = eng1.prompt_logits(r1), eng4.prompt_logits(r4)
        close_to(l4, l1, 0.0, 0.02,
                 f"prompt {len(prompt)}: EP Engine prefill logits vs one card")
        diffs.append(float(np.abs(l4 - l1).max()))
    # a divergence is acceptable only where the one-card Engine's two best
    # next tokens are closer than the engines' logit differences
    near = max(0.1, 2 * max(diffs))
    for r1, r4, prompt in zip(rids1, rids4, prompts):
        t1, t4 = res1[r1], res4[r4]
        if t1 == t4:
            log(f"  prompt {len(prompt)}: greedy tokens equal: {t4}")
            continue
        j = next(i for i, (a, b) in enumerate(zip(t1, t4)) if a != b)
        gap = _top2_gap(eng1, prompt + t1[:j])
        log(f"  prompt {len(prompt)}: tokens diverge at step {j} "
            f"({t1[j]} one card vs {t4[j]} four cards); one-card top-2 "
            f"logit gap there {gap:.4f}")
        check(gap < near, f"divergence at a near-tie (gap {gap:.4f} < "
                          f"{near:.4f})")


def _top2_gap(eng, seq) -> float:
    """Gap between the Engine's two largest next-token logits after
    ``seq`` (prefilled as one request)."""
    rid = eng.submit(seq, 1)
    eng.run_to_completion()
    top = np.sort(np.asarray(eng.prompt_logits(rid), np.float32))[-2:]
    return float(top[1] - top[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    import jax

    from mxmoe.utils.device import enable_compile_cache

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {d.platform!r}")
    enable_compile_cache()
    card = card_line()
    log(f"== phase 1: device {d.platform} / {d.device_kind} x "
        f"{len(jax.devices())}")
    log(f"nvidia-smi: {card}")
    t0 = time.perf_counter()
    if args.devices == 4:
        four_card_phase(card, args.seed)
    else:
        kernel_phase(card)
        layer_phase(card)
        serve_phase(card, args.seed)
        log("== phase 5: tests marked gpu")
        import pytest

        os.environ["JAX_PLATFORMS"] = d.platform
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(REPO, "tests", "test_gpu.py")])
        check(rc == 0, f"gpu-marked tests passed (pytest exit {rc})")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"nvidia-smi: {card}")
    devs = jax.devices()
    count = 4 if args.devices == 4 else len(devs)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
