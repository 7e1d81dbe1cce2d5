"""Chained timing protocol + anchor training smoke (CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mxmoe.bench.timing import bench_fn, bench_step_chained


def test_bench_step_chained_measures_positive_time():
    w = jnp.ones((128, 128), jnp.float32) * 0.01

    def step(state):
        return {"x": jnp.tanh(state["x"] @ w)}

    r = bench_step_chained(step, {"x": jnp.ones((128, 128), jnp.float32)},
                           n1=2, n2=6, repeats=2)
    assert r.median_ms > 0
    assert r.repeats == 2


def test_bench_step_chained_consts_arg():
    """Weights passed via consts (jit arg, not closure) — same result."""
    w = jnp.ones((128, 128), jnp.float32) * 0.01

    def step(state, cc):
        return {"x": jnp.tanh(state["x"] @ cc["w"])}

    r = bench_step_chained(step, {"x": jnp.ones((128, 128), jnp.float32)},
                           consts={"w": w}, n1=2, n2=6, repeats=2)
    assert r.median_ms > 0


def test_chain_launcher_roundtrip():
    from mxmoe.bench.timing import chain_launcher

    w = jnp.ones((64, 32), jnp.float32)

    def fn(ops):
        return ops["lhs"] @ ops["rhs"]

    step, state0, consts = chain_launcher(
        fn, {"lhs": jnp.ones((16, 64), jnp.float32), "rhs": w})
    out = step(state0, consts)
    assert out["lhs"].shape == (16, 64)
    r = bench_step_chained(step, state0, consts=consts, n1=2, n2=4, repeats=2)
    assert r.median_ms > 0


def test_bench_step_chained_scales_with_work():
    """A step doing 8x the matmuls must measure meaningfully slower."""
    w = jnp.ones((256, 256), jnp.float32) * 0.01

    def light(state):
        return {"x": jnp.tanh(state["x"] @ w)}

    def heavy(state):
        x = state["x"]
        for _ in range(8):
            x = jnp.tanh(x @ w)
        return {"x": x}

    s0 = {"x": jnp.ones((256, 256), jnp.float32)}
    r1 = bench_step_chained(light, s0, n1=2, n2=10, repeats=2)
    r8 = bench_step_chained(heavy, s0, n1=2, n2=10, repeats=2)
    assert r8.median_ms > r1.median_ms


def test_bench_result_sane_rejects_superroofline_samples():
    """Samples implying >peak throughput are measurement glitches and
    must not survive into the reported band."""
    from mxmoe.bench.timing import BenchResult

    flops = 1e12           # 1 TFLOP of work
    # 10 ms -> 100 TFLOPS (fine at peak 200); 1 ms -> 1000 TFLOPS (glitch)
    r = BenchResult(median_ms=5.0, best_ms=1.0, std_ms=0.0, repeats=3,
                    samples_ms=(10.0, 1.0, 11.0))
    s = r.sane(flops, peak_tflops=200.0)
    assert s.repeats == 2
    assert s.samples_ms == (10.0, 11.0)
    assert s.median_ms == 10.5
    # all-glitch: keep the slowest sample rather than report fiction
    r2 = BenchResult(median_ms=1.0, best_ms=0.5, std_ms=0.0, repeats=2,
                     samples_ms=(0.5, 1.0))
    s2 = r2.sane(flops, peak_tflops=200.0)
    assert s2.samples_ms == (1.0,)


def test_bench_result_samples_recorded():
    def step(state):
        return {"x": jnp.tanh(state["x"])}

    r = bench_step_chained(step, {"x": jnp.ones((64,), jnp.float32)},
                           n1=2, n2=4, repeats=2)
    assert len(r.samples_ms) == r.repeats
    assert np.median(r.samples_ms) == r.median_ms


def test_anchor_streaming_train_smoke():
    """A few streaming steps on a micro config: loss finite and the
    trained params eval to finite ppl at the trained window length."""
    from mxmoe.eval.anchor import anchor_config, train_anchor_model
    from mxmoe.eval.evaluator import eval_ppl_tokens
    from mxmoe.models.layers import MoEImpl
    from mxmoe.quant.data import synthetic_markov_tokens

    cfg = dataclasses.replace(
        anchor_config(vocab=256), num_layers=1, hidden_size=64,
        num_heads=2, num_kv_heads=2, head_dim=32, top_k=2,
        moe_intermediate_size=32, shared_expert_intermediate_size=64,
    )
    cfg = dataclasses.replace(cfg, num_experts=4)
    params, loss = train_anchor_model(cfg, steps=3, batch=4, seqlen=32,
                                      log_every=0)
    assert np.isfinite(loss)
    toks = synthetic_markov_tokens(4, 32, cfg.vocab_size, seed=99)
    ppl = eval_ppl_tokens(params, toks, cfg, MoEImpl(kind="dense"))
    assert np.isfinite(ppl) and ppl > 1.0
