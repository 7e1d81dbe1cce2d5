"""End-to-end co-design pipeline on a tiny model: trace -> calibrate ->
solve -> workload -> kernel check. Mirrors the reference's full artifact
flow (SURVEY.md §0 dataflow diagram) through file interfaces."""

import json

import jax
import jax.numpy as jnp
import numpy as np

from mxmoe.models import configs, model
from mxmoe.quant.calibrate import calibrate_model
from mxmoe.quant.schemes import QLinearConfig, QModelConfig, parse_scheme
from mxmoe.trace.gate import trace_gate_stats, dump_gate_trace, load_gate_trace
from mxmoe.solver import solve_model
from mxmoe.bench.workload_gen import generate_workload_from_gate_trace
from mxmoe.bench.harness import run_check

SCHEMES = {
    "w4a4_g-1_sym": parse_scheme("w4a4_g-1_sym"),
    "w8a8_g-1_sym": parse_scheme("w8a8_g-1_sym"),
}


def test_full_pipeline(tmp_path):
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0, cfg.vocab_size)

    # 1. trace
    trace = trace_gate_stats(params, tokens, cfg)
    trace_path = str(tmp_path / "moe-gate.json")
    dump_gate_trace(trace, trace_path)
    tr = load_gate_trace(trace_path)
    assert tr["topk"] == cfg.top_k
    assert len(tr["layer-0"]["access_freq"]) == cfg.num_experts
    assert sum(tr["layer-0"]["access_freq"]) == tokens.size * cfg.top_k

    # 2. calibrate
    losses = calibrate_model(params, tokens, cfg, SCHEMES, save_dir=str(tmp_path))

    # 3. solve (mixed allocation at wbits between 4 and 8)
    qcfg, tiles = solve_model(
        losses, tr, batch=tokens.size, num_layers=cfg.num_layers,
        wbits_target=6.0, r=1.0,
    )
    wbits_used = {
        c.w_bits
        for layer in qcfg.layers.values()
        for ex in layer.experts.values()
        for c in ex.qmap().values()
    }
    assert wbits_used <= {4, 8}
    assert len(wbits_used) == 2, "budget 6.0 between 4 and 8 should mix schemes"

    # 4. workload generation from trace + solved qconfig
    wl = generate_workload_from_gate_trace(
        tr, num_total_tokens=tokens.size, layer_id=0,
        save_path=str(tmp_path / "wl.json"), qconfig=qcfg,
    )
    layer0 = wl["layer-0"]
    assert len(layer0["gate_up"]) == cfg.num_experts + 1  # + shared expert
    routed_m = sum(p["shape"][0] for p in layer0["gate_up"][:-1])
    assert routed_m <= tokens.size * cfg.top_k

    # 5. kernel check on the generated workload (scheme-bucketed)
    wl_small = json.load(open(tmp_path / "wl.json"))
    assert run_check(wl_small, tol=1.0, interpret=jax.default_backend() == "cpu")


def test_activation_trace():
    from mxmoe.trace.gate import trace_activation_stats

    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(5), (2, 32), 0, cfg.vocab_size)
    tr = trace_activation_stats(params, toks, cfg)
    assert tr.amax.shape == (2,) and (tr.amax > 0).all()
    assert tr.channel_amax.shape == (2, cfg.hidden_size)
    # percentiles monotone
    assert (np.diff(tr.percentiles, axis=1) >= -1e-6).all()
    np.testing.assert_allclose(tr.percentiles[:, -1], tr.amax, rtol=1e-5)


def test_harness_check_grouped_and_asym_schemes():
    """check mode covers grouped (g128-class) and asym int8 schemes."""
    from mxmoe.bench.harness import run_check

    wl = {
        "num_tokens": 128,
        "layer-0": {
            "gate_up": [
                {"shape": [48, 64, 128], "w_bits": 4, "a_bits": 4,
                 "gsize": 32, "sym": True},
                {"shape": [80, 64, 128], "w_bits": 4, "a_bits": 4,
                 "gsize": 32, "sym": True},
                {"shape": [64, 64, 128], "w_bits": 8, "a_bits": 8,
                 "gsize": -1, "sym": False},
            ],
            "down": [
                {"shape": [96, 128, 64], "w_bits": 8, "a_bits": 8,
                 "gsize": -1, "sym": True},
            ],
        },
    }
    assert run_check(wl, tol=1.0, interpret=jax.default_backend() == "cpu")


def test_ds2_full_pipeline():
    """trace -> calibrate -> solve on the MLA + dense-first family; hidden
    states propagate through the dense layer and MLA attention correctly
    (forward oracle: trace hidden states must match model.forward_hidden)."""
    from mxmoe.models.configs import tiny_ds2
    from mxmoe.solver import solve_model

    cfg = tiny_ds2(num_experts=4, num_layers=3)
    params = model.init_params(cfg, jax.random.PRNGKey(50), dtype=jnp.float32)
    tokens = jax.random.randint(jax.random.PRNGKey(51), (2, 32), 0, cfg.vocab_size)

    trace = trace_gate_stats(params, tokens, cfg)
    assert trace.access_freq.shape == (cfg.num_moe_layers, cfg.num_experts)
    assert trace.access_freq.sum() == tokens.size * cfg.top_k * cfg.num_moe_layers

    losses = calibrate_model(params, tokens, cfg, SCHEMES)
    # 4 routed + 1 shared pseudo-expert per MoE layer
    assert set(losses["w8a8_g-1_sym"]["0"].keys()) == {str(e) for e in range(5)}

    import dataclasses as dc
    tr = {
        "topk": cfg.top_k, "NK": [cfg.moe_intermediate_size, cfg.hidden_size],
        "num_layers": cfg.num_moe_layers, "num_tokens": tokens.size,
        "num_samples": 2,
        "num_shared_experts": cfg.shared_expert_intermediate_size // cfg.moe_intermediate_size,
    }
    for l in range(cfg.num_moe_layers):
        tr[f"layer-{l}"] = {"access_freq": trace.access_freq[l].tolist(),
                            "weights_sum": [], "percentile_stats": {}}
    qcfg, _ = solve_model(losses, tr, batch=tokens.size,
                          num_layers=cfg.num_moe_layers, wbits_target=6.0, r=1.0)
    # moe layers + the dense first layer's pseudo-layer slot
    assert len(qcfg.layers) == cfg.num_moe_layers + cfg.first_dense_layers
    assert "dense-0" in qcfg.layers
