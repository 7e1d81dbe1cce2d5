"""Mixed-scheme model quantizer + evaluator tests."""

import jax
import jax.numpy as jnp
import numpy as np

from mxmoe.models import configs, model
from mxmoe.models.layers import MoEImpl
from mxmoe.quant.quantizer import quantize_model_fake
from mxmoe.quant.schemes import (
    QLinearConfig, QExpertConfig, QLayerConfig, QModelConfig,
    build_uniform_model, parse_scheme,
)
from mxmoe.eval.evaluator import eval_ppl_tokens


def _mixed_cfg(num_layers, num_experts, schemes=("w4a4_g-1_sym", "w8a8_g-1_sym")):
    """Alternate schemes across experts; shared expert (index E) gets w8."""
    layers = {}
    for l in range(num_layers):
        experts = {}
        for e in range(num_experts + 1):  # + shared
            s = parse_scheme(schemes[e % len(schemes)] if e < num_experts
                             else "w8a8_g-1_sym")
            experts[str(e)] = QExpertConfig(gate=s, up=s, down=s)
        layers[str(l)] = QLayerConfig(experts=experts)
    return QModelConfig(layers=layers)


def _setup(seed=0):
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(seed + 1), (2, 32), 0, cfg.vocab_size)
    return cfg, params, toks


def test_w16_config_is_identity():
    cfg, params, toks = _setup()
    qcfg = build_uniform_model(QLinearConfig(), cfg.num_layers, cfg.num_experts + 1)
    qp = quantize_model_fake(params, cfg, qcfg, method="rtn")
    ref = model.forward_logits(params, toks, cfg, MoEImpl())
    got = model.forward_logits(qp, toks, cfg, MoEImpl())
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_mixed_rtn_per_expert_damage():
    cfg, params, _ = _setup(seed=2)
    qcfg = _mixed_cfg(cfg.num_layers, cfg.num_experts)
    qp = quantize_model_fake(params, cfg, qcfg, method="rtn")
    w0 = np.asarray(params["layers"]["expert_gate_up"][0])   # [E, H, 2N]
    wq = np.asarray(qp["layers"]["expert_gate_up"][0])
    err = np.abs(wq - w0).mean(axis=(1, 2))                  # per expert
    # experts 0,2 are w4; 1,3 are w8 -> w4 error strictly larger
    assert err[0] > 2 * err[1] and err[2] > 2 * err[3]
    # act bits arrays match config
    np.testing.assert_array_equal(
        np.asarray(qp["layers"]["act_bits_gateup"][0]), [4, 8, 4, 8]
    )
    np.testing.assert_array_equal(np.asarray(qp["layers"]["act_bits_shared"][0]), [8, 8])


def test_mixed_forward_and_logit_distortion_ordering():
    # ppl of a random-init model is uninformative; logit distortion vs the
    # fp model is the right monotonicity check: w2 >> mixed(w4/w8) > w16=0
    cfg, params, _ = _setup(seed=3)
    eval_toks = jax.random.randint(jax.random.PRNGKey(9), (2, 48), 0, cfg.vocab_size)
    ref = model.forward_logits(params, eval_toks, cfg, MoEImpl())

    def distortion(qp):
        got = model.forward_logits(qp, eval_toks, cfg, MoEImpl())
        assert bool(jnp.all(jnp.isfinite(got)))
        return float(jnp.mean(jnp.abs(got - ref)))

    brutal = build_uniform_model(
        parse_scheme("w2a4_g-1_sym"), cfg.num_layers, cfg.num_experts + 1)
    d_w2 = distortion(quantize_model_fake(params, cfg, brutal, method="rtn"))
    mixed = _mixed_cfg(cfg.num_layers, cfg.num_experts)
    d_mixed = distortion(quantize_model_fake(params, cfg, mixed, method="rtn"))

    assert d_w2 > 2 * d_mixed > 0, (d_w2, d_mixed)

    # ppl evaluator sanity on the same tokens
    ppl = eval_ppl_tokens(params, np.asarray(eval_toks), cfg)
    assert np.isfinite(ppl) and ppl > 1.0


def test_gptq_method_runs_and_differs_from_rtn():
    cfg, params, toks = _setup(seed=4)
    qcfg = _mixed_cfg(cfg.num_layers, cfg.num_experts)
    qp_rtn = quantize_model_fake(params, cfg, qcfg, method="rtn")
    qp_gptq = quantize_model_fake(params, cfg, qcfg, method="gptq",
                                  calib_tokens=toks, backend="dense")
    a = np.asarray(qp_rtn["layers"]["expert_gate_up"])
    b = np.asarray(qp_gptq["layers"]["expert_gate_up"])
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() > 1e-6
    out = model.forward_logits(qp_gptq, toks, cfg, MoEImpl())
    assert bool(jnp.all(jnp.isfinite(out)))


def test_rtn_had_method_improves_w3_ppl():
    cfg, params, _ = _setup(seed=5)
    eval_toks = np.asarray(
        jax.random.randint(jax.random.PRNGKey(11), (2, 48), 0, cfg.vocab_size))
    aggressive = build_uniform_model(
        parse_scheme("w3a16_g-1_sym"), cfg.num_layers, cfg.num_experts + 1)
    qp = quantize_model_fake(params, cfg, aggressive, method="rtn")
    qp_had = quantize_model_fake(params, cfg, aggressive, method="rtn-had",
                                 rotation_key=jax.random.PRNGKey(1))
    ppl = eval_ppl_tokens(qp, eval_toks, cfg)
    ppl_had = eval_ppl_tokens(qp_had, eval_toks, cfg)
    assert np.isfinite(ppl) and np.isfinite(ppl_had)
    # rotation flattens outliers; at w3 it should not be (much) worse
    assert ppl_had < ppl * 1.2


def test_ds2_mixed_fake_quant_and_eval():
    """Mixed fake-quant on the MLA + dense-first-layer family."""
    from mxmoe.models.configs import tiny_ds2

    cfg = tiny_ds2(num_experts=4, num_layers=3)
    params = model.init_params(cfg, jax.random.PRNGKey(20), dtype=jnp.float32)
    qcfg = _mixed_cfg(cfg.num_moe_layers, cfg.num_experts)
    qp = quantize_model_fake(params, cfg, qcfg, method="rtn")
    assert "dense_layers" in qp  # dense first layer untouched (reference scope)

    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(21), (1, 32), 0, cfg.vocab_size))
    ppl = eval_ppl_tokens(qp, toks, cfg)
    assert np.isfinite(ppl)

    ref = model.forward_logits(params, jnp.asarray(toks), cfg, MoEImpl())
    got = model.forward_logits(qp, jnp.asarray(toks), cfg, MoEImpl())
    assert bool(jnp.all(jnp.isfinite(got)))
    assert float(jnp.abs(got - ref).mean()) > 0  # quantization took effect


def test_ds2_gptq_method():
    """GPTQ layer streaming on the MLA + dense-first family."""
    from mxmoe.models.configs import tiny_ds2

    cfg = tiny_ds2(num_experts=4, num_layers=3)
    params = model.init_params(cfg, jax.random.PRNGKey(22), dtype=jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(23), (1, 32), 0, cfg.vocab_size)
    qcfg = _mixed_cfg(cfg.num_moe_layers, cfg.num_experts)
    qp = quantize_model_fake(params, cfg, qcfg, method="gptq",
                             calib_tokens=toks, backend="dense")
    out = model.forward_logits(qp, toks, cfg, MoEImpl())
    assert bool(jnp.all(jnp.isfinite(out)))


def test_ds2_dense_pseudo_expert_full_pipeline():
    """The ds2 dense first layer gets a scheme slot end-to-end: calibration
    emits a dense-0 row, the solver assigns it, and the quantizer applies it
    (round-1 verdict #8)."""
    from mxmoe.models.configs import tiny_ds2
    from mxmoe.quant.calibrate import calibrate_model
    from mxmoe.trace.gate import trace_gate_stats, dump_gate_trace
    from mxmoe.solver import solve_model
    import json as _json

    cfg = tiny_ds2(num_experts=4, num_layers=3)
    params = model.init_params(cfg, jax.random.PRNGKey(30), dtype=jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(31), (1, 32), 0, cfg.vocab_size)

    schemes = {s: parse_scheme(s) for s in ("w4a4_g-1_sym", "w8a8_g-1_sym")}
    losses = calibrate_model(params, toks, cfg, schemes, backend="dense")
    for s in schemes:
        assert "dense-0" in losses[s]
        vals = losses[s]["dense-0"]["0"]
        assert len(vals) == 3 and all(np.isfinite(v) and v > 0 for v in vals)
    # w4 must hurt more than w8 on the same block
    assert sum(losses["w4a4_g-1_sym"]["dense-0"]["0"]) > \
        sum(losses["w8a8_g-1_sym"]["dense-0"]["0"])

    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        tr_path = os.path.join(td, "moe-gate.json")
        dump_gate_trace(trace_gate_stats(params, toks, cfg, backend="dense"),
                        tr_path)
        trace = _json.load(open(tr_path))
        assert trace["first_dense_layers"] == 1 and trace["dense_NK"][0] == \
            cfg.dense_intermediate_size

    qcfg, tiles = solve_model(losses, trace, batch=256,
                              num_layers=cfg.num_moe_layers,
                              wbits_target=8.0, r=1.0)
    assert "dense-0" in qcfg.layers
    dense_qm = qcfg.layers["dense-0"].experts["0"].qmap()
    assert dense_qm["gate"].w_bits in (4, 8)

    qp = quantize_model_fake(params, cfg, qcfg, method="rtn")
    assert "act_bits_dense" in qp["dense_layers"]
    d = float(jnp.abs(qp["dense_layers"]["mlp_gate_up"]
                      - params["dense_layers"]["mlp_gate_up"]).max())
    assert d > 0  # dense weights actually quantized
    out = model.forward_logits(qp, toks, cfg, MoEImpl())
    assert bool(jnp.all(jnp.isfinite(out)))

    # GPTQ path covers the dense pseudo-expert too
    qp2 = quantize_model_fake(params, cfg, qcfg, method="gptq",
                              calib_tokens=toks, backend="dense")
    assert "act_bits_dense" in qp2["dense_layers"]
    d2 = float(jnp.abs(qp2["dense_layers"]["mlp_gate_up"]
                       - params["dense_layers"]["mlp_gate_up"]).max())
    assert d2 > 0
