"""Vectorized calibration vs brute-force per-expert oracle.

The oracle reproduces the reference loop (``quant.py:543-612``) literally:
for each (expert, linear), fake-quantize only that block (weights + that
linear's input activations), recompute the whole MoE output, take
‖q − fp‖_F. The vectorized path must match to float tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mxmoe.models import configs, model
from mxmoe.ops.dispatch import route_topk
from mxmoe.quant.calibrate import moe_calib_errors, calibrate_model
from mxmoe.quant.rtn import fake_quant
from mxmoe.quant.schemes import QLinearConfig


def _fq_w_nk_grouping(w_kn, qcfg):
    w_nk = jnp.swapaxes(w_kn, -1, -2)
    w_nk = fake_quant(w_nk, qcfg.w_bits, qcfg.w_gsize, qcfg.w_sym, qcfg.w_clip)
    return jnp.swapaxes(w_nk, -1, -2)


def _fq_a(x, qcfg):
    if qcfg.a_bits >= 16:
        return x
    return fake_quant(x, qcfg.a_bits, qcfg.a_gsize, qcfg.a_sym, qcfg.a_clip)


def _moe_out_dense(x2d, lp, cfg, qcfg=None, target=None):
    """Dense-path routed-expert output; optionally quantize one block.

    target: (expert_idx, 'gate'|'up'|'down') or None for FP.
    """
    n = cfg.moe_intermediate_size
    gate_up = lp["expert_gate_up"]
    wg, wu = gate_up[..., :n], gate_up[..., n:]
    wd = lp["expert_down"]

    logits = x2d @ lp["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob)

    outs = []
    for e in range(cfg.num_experts):
        wg_e, wu_e, wd_e = wg[e], wu[e], wd[e]
        x_in_g = x_in_u = x2d
        if target is not None and target[0] == e:
            if target[1] == "gate":
                wg_e = _fq_w_nk_grouping(wg_e, qcfg)
                x_in_g = _fq_a(x2d, qcfg)
            elif target[1] == "up":
                wu_e = _fq_w_nk_grouping(wu_e, qcfg)
                x_in_u = _fq_a(x2d, qcfg)
        h = jax.nn.silu(x_in_g @ wg_e) * (x_in_u @ wu_e)
        if target is not None and target[0] == e and target[1] == "down":
            wd_e = _fq_w_nk_grouping(wd_e, qcfg)
            h = _fq_a(h, qcfg)
        outs.append(h @ wd_e)
    out_all = jnp.stack(outs)  # [E, T, H]

    one_hot = jax.nn.one_hot(routing.expert_ids, cfg.num_experts, dtype=x2d.dtype)
    w = (routing.weights.astype(x2d.dtype)[..., None] * one_hot).sum(1)  # [T, E]
    return jnp.einsum("eth,te->th", out_all, w)


def test_calib_errors_match_bruteforce_oracle():
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = jax.random.normal(jax.random.PRNGKey(1), (48, cfg.hidden_size), jnp.float32)
    qcfg = QLinearConfig(w_bits=4, w_gsize=-1, w_sym=True, a_bits=8, a_sym=True)

    err2 = np.asarray(moe_calib_errors(x, lp, cfg, qcfg, backend="dense"))

    fp = _moe_out_dense(x, lp, cfg)
    for e in range(cfg.num_experts):
        for bi, b in enumerate(("gate", "up", "down")):
            q = _moe_out_dense(x, lp, cfg, qcfg, target=(e, b))
            want = float(jnp.sum((q - fp) ** 2))
            got = float(err2[e, bi])
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-7)


def test_calibrate_model_end_to_end_schema(tmp_path):
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    tokens = jax.random.randint(jax.random.PRNGKey(3), (2, 32), 0, cfg.vocab_size)
    schemes = {
        "w8a8_g-1_sym": QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True, a_bits=8),
        "w4a16_g16_asym": QLinearConfig(w_bits=4, w_gsize=16, w_sym=False, a_bits=16),
    }
    losses = calibrate_model(
        params, tokens, cfg, schemes, save_dir=str(tmp_path), model_id="tiny"
    )
    import json, os

    for name in schemes:
        assert set(losses[name].keys()) == {"0", "1"}
        layer0 = losses[name]["0"]
        # 4 routed experts + 1 shared expert (reference expert index E)
        assert set(layer0.keys()) == {str(e) for e in range(5)}
        assert all(len(v) == 3 and all(np.isfinite(v)) for v in layer0.values())
        # w8 loss should be smaller than w4 loss on average
        fp = os.path.join(str(tmp_path), f"tiny-MOE-layer_out_norm-rtn-{name}.json")
        assert os.path.exists(fp)
        assert json.load(open(fp)) == losses[name]

    a = np.mean([losses["w8a8_g-1_sym"]["0"][str(e)] for e in range(4)])
    b = np.mean([losses["w4a16_g16_asym"]["0"][str(e)] for e in range(4)])
    assert a < b


def test_calibrate_gptq_and_had_methods(tmp_path):
    """GPTQ calibration runs and yields lower-or-equal loss than RTN on
    most blocks (Hessian-aware rounding); -had methods run rotated."""
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    tokens = jax.random.randint(jax.random.PRNGKey(6), (2, 48), 0, cfg.vocab_size)
    schemes = {"w3a16_g-1_sym": QLinearConfig(w_bits=3, w_gsize=-1, w_sym=True, a_bits=16)}

    rtn = calibrate_model(params, tokens, cfg, schemes, method="rtn")
    gptq = calibrate_model(params, tokens, cfg, schemes, method="gptq")
    had = calibrate_model(params, tokens, cfg, schemes, method="rtn-had")

    r = np.array([rtn["w3a16_g-1_sym"]["0"][str(e)] for e in range(5)])
    g = np.array([gptq["w3a16_g-1_sym"]["0"][str(e)] for e in range(5)])
    h = np.array([had["w3a16_g-1_sym"]["0"][str(e)] for e in range(5)])
    assert np.isfinite(g).all() and np.isfinite(h).all()
    # GPTQ should reduce aggregate loss vs RTN
    assert g.sum() < r.sum(), (g.sum(), r.sum())


def test_model_out_norm_metric_and_resume(tmp_path):
    from mxmoe.quant.calibrate import model_out_norm_errors

    cfg = configs.tiny_qwen2_moe(num_experts=3, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(8), dtype=jnp.float32)
    tokens = jax.random.randint(jax.random.PRNGKey(9), (1, 24), 0, cfg.vocab_size)
    qcfg = QLinearConfig(w_bits=3, w_gsize=-1, w_sym=True, a_bits=16)

    errs = model_out_norm_errors(params, tokens, cfg, qcfg, layer_idx=0)
    assert errs.shape == (4, 3) and np.isfinite(errs).all() and (errs > 0).all()
    # w8 should give smaller model-out error than w3
    errs8 = model_out_norm_errors(
        params, tokens, cfg,
        QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True, a_bits=16), layer_idx=0)
    assert errs8.sum() < errs.sum()

    # resume: first run saves; second run with resume skips recompute but
    # returns identical losses
    schemes = {"w4a16_g-1_sym": QLinearConfig(w_bits=4, w_gsize=-1, w_sym=True, a_bits=16)}
    a = calibrate_model(params, tokens, cfg, schemes, save_dir=str(tmp_path),
                        model_id="t", method="rtn")
    b = calibrate_model(params, tokens, cfg, schemes, save_dir=str(tmp_path),
                        model_id="t", method="rtn", resume=True)
    assert a == b


def test_calibrate_stage_host_matches_unstaged():
    """Host-staged calibration (params held as numpy, one layer moved per
    iteration — the reference's layer.to(cuda), quant.py:551) produces the
    same losses as the all-on-device path."""
    from mxmoe.models import configs, model as model_mod
    from mxmoe.quant.calibrate import calibrate_model
    from mxmoe.quant.schemes import parse_scheme

    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params = model_mod.init_params(cfg, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0,
                                cfg.vocab_size)
    schemes = {"w8a8_g-1_sym": parse_scheme("w8a8_g-1_sym")}
    a = calibrate_model(params, tokens, cfg, schemes, method="gptq-had",
                        stage_host=False)
    b = calibrate_model(params, tokens, cfg, schemes, method="gptq-had",
                        stage_host=True)
    for lkey in a["w8a8_g-1_sym"]:
        for e in a["w8a8_g-1_sym"][lkey]:
            np.testing.assert_allclose(
                a["w8a8_g-1_sym"][lkey][e], b["w8a8_g-1_sym"][lkey][e],
                rtol=1e-5)
