"""Expert-parallel all-to-all MoE vs single-device oracle (8-dev CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax.sharding import Mesh, PartitionSpec as P

from mxmoe.models import configs, model
from mxmoe.parallel.ep import EPConfig, make_ep_moe_fn
from mxmoe.ops.dispatch import route_topk

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs multi-device mesh"
)


def _dense_routed_oracle(x, router, gate_up, down, cfg):
    """Dense O(E) routed-expert output (no shared expert)."""
    logits = x @ router
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob,
                         cfg.routed_scaling_factor)
    n = gate_up.shape[-1] // 2
    h = jnp.einsum("th,ehn->etn", x, gate_up)
    hh = jax.nn.silu(h[..., :n]) * h[..., n:]
    out_all = jnp.einsum("etn,enh->eth", hh, down)
    one_hot = jax.nn.one_hot(routing.expert_ids, cfg.num_experts, dtype=x.dtype)
    w = (routing.weights.astype(x.dtype)[..., None] * one_hot).sum(1)
    return jnp.einsum("eth,te->th", out_all, w)


@pytest.mark.parametrize("ep", [4, 8])
def test_ep_matches_oracle(ep):
    if len(jax.devices()) < ep:
        pytest.skip(f"needs {ep} devices")
    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    lp = {k: v[0] for k, v in params["layers"].items()}

    t = 16 * ep
    x = jax.random.normal(jax.random.PRNGKey(1), (t, cfg.hidden_size), jnp.float32)

    mesh = Mesh(np.array(jax.devices()[:ep]), axis_names=("expert",))
    # generous capacity -> dropless
    fn = make_ep_moe_fn(cfg, mesh, EPConfig(capacity_factor=float(cfg.top_k * ep)))
    with mesh:
        got = jax.jit(fn)(x, lp["router"], lp["expert_gate_up"], lp["expert_down"])

    ref = _dense_routed_oracle(x, lp["router"], lp["expert_gate_up"],
                               lp["expert_down"], cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_ep_capacity_drop_degrades_gracefully():
    ep = 4
    if len(jax.devices()) < ep:
        pytest.skip("needs 4 devices")
    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = jax.random.normal(jax.random.PRNGKey(3), (32, cfg.hidden_size), jnp.float32)

    mesh = Mesh(np.array(jax.devices()[:ep]), axis_names=("expert",))
    fn = make_ep_moe_fn(cfg, mesh, EPConfig(capacity_factor=0.5))  # force drops
    with mesh:
        got = jax.jit(fn)(x, lp["router"], lp["expert_gate_up"], lp["expert_down"])
    assert bool(jnp.all(jnp.isfinite(got)))
    ref = _dense_routed_oracle(x, lp["router"], lp["expert_gate_up"],
                               lp["expert_down"], cfg)
    # dropped tokens -> smaller norm, but correlated with the oracle
    ref_n = np.asarray(ref).ravel()
    got_n = np.asarray(got).ravel()
    corr = np.corrcoef(ref_n, got_n)[0, 1]
    assert corr > 0.5


def test_quantized_ep_int8_dispatch_matches_oracle():
    """int8-over-ICI dispatch + quantized expert compute vs fake-quant
    oracle (single-device math with the same quantization points)."""
    ep = 4
    if len(jax.devices()) < ep:
        pytest.skip("needs 4 devices")
    from mxmoe.parallel.ep import make_ep_moe_quant_fn
    from mxmoe.quant.qparams import (
        quantize_expert_weights, quantize_act_per_token)
    from mxmoe.quant.schemes import QLinearConfig

    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    lp = {k: v[0] for k, v in params["layers"].items()}
    qc = QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True, a_bits=8)
    qg = quantize_expert_weights(lp["expert_gate_up"], qc)
    qd = quantize_expert_weights(lp["expert_down"], qc)

    t = 16 * ep
    x = jax.random.normal(jax.random.PRNGKey(5), (t, cfg.hidden_size), jnp.float32)

    mesh = Mesh(np.array(jax.devices()[:ep]), axis_names=("expert",))
    fn = make_ep_moe_quant_fn(cfg, mesh, EPConfig(capacity_factor=float(cfg.top_k * ep)))
    with mesh:
        got = jax.jit(fn)(x, lp["router"], qg.q, qg.scale, qd.q, qd.scale)

    # oracle: same quant points, dense single-device math
    xq, xs = quantize_act_per_token(x, 8)
    x_fq = xq.astype(jnp.float32) * xs
    wg_fq = qg.q.astype(jnp.float32) * qg.scale
    wd_fq = qd.q.astype(jnp.float32) * qd.scale

    logits = x @ lp["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob)
    n = cfg.moe_intermediate_size
    h = jnp.einsum("th,ehn->etn", x_fq, wg_fq)
    hh = jax.nn.silu(h[..., :n]) * h[..., n:]
    # second quant point: per (expert, token) rows of hh
    e_tot = cfg.num_experts
    hq = []
    for e in range(e_tot):
        q, s = quantize_act_per_token(hh[e], 8)
        hq.append(q.astype(jnp.float32) * s)
    hh_fq = jnp.stack(hq)
    out_all = jnp.einsum("etn,enh->eth", hh_fq, wd_fq)
    one_hot = jax.nn.one_hot(routing.expert_ids, e_tot, dtype=x.dtype)
    w = (routing.weights.astype(x.dtype)[..., None] * one_hot).sum(1)
    ref = jnp.einsum("eth,te->th", out_all, w)

    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=5e-3, atol=5e-3)


def test_sharded_full_forward_matches_single_device():
    """Hybrid GSPMD + shard_map-EP full-model forward == plain forward."""
    ep = 4
    if len(jax.devices()) < ep:
        pytest.skip("needs 4 devices")
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mxmoe.parallel.sharded import make_sharded_forward, ep_param_shardings
    from mxmoe.parallel.ep import EPConfig
    from mxmoe.models.layers import MoEImpl

    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(10), dtype=jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(11), (ep, 16), 0, cfg.vocab_size)

    ref = model.forward_logits(params, toks, cfg, MoEImpl(kind="ragged"))

    mesh = Mesh(np.array(jax.devices()[:ep]), axis_names=("expert",))
    fwd = make_sharded_forward(
        cfg, mesh, quantized=False,
        ep_cfg=EPConfig(capacity_factor=float(cfg.top_k * ep)),
    )
    sharded_params = jax.device_put(params, ep_param_shardings(params, mesh))
    toks_sh = jax.device_put(toks, NamedSharding(mesh, P("expert", None)))
    with mesh:
        got = jax.jit(fwd)(sharded_params, toks_sh)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=5e-4, atol=5e-4)


def test_sharded_quantized_full_forward_runs():
    ep = 4
    if len(jax.devices()) < ep:
        pytest.skip("needs 4 devices")
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mxmoe.parallel.sharded import make_sharded_forward, ep_param_shardings
    from mxmoe.parallel.ep import EPConfig
    from mxmoe.quant.qparams import quantize_model_experts_uniform
    from mxmoe.quant.schemes import parse_scheme

    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(12), dtype=jnp.float32)
    qp = quantize_model_experts_uniform(params, parse_scheme("w8a8_g-1_sym"))
    toks = jax.random.randint(jax.random.PRNGKey(13), (ep, 8), 0, cfg.vocab_size)

    mesh = Mesh(np.array(jax.devices()[:ep]), axis_names=("expert",))
    fwd = make_sharded_forward(
        cfg, mesh, quantized=True,
        ep_cfg=EPConfig(capacity_factor=float(cfg.top_k * ep)),
    )
    sp = jax.device_put(qp, ep_param_shardings(qp, mesh))
    toks_sh = jax.device_put(toks, NamedSharding(mesh, P("expert", None)))
    with mesh:
        got = jax.jit(fwd)(sp, toks_sh)
    assert bool(jnp.all(jnp.isfinite(got)))

    # quantized sharded ~ quantized single-device (same quant points modulo
    # per-row act quant; both int8 weights) — loose agreement
    from mxmoe.models.layers import MoEImpl
    single = model.forward_logits(qp, toks, cfg, MoEImpl(
        kind="ragged", quant=parse_scheme("w8a8_g-1_sym"),
        interpret=jax.default_backend() == "cpu"))
    got_n = np.asarray(got).ravel()
    ref_n = np.asarray(single).ravel()
    assert np.corrcoef(got_n, ref_n)[0, 1] > 0.999


def test_ep_with_ds2_routing_semantics():
    """EP all-to-all under DeepSeek routing (scaling factor, no renorm)."""
    ep = 4
    if len(jax.devices()) < ep:
        pytest.skip("needs 4 devices")
    import dataclasses

    from mxmoe.models.configs import tiny_ds2

    cfg = dataclasses.replace(tiny_ds2(num_experts=8, num_layers=2),
                              routed_scaling_factor=2.0)
    params = model.init_params(cfg, jax.random.PRNGKey(30), dtype=jnp.float32)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = jax.random.normal(jax.random.PRNGKey(31), (32, cfg.hidden_size), jnp.float32)

    mesh = Mesh(np.array(jax.devices()[:ep]), axis_names=("expert",))
    fn = make_ep_moe_fn(cfg, mesh, EPConfig(capacity_factor=float(cfg.top_k * ep)))
    with mesh:
        got = jax.jit(fn)(x, lp["router"], lp["expert_gate_up"], lp["expert_down"])
    ref = _dense_routed_oracle(x, lp["router"], lp["expert_gate_up"],
                               lp["expert_down"], cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_ep_a4_packed_dispatch_matches_oracle():
    """4-bit nibble-packed all-to-all dispatch vs same-quant-point oracle."""
    ep = 4
    if len(jax.devices()) < ep:
        pytest.skip("needs 4 devices")
    from mxmoe.parallel.ep import make_ep_moe_quant_a4_fn
    from mxmoe.quant.qparams import (
        quantize_expert_weights, quantize_act_per_token)
    from mxmoe.quant.schemes import QLinearConfig

    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(40), dtype=jnp.float32)
    lp = {k: v[0] for k, v in params["layers"].items()}
    qc = QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True, a_bits=4)
    qg = quantize_expert_weights(lp["expert_gate_up"], qc)
    qd = quantize_expert_weights(lp["expert_down"], qc)

    t = 16 * ep
    x = jax.random.normal(jax.random.PRNGKey(41), (t, cfg.hidden_size), jnp.float32)

    mesh = Mesh(np.array(jax.devices()[:ep]), axis_names=("expert",))
    fn = make_ep_moe_quant_a4_fn(cfg, mesh, EPConfig(capacity_factor=float(cfg.top_k * ep)))
    with mesh:
        got = jax.jit(fn)(x, lp["router"], qg.q, qg.scale, qd.q, qd.scale)

    # oracle at the same quant points (a4 input, a8 mid, w8 weights)
    xq, xs = quantize_act_per_token(x, 4)
    x_fq = xq.astype(jnp.float32) * xs
    wg_fq = qg.q.astype(jnp.float32) * qg.scale
    wd_fq = qd.q.astype(jnp.float32) * qd.scale
    logits = x @ lp["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob)
    n = cfg.moe_intermediate_size
    hmat = jnp.einsum("th,ehn->etn", x_fq, wg_fq)
    hh = jax.nn.silu(hmat[..., :n]) * hmat[..., n:]
    hq = []
    for e in range(cfg.num_experts):
        q, s = quantize_act_per_token(hh[e], 8)
        hq.append(q.astype(jnp.float32) * s)
    out_all = jnp.einsum("etn,enh->eth", jnp.stack(hq), wd_fq)
    one_hot = jax.nn.one_hot(routing.expert_ids, cfg.num_experts, dtype=x.dtype)
    w = (routing.weights.astype(x.dtype)[..., None] * one_hot).sum(1)
    ref = jnp.einsum("eth,te->th", out_all, w)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=5e-3, atol=5e-3)


def test_ep_drop_stats_and_sentinel():
    """return_stats exposes per-shard drop counts; generous capacity is
    dropless and exact (sentinel padding must not perturb expert 0)."""
    ep = 4
    if len(jax.devices()) < ep:
        pytest.skip("needs 4 devices")
    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = jax.random.normal(jax.random.PRNGKey(6), (32, cfg.hidden_size), jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:ep]), axis_names=("expert",))

    fn = make_ep_moe_fn(cfg, mesh, EPConfig(
        capacity_factor=float(cfg.top_k * ep), return_stats=True))
    with mesh:
        got, drops = jax.jit(fn)(x, lp["router"], lp["expert_gate_up"],
                                 lp["expert_down"])
    assert drops.shape == (ep,)
    assert int(np.asarray(drops).sum()) == 0
    ref = _dense_routed_oracle(x, lp["router"], lp["expert_gate_up"],
                               lp["expert_down"], cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-4, atol=2e-4)

    tight = make_ep_moe_fn(cfg, mesh, EPConfig(capacity_factor=0.25,
                                               return_stats=True))
    with mesh:
        _, drops2 = jax.jit(tight)(x, lp["router"], lp["expert_gate_up"],
                                   lp["expert_down"])
    assert int(np.asarray(drops2).sum()) > 0


def test_capacity_factor_from_freq():
    from mxmoe.parallel.ep import capacity_factor_from_freq

    uniform = np.ones(8)
    cf = capacity_factor_from_freq(uniform, ep=4, margin=1.25)
    assert abs(cf - 1.25) < 1e-6
    skewed = np.array([8.0, 8, 1, 1, 1, 1, 1, 1])   # shard 0 holds 16/22
    cf2 = capacity_factor_from_freq(skewed, ep=4, margin=1.0)
    assert abs(cf2 - 4 * (16 / 22)) < 1e-6
    assert cf2 > 1.0


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs multi-device mesh")
def test_mixed_ep_matches_single_device():
    """MIXED per-expert schemes over the EP all-to-all == the single-device
    one-launch mixed forward (round-3: the ILP's output composed with
    expert parallelism — bitwidths as data across the wire: assignments
    quantize at the SOURCE to the destination expert's act bits)."""
    from mxmoe.models.layers import MoEImpl, moe_ffn_ragged_quant
    from mxmoe.parallel.ep import make_ep_moe_mixed_fn
    from mxmoe.quant import qparams
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    ep = 4
    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    schemes = ["w4a4_g-1_sym", "w8a8_g-1_sym"]
    qmodel = QModelConfig(layers={"0": QLayerConfig(experts={
        str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
        for e in range(8)
    })})
    qp = qparams.quantize_model_experts_mixed(params, cfg, qmodel)
    lp = {k: v[0] for k, v in qp["layers"].items()}

    t = 64
    x = jax.random.normal(jax.random.PRNGKey(6), (t, cfg.hidden_size),
                          jnp.float32)
    impl = MoEImpl(kind="ragged", quant="mixed", interpret=True)
    ref = moe_ffn_ragged_quant(x, lp, cfg, impl)

    mesh = Mesh(np.array(jax.devices()[:ep]), axis_names=("expert",))
    fn = make_ep_moe_mixed_fn(
        cfg, mesh, EPConfig(capacity_factor=float(cfg.top_k * ep)))
    with mesh:
        got = jax.jit(fn)(x, lp["router"],
                          lp["expert_gate_up_q"], lp["expert_gate_up_sc"],
                          lp["expert_down_q"], lp["expert_down_sc"],
                          lp["act_bits_gateup"], lp["act_bits_down"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs multi-device mesh")
def test_mixed_ep_packed_matches_int8_stored():
    """Per-shard PACKED ragged buffers over EP == the int8-stored mixed EP
    == single-device: the decode weight-traffic win composed with expert
    parallelism, bitwise on the kernel math (packing.shard_ragged_mixed
    re-slices the global buffer per shard with LOCAL block offsets)."""
    from mxmoe.models.layers import MoEImpl, moe_ffn_ragged_quant
    from mxmoe.parallel.ep import make_ep_moe_mixed_fn
    from mxmoe.quant import qparams
    from mxmoe.quant.packing import shard_ragged_mixed
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    ep = 4
    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    schemes = ["w4a4_g-1_sym", "w8a8_g-1_sym"]
    qmodel = QModelConfig(layers={"0": QLayerConfig(experts={
        str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
        for e in range(8)
    })})
    qpp = qparams.quantize_model_experts_mixed(params, cfg, qmodel,
                                               pack_w4=True)
    qp8 = qparams.quantize_model_experts_mixed(params, cfg, qmodel)
    lpp = {k: v[0] for k, v in qpp["layers"].items()}
    lp8 = {k: v[0] for k, v in qp8["layers"].items()}

    t = 64
    x = jax.random.normal(jax.random.PRNGKey(8), (t, cfg.hidden_size),
                          jnp.float32)
    impl = MoEImpl(kind="ragged", quant="mixed", interpret=True)
    ref = moe_ffn_ragged_quant(x, lp8, cfg, impl)

    mesh = Mesh(np.array(jax.devices()[:ep]), axis_names=("expert",))
    ep_cfg = EPConfig(capacity_factor=float(cfg.top_k * ep))
    fn = make_ep_moe_mixed_fn(cfg, mesh, ep_cfg, packed=True)

    args = [x, lpp["router"]]
    for prefix in ("expert_gate_up", "expert_down"):
        kdim = (cfg.hidden_size if prefix == "expert_gate_up"
                else cfg.moe_intermediate_size)
        cat_s, blk_l = shard_ragged_mixed(
            lpp[f"{prefix}_qcat"], np.asarray(lpp[f"{prefix}_blk"]),
            np.asarray(lpp[f"{prefix}_pf"]), kdim, ep)
        args += [cat_s, lpp[f"{prefix}_sc"],
                 jnp.asarray(blk_l, jnp.int32),
                 jnp.asarray(lpp[f"{prefix}_pf"], jnp.int32)]
    args += [lpp["act_bits_gateup"], lpp["act_bits_down"]]
    with mesh:
        got = jax.jit(fn)(*args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
