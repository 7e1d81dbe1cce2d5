"""Multi-host scaffolding: (host, expert) mesh EP — single-process 2x4
mesh path and a genuine 2-process jax.distributed CPU integration test
(SURVEY §2.3 / §7.9 net-new; round-1 verdict missing #2)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from mxmoe.models import configs, model
from mxmoe.parallel.multihost import (
    MultihostEPConfig, make_multihost_ep_fn, initialize,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _dense_oracle(x, lp, cfg):
    from mxmoe.ops.dispatch import route_topk

    logits = x @ lp["router"]
    routing = route_topk(logits, cfg.top_k, cfg.norm_topk_prob,
                         cfg.routed_scaling_factor)
    n = lp["expert_gate_up"].shape[-1] // 2
    h = jnp.einsum("th,ehn->etn", x, lp["expert_gate_up"])
    hh = jax.nn.silu(h[..., :n]) * h[..., n:]
    out_all = jnp.einsum("etn,enh->eth", hh, lp["expert_down"])
    one_hot = jax.nn.one_hot(routing.expert_ids, cfg.num_experts, dtype=x.dtype)
    w = (routing.weights.astype(x.dtype)[..., None] * one_hot).sum(1)
    return jnp.einsum("eth,te->th", out_all, w)


def test_host_expert_mesh_ep_matches_oracle():
    """Single-process (2, 4) mesh: the tuple-axis EP path (same code that
    runs across real hosts) matches the dense oracle."""
    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = jax.random.normal(jax.random.PRNGKey(1), (64, cfg.hidden_size),
                          jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("host", "expert"))
    fn = make_multihost_ep_fn(
        cfg, mesh, MultihostEPConfig(capacity_factor=float(cfg.top_k * 8)))
    with mesh:
        got = jax.jit(fn)(x, lp["router"], lp["expert_gate_up"],
                          lp["expert_down"])
    ref = _dense_oracle(x, lp, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_host_expert_mesh_ep_quantized_with_stats():
    from mxmoe.quant.qparams import quantize_expert_weights
    from mxmoe.quant.schemes import QLinearConfig

    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = jax.random.normal(jax.random.PRNGKey(3), (64, cfg.hidden_size),
                          jnp.float32)
    qc = QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True, a_bits=8)
    qg = quantize_expert_weights(lp["expert_gate_up"][None], qc)
    qd = quantize_expert_weights(lp["expert_down"][None], qc)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("host", "expert"))
    fn = make_multihost_ep_fn(cfg, mesh, MultihostEPConfig(
        capacity_factor=float(cfg.top_k * 8), quantized=True,
        return_stats=True))
    with mesh:
        got, drops = jax.jit(fn)(x, lp["router"], qg.q[0], qg.scale[0],
                                 qd.q[0], qd.scale[0])
    assert drops.shape == (8,)
    assert int(np.asarray(drops).sum()) == 0
    ref = _dense_oracle(x, lp, cfg)
    rel = float(jnp.abs(got - ref).mean() / (jnp.abs(ref).mean() + 1e-9))
    assert rel < 0.1, rel  # int8 quantization error only


def test_initialize_noop_single_process():
    initialize()  # no cluster args, single process: must be a no-op
    assert jax.process_count() == 1


def test_two_process_distributed_ep():
    """Spawn 2 real processes × 4 virtual CPU devices; jax.distributed
    coordination + cross-process collectives run the EP layer."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "_multihost_worker.py")
    port = "12391"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=root, text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert "MULTIHOST-OK" in out, out[-3000:]


def test_host_expert_mesh_ep_mixed_matches_single_device():
    """MIXED per-expert schemes over the 2-level (host, expert) mesh ==
    single-device one-launch mixed execution (the ILP's allocation served
    across DCN x ICI; axis-tuple all-to-all + flattened axis_index)."""
    import jax.numpy as jnp

    from mxmoe.models import configs, model
    from mxmoe.models.layers import MoEImpl, moe_ffn_ragged_quant
    from mxmoe.parallel.multihost import (MultihostEPConfig,
                                          make_multihost_ep_fn)
    from mxmoe.quant import qparams
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    schemes = ["w4a4_g-1_sym", "w8a8_g-1_sym"]
    qmodel = QModelConfig(layers={"0": QLayerConfig(experts={
        str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
        for e in range(8)})})
    qp = qparams.quantize_model_experts_mixed(params, cfg, qmodel)
    lp = {k: v[0] for k, v in qp["layers"].items()}
    x = jax.random.normal(jax.random.PRNGKey(6), (64, cfg.hidden_size),
                          jnp.float32)
    impl = MoEImpl(kind="ragged", quant="mixed", interpret=True)
    ref = moe_ffn_ragged_quant(x, lp, cfg, impl)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("host", "expert"))
    fn = make_multihost_ep_fn(cfg, mesh,
                              MultihostEPConfig(mixed=True,
                                                capacity_factor=32.0))
    with mesh:
        got = jax.jit(fn)(x, lp["router"],
                          lp["expert_gate_up_q"], lp["expert_gate_up_sc"],
                          lp["expert_down_q"], lp["expert_down_sc"],
                          lp["act_bits_gateup"], lp["act_bits_down"])
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_host_expert_mesh_ep_mixed_packed_matches_single_device():
    """PACKED mixed storage over the 2-level (host, expert) mesh: per-shard
    ragged buffers sharded over the flattened axis pair — halved w4 weight
    traffic on every shard of a DCN x ICI deployment."""
    import jax.numpy as jnp

    from mxmoe.models import configs, model
    from mxmoe.models.layers import MoEImpl, moe_ffn_ragged_quant
    from mxmoe.parallel.multihost import (MultihostEPConfig,
                                          make_multihost_ep_fn)
    from mxmoe.quant import qparams
    from mxmoe.quant.packing import shard_ragged_mixed
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(15), dtype=jnp.float32)
    schemes = ["w4a4_g-1_sym", "w8a8_g-1_sym"]
    qmodel = QModelConfig(layers={"0": QLayerConfig(experts={
        str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
        for e in range(8)})})
    qpp = qparams.quantize_model_experts_mixed(params, cfg, qmodel,
                                               pack_w4=True)
    qp8 = qparams.quantize_model_experts_mixed(params, cfg, qmodel)
    lpp = {k: v[0] for k, v in qpp["layers"].items()}
    lp8 = {k: v[0] for k, v in qp8["layers"].items()}
    x = jax.random.normal(jax.random.PRNGKey(16), (64, cfg.hidden_size),
                          jnp.float32)
    impl = MoEImpl(kind="ragged", quant="mixed", interpret=True)
    ref = moe_ffn_ragged_quant(x, lp8, cfg, impl)

    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("host", "expert"))
    fn = make_multihost_ep_fn(cfg, mesh, MultihostEPConfig(
        mixed=True, packed=True, capacity_factor=32.0))
    args = [x, lpp["router"]]
    for prefix, kdim in (("expert_gate_up", cfg.hidden_size),
                         ("expert_down", cfg.moe_intermediate_size)):
        cat_s, blk_l = shard_ragged_mixed(
            lpp[f"{prefix}_qcat"], np.asarray(lpp[f"{prefix}_blk"]),
            np.asarray(lpp[f"{prefix}_pf"]), kdim, 8)   # ep = H*D shards
        args += [cat_s, lpp[f"{prefix}_sc"],
                 jnp.asarray(blk_l, jnp.int32),
                 jnp.asarray(lpp[f"{prefix}_pf"], jnp.int32)]
    args += [lpp["act_bits_gateup"], lpp["act_bits_down"]]
    with mesh:
        got = jax.jit(fn)(*args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def test_two_process_distributed_engine_decode():
    """The ENGINE's prefill + decode loop under real 2-process
    jax.distributed (north-star "continuous batching across hosts"): the
    expert axis spans both processes, every cached step crosses the
    process boundary through the EP all-to-all, and both processes must
    emit the same greedy tokens as a process-local single-device Engine
    (per-host slot bookkeeping rides the host length mirror)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "_engine_multihost_worker.py")
    port = "12393"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=root, text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert "ENGINE-MULTIHOST-OK" in out, out[-3000:]
