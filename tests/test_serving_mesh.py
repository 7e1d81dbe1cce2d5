"""Multi-chip serving decode: Engine over a device mesh == single-device.

Round-2 verdict #6: the EP sharded forward and the KV-cache/decode stack
finally meet — cache sharded over slots, experts over the mesh axis, the
EP all-to-all running INSIDE every cached decode step
(parallel.ep.make_ep_moe_block via MoEImpl.ep_moe).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from mxmoe.models import configs, model
from mxmoe.models.layers import MoEImpl
from mxmoe.parallel.ep import EPConfig
from mxmoe.serving.engine import Engine, EngineConfig

INTERPRET = jax.default_backend() == "cpu"


def _setup(seed=0, quantized=False):
    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(seed),
                               dtype=jnp.float32)
    impl = MoEImpl(kind="ragged", interpret=INTERPRET)
    if quantized:
        from mxmoe.quant.qparams import quantize_model_experts_uniform
        from mxmoe.quant.schemes import QLinearConfig

        qcfg = QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True,
                             a_bits=8, a_sym=True)
        params = quantize_model_experts_uniform(params, qcfg)
        impl = MoEImpl(kind="ragged", quant=qcfg, interpret=INTERPRET)
    return cfg, params, impl


@pytest.mark.parametrize("quantized", [False, True])
def test_mesh_engine_decodes_like_single_device(quantized):
    if len(jax.devices()) < 4:
        pytest.skip("needs a multi-device mesh")
    cfg, params, impl = _setup(quantized=quantized)
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("expert",))
    # capacity high enough that the EP path provably drops nothing -> the
    # two engines must produce the SAME greedy tokens
    ep_cfg = EPConfig(axis="expert", capacity_factor=float(cfg.num_experts))
    ecfg = EngineConfig(batch_slots=4, max_len=64, temperature=0.0)

    prompts = [[3, 14, 15, 9, 2], [6, 5, 35, 8], [9, 7, 9], [31, 4, 1, 5, 9]]

    def run(mesh_arg):
        eng = Engine(params, cfg, ecfg, impl, mesh=mesh_arg,
                     ep_cfg=ep_cfg if mesh_arg is not None else None)
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_to_completion()
        return [eng.result(r) for r in rids]

    ref = run(None)
    got = run(mesh)
    assert got == ref, (got, ref)


def test_mesh_engine_shards_cache_and_experts():
    if len(jax.devices()) < 4:
        pytest.skip("needs a multi-device mesh")
    cfg, params, impl = _setup(quantized=True)
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("expert",))
    eng = Engine(params, cfg, EngineConfig(batch_slots=4, max_len=32),
                 impl, mesh=mesh)
    # expert weights sharded over the mesh axis, cache over slots
    gq = eng.params["layers"]["expert_gate_up_q"]
    assert "expert" in str(gq.sharding.spec), gq.sharding
    assert gq.sharding.spec[1] == "expert"
    k = list(eng.cache)[0]
    assert k.sharding.spec[1] == "expert", k.sharding
    lengths = list(eng.cache)[-1]
    assert lengths.sharding.spec[0] == "expert", lengths.sharding


def test_mesh_engine_mixed_model_decodes_like_single_device():
    """Mesh Engine with a MIXED-scheme quantized model (per-expert w4/w8,
    real int8 codes) greedy-decodes the same tokens as single-device."""
    if len(jax.devices()) < 4:
        pytest.skip("needs a multi-device mesh")
    from mxmoe.quant import qparams
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(9), dtype=jnp.float32)
    schemes = ["w4a4_g-1_sym", "w8a8_g-1_sym"]
    qmodel = QModelConfig(layers={str(l): QLayerConfig(experts={
        str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
        for e in range(8)
    }) for l in range(2)})
    qp = qparams.quantize_model_experts_mixed(params, cfg, qmodel)
    impl = MoEImpl(kind="ragged", quant="mixed", interpret=INTERPRET)
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("expert",))
    ep_cfg = EPConfig(axis="expert", capacity_factor=float(cfg.num_experts))
    ecfg = EngineConfig(batch_slots=4, max_len=48, temperature=0.0)
    prompts = [[3, 14, 15], [6, 5, 35, 8], [9, 7], [31, 4, 1, 5]]

    def run(mesh_arg):
        eng = Engine(qp, cfg, ecfg, impl, mesh=mesh_arg,
                     ep_cfg=ep_cfg if mesh_arg is not None else None)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_to_completion()
        return [eng.result(r) for r in rids]

    ref = run(None)
    got = run(mesh)
    assert got == ref, (got, ref)


def test_mesh_engine_a16_mixed_decodes_like_single_device():
    """a16-containing mixes over the mesh (round-4 missing #5, mesh half):
    bf16 rows ride the A2A and each shard runs the fused wo+w×a launch
    (parallel.ep.moe_ffn_ep_wo) — greedy decode must match the
    single-chip mixed_weight_only path exactly. PACKED a16 artifacts
    still fail loudly (no packed weight-only kernel)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs a multi-device mesh")
    from mxmoe.quant import qparams
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("expert",))
    ecfg = EngineConfig(batch_slots=4, max_len=32, temperature=0.0)
    impl = MoEImpl(kind="ragged", quant="mixed", mixed_weight_only=True,
                   interpret=INTERPRET)

    def qm(schemes):
        return QModelConfig(layers={str(l): QLayerConfig(experts={
            str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
            for e in range(8)}) for l in range(2)})

    wo = qparams.quantize_model_experts_mixed(
        params, cfg, qm(["w4a16_g-1_sym", "w8a8_g-1_sym"]))
    ep_cfg = EPConfig(axis="expert", capacity_factor=float(cfg.num_experts))
    prompts = [[3, 14, 15], [6, 5, 35, 8], [9, 7], [31, 4, 1, 5]]

    def run(mesh_arg):
        eng = Engine(wo, cfg, ecfg, impl, mesh=mesh_arg,
                     ep_cfg=ep_cfg if mesh_arg is not None else None)
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run_to_completion()
        return [eng.result(r) for r in rids]

    ref = run(None)
    got = run(mesh)
    assert got == ref, (got, ref)

    # packed a16 artifacts cannot even be built (quantizer refuses), and
    # the Engine carries a second loud guard should one ever appear
    with pytest.raises(AssertionError, match="pack_w4 requires"):
        qparams.quantize_model_experts_mixed(
            params, cfg, qm(["w4a16_g-1_sym", "w8a8_g-1_sym"]), pack_w4=True)


def test_mesh_engine_packed_mixed_decodes_like_single_device():
    """A PACKED mixed artifact (convert --qconfig default) served over the
    mesh: the Engine reshards the global ragged buffers per shard
    (packing.shard_ragged_mixed) and greedy-decodes the same tokens as
    single-device — the ILP's bit budget stays real HBM bytes at every
    scale."""
    if len(jax.devices()) < 4:
        pytest.skip("needs a multi-device mesh")
    from mxmoe.quant import qparams
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(12),
                               dtype=jnp.float32)
    schemes = ["w4a4_g-1_sym", "w8a8_g-1_sym"]
    qmodel = QModelConfig(layers={str(l): QLayerConfig(experts={
        str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
        for e in range(8)
    }) for l in range(2)})
    qpp = qparams.quantize_model_experts_mixed(params, cfg, qmodel,
                                               pack_w4=True)
    impl = MoEImpl(kind="ragged", quant="mixed", interpret=INTERPRET)
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("expert",))
    ep_cfg = EPConfig(axis="expert", capacity_factor=float(cfg.num_experts))
    ecfg = EngineConfig(batch_slots=4, max_len=48, temperature=0.0)
    prompts = [[3, 14, 15], [6, 5, 35, 8], [9, 7], [31, 4, 1, 5]]

    def run(mesh_arg):
        eng = Engine(qpp, cfg, ecfg, impl, mesh=mesh_arg,
                     ep_cfg=ep_cfg if mesh_arg is not None else None)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_to_completion()
        return [eng.result(r) for r in rids]

    ref = run(None)
    got = run(mesh)
    assert got == ref, (got, ref)


@pytest.mark.parametrize("num_experts,pack", [(60, True), (6, False)])
def test_mesh_engine_nondivisible_experts_decode_parity(num_experts, pack):
    """The flagship topology: E that does NOT divide the mesh (60 routed
    experts on an 8-device mesh — the at-scale runbook's serve failure,
    round-4 verdict missing #1). The Engine grows never-routed phantom
    experts (parallel.ep.pad_expert_arrays / packing.shard_ragged_mixed)
    and greedy decode must match single-device exactly."""
    n_dev = 8 if num_experts == 60 else 4
    if len(jax.devices()) < n_dev:
        pytest.skip("needs a multi-device mesh")
    from mxmoe.quant import qparams
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    assert num_experts % n_dev != 0   # the point of the test
    cfg = configs.tiny_qwen2_moe(num_experts=num_experts, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    schemes = ["w4a4_g-1_sym", "w8a8_g-1_sym"]
    qmodel = QModelConfig(layers={"0": QLayerConfig(experts={
        str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
        for e in range(num_experts)
    })})
    qp = qparams.quantize_model_experts_mixed(params, cfg, qmodel,
                                              pack_w4=pack)
    impl = MoEImpl(kind="ragged", quant="mixed", interpret=INTERPRET)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), axis_names=("expert",))
    ep_cfg = EPConfig(axis="expert", capacity_factor=float(num_experts))
    ecfg = EngineConfig(batch_slots=n_dev, max_len=32, temperature=0.0)
    prompts = [[3, 14, 15], [6, 5, 35, 8], [9, 7], [31, 4, 1, 5]][:n_dev]
    prompts = prompts * (n_dev // len(prompts)) if n_dev > len(prompts) else prompts

    def run(mesh_arg):
        eng = Engine(qp, cfg, ecfg, impl, mesh=mesh_arg,
                     ep_cfg=ep_cfg if mesh_arg is not None else None)
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run_to_completion()
        return [eng.result(r) for r in rids]

    ref = run(None)
    got = run(mesh)
    assert got == ref, (got, ref)
    if pack:
        # padded layout really sharded: E_pad = 64 on 8 devices
        from mxmoe.parallel.ep import padded_num_experts
        assert padded_num_experts(num_experts, n_dev) == 64


def test_mesh_engine_derives_capacity_from_gate_trace():
    """Task: EP capacity from the trace, not a constant (round-3 next #8 +
    advisor medium). On a skew-routed model the old 2.0 constant DROPS
    assignments (mesh decode diverges from single-chip); the factor
    derived from a gate trace via Engine(gate_freq=...) serves with zero
    drops (mesh decode identical)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs a multi-device mesh")
    from mxmoe.trace.gate import trace_gate_stats

    cfg, params, impl = _setup(seed=3)
    # skew the routing toward shard 0's experts (E=8 over 4 shards ->
    # experts 0-1): magnified router columns dominate top-k most steps
    router = np.array(params["layers"]["router"], np.float32)  # [L, H, E]
    router[:, :, 0] *= 8.0
    router[:, :, 1] = router[:, :, 0] * 0.99   # near-tied pair: top-2 picks
    # both shard-0 experts together whenever expert 0 wins -> with the
    # 2.0 constant (cap = 1/shard at decode) one of the two drops
    layers = dict(params["layers"])
    layers["router"] = jnp.asarray(router)
    params = {**params, "layers": layers}

    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("expert",))
    ecfg = EngineConfig(batch_slots=4, max_len=64, temperature=0.0)
    prompts = [[3, 14, 15, 9, 2], [6, 5, 35, 8], [9, 7, 9], [31, 4, 1, 5, 9]]

    # production flow: trace the gate on calibration tokens, derive cap
    toks = jnp.asarray(np.array([p + [0] * (8 - len(p)) for p in prompts]))
    trace = trace_gate_stats(params, toks, cfg)
    freq = trace.access_freq.sum(axis=0)           # [E] aggregated

    def run(mesh_arg, ep_cfg=None, gate_freq=None):
        eng = Engine(params, cfg, ecfg, impl, mesh=mesh_arg,
                     ep_cfg=ep_cfg, gate_freq=gate_freq)
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_to_completion()
        return eng, [eng.result(r) for r in rids]

    _, ref = run(None)
    eng_d, derived = run(mesh, gate_freq=freq)
    assert eng_d.ep_cfg.capacity_factor > 2.0, eng_d.ep_cfg
    assert derived == ref, (derived, ref)

    _, const = run(mesh, ep_cfg=EPConfig(axis="expert", capacity_factor=2.0))
    assert const != ref, "2.0 constant did not drop: skew fixture too weak"


@pytest.mark.parametrize("packed", [False, True])
def test_mesh_engine_flex_mixed_decodes_like_single_device(packed):
    """FLEX mixes (grouped + asym schemes) over the mesh: the layout-
    driven EP wrapper ships [*, G] act scales over the all-to-all and
    runs the grouped/flex launches per shard — greedy decode identical
    to single-chip (round-3 missing #1, the serving loop closed)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs a multi-device mesh")
    from mxmoe.quant import qparams
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(21), dtype=jnp.float32)
    schemes = ["w4a4_g16_asym", "w8a8_g-1_sym"]
    # index 8 = SHARED expert with a grouped asym scheme: real grouped
    # shared storage (round-4 missing #5) must also serve over the mesh
    qmodel = QModelConfig(layers={str(l): QLayerConfig(experts={
        str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
        for e in range(9)
    }) for l in range(2)})
    qp = qparams.quantize_model_experts_mixed(params, cfg, qmodel,
                                              pack_w4=packed)
    impl = MoEImpl(kind="ragged", quant="mixed", interpret=INTERPRET)
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("expert",))
    ep_cfg = EPConfig(axis="expert", capacity_factor=float(cfg.num_experts))
    ecfg = EngineConfig(batch_slots=4, max_len=48, temperature=0.0)
    prompts = [[3, 14, 15], [6, 5, 35, 8], [9, 7], [31, 4, 1, 5]]

    def run(mesh_arg):
        eng = Engine(qp, cfg, ecfg, impl, mesh=mesh_arg,
                     ep_cfg=ep_cfg if mesh_arg is not None else None)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_to_completion()
        return [eng.result(r) for r in rids]

    ref = run(None)
    got = run(mesh)
    assert got == ref, (got, ref)


def test_ep_decode_stack_no_per_step_weight_copy():
    """Round-4 weak #5 closure: the mesh decode scan must consume expert
    weights as a LOOP CONSTANT (stacked [L, E, ...] arrays, shards
    flattened inside the shard_map), not as scan-xs — the xs layout makes
    XLA dynamic-slice a full per-layer weight copy out of the stack every
    decode step. Asserted structurally on the optimized HLO: no
    dynamic-slice producing a per-layer [1, ep, R, N] qcat slice may
    remain; the monkeypatched old layout must show at least one (guarding
    the assertion against HLO-shape drift)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs a multi-device mesh")
    import re

    from mxmoe.quant import qparams
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)
    from mxmoe.serving import decode as sdecode

    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    schemes = ["w4a4_g-1_sym", "w8a8_g-1_sym"]
    qmodel = QModelConfig(layers={str(l): QLayerConfig(experts={
        str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
        for e in range(8)
    }) for l in range(2)})
    qp = qparams.quantize_model_experts_mixed(params, cfg, qmodel,
                                              pack_w4=True)
    # stack_weights forced on: the auto default skips stacking in
    # interpret mode (the Pallas interpreter pays O(operand) per call)
    impl = MoEImpl(kind="ragged", quant="mixed", interpret=INTERPRET,
                   stack_weights=True)
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("expert",))
    eng = Engine(qp, cfg, EngineConfig(batch_slots=4, max_len=32), impl,
                 mesh=mesh, ep_cfg=EPConfig(axis="expert",
                                            capacity_factor=8.0))

    qcat = eng.params["layers"]["expert_gate_up_qcat"]  # [L, ep, R, N]
    _, ep, r, n = qcat.shape
    # after SPMD partitioning the local ep dim is 1: the per-layer weight
    # slice in the while body reads s8[1,1,R,N] out of the [L,1,R,N] xs
    slice_pat = re.compile(
        rf"s8\[1,(?:1|{ep}),{r},{n}\][^\n]*dynamic-slice|"
        rf"dynamic-slice[^\n]*s8\[1,(?:1|{ep}),{r},{n}\]")

    def compiled_hlo():
        toks = jnp.zeros((4, 1), jnp.int32)
        valid = jnp.ones((4,), jnp.int32)
        fn = jax.jit(lambda p, t, c: sdecode.forward_cached(
            p, t, c, cfg=cfg, impl=eng.impl, valid_lengths=valid))
        return fn.lower(eng.params, toks, eng.cache).compile().as_text()

    hlo_stacked = compiled_hlo()
    assert not slice_pat.search(hlo_stacked), "per-step weight slice found"

    # guard: the OLD scan-xs layout must trip the same detector
    orig = sdecode._layer_xs_and_stack
    try:
        sdecode._layer_xs_and_stack = lambda params, impl: (params["layers"], {})
        hlo_xs = compiled_hlo()
    finally:
        sdecode._layer_xs_and_stack = orig
    assert slice_pat.search(hlo_xs), (
        "detector found nothing in the xs layout - pattern drifted")
